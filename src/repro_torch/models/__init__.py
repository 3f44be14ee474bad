"""The LM stack (dense decoders) in PyTorch: configuration and building
blocks (``common``), attention (``attention``), blocks (``transformer``) and
the model with its arch registry (``zoo``)."""
