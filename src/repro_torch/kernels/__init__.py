"""Hand-written CUDA kernels (``csrc/``) behind the ``kernel_impl`` switch
(``ops``), with their plain PyTorch versions (``ref``)."""
