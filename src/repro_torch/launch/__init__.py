"""Command-line drivers of the port (``profile_dg``)."""
