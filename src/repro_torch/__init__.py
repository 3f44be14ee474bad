"""PyTorch/CUDA port of the nested-partition DG system.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``dg/``, ``kernels/``, ``runtime/``, ``configs/``) and is held
against it by the ``tests/test_torch_*.py`` differential tests.  It imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points run on the card: ``device=None`` means ``cuda`` and raises
without one; pass ``device="cpu"`` to run on the CPU.  The kernel switch
``kernel_impl`` is ``"auto"`` (the hand-written CUDA kernels for CUDA
tensors, the plain PyTorch versions for CPU tensors), ``"torch"`` (the plain
versions) or ``"cuda"`` (the kernels; raises on a CPU tensor).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
