"""Hand-written Hopper kernels for the port's hot spots.

Each kernel has a CUDA source under ``csrc/``, a ctypes wrapper module
(``composite.py``, ``grad_mag.py``) that checks its inputs, launches on the current stream
and counts its launches, and a plain PyTorch version in ``ref.py``.
``ops.py`` is the dispatch the applications call: CUDA tensors launch the
kernel, CPU tensors run the plain version.  ``build.py`` compiles the
sources with ``nvcc`` for ``sm_90a`` at first use.
"""

from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
