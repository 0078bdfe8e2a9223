"""PyTorch/CUDA port of :mod:`repro` for one NVIDIA H100 (sm_90a).

The layout mirrors ``repro``: ``core/`` (the Festivus storage stack),
``configs/``, ``launch/`` (the cluster engine), ``data/``, ``kernels/``
(hand-written CUDA kernels, each with a plain PyTorch version beside it)
and ``apps/``.  The package imports torch, numpy and the standard library
only; it never imports jax or any module of ``repro``.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
