"""Public entry points for the kernels.

``impl="auto"`` launches the hand-written kernel for CUDA tensors and runs
the plain PyTorch version for CPU tensors; ``"ref"`` always runs the plain
version; ``"kernel"`` always launches the kernel and raises on CPU tensors.
A CUDA tensor never falls back to the plain version.

:func:`flash_attention` takes the JAX package's four ``impl`` strings
(``ModelConfig.attention_impl``): ``"pallas"`` is the hand-written kernel,
``"ref"`` and ``"chunked"`` are its plain versions, and ``"auto"`` launches
the kernel for CUDA tensors and, for CPU tensors, takes ``"chunked"`` from
Sq >= 1024 on and ``"ref"`` below, as ``repro/kernels/ops.py`` does off the
TPU.

:func:`ssd` takes the same four strings: ``"pallas"`` is the hand-written
SSD kernel, ``"chunked"`` and ``"ref"`` its plain versions, and ``"auto"``
launches the kernel for CUDA tensors and, for CPU tensors, takes
``"chunked"`` where ``chunk`` divides L and ``"ref"`` otherwise, as
``repro/kernels/ops.py`` does off the TPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import composite as composite_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import grad_mag as grad_mag_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_kernel

IMPLS = ("auto", "ref", "kernel")
#: the JAX package's impl strings for attention and the SSD
JAX_IMPLS = ("auto", "ref", "chunked", "pallas")
#: from this query length on, "auto" on CPU tensors takes the chunked path
CHUNKED_FROM = 1024


def _plain(impl: str, images: torch.Tensor) -> bool:
    """True where ``impl`` sends these images to the plain version."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    return impl == "ref" or (impl == "auto" and not images.is_cuda)


def composite(images: torch.Tensor, weights: torch.Tensor,
              impl: str = "auto") -> torch.Tensor:
    """Weighted temporal composite: [T,H,W,C] x [T,H,W] -> [H,W,C]."""
    if _plain(impl, images):
        return ref.composite(images, weights)
    return composite_kernel.composite(images, weights)


def grad_mag(images: torch.Tensor, valid: torch.Tensor, impl: str = "auto"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked temporal gradient accumulation: [T,H,W,C] x [T,H,W] bool ->
    (grad_sum, count), both [H,W] f32."""
    if _plain(impl, images):
        return ref.grad_mag(images, valid)
    return grad_mag_kernel.grad_mag(images, valid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """GQA attention: q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] -> [B,Hq,Sq,D].
    Causal with Sq > Sk raises ``ValueError`` on every path."""
    if impl not in JAX_IMPLS:
        raise ValueError(f"impl={impl!r} not in {JAX_IMPLS}")
    if impl == "auto":
        impl = "pallas" if q.is_cuda else (
            "chunked" if q.shape[2] >= CHUNKED_FROM else "ref")
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal)
    if impl == "chunked":
        return ref.attention_chunked(q, k, v, causal=causal)
    return flash_kernel.flash_attention(q, k, v, causal=causal)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, d_skip: torch.Tensor | None = None,
        impl: str = "auto", chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD scan: x [B,L,H,P], dt [B,L,H], a [H], b/c [B,L,H,N] ->
    [B,L,H,P] (see ``ref.ssd_scan``).  ``chunk`` is the plain chunked
    version's; the kernel takes any L."""
    if impl not in JAX_IMPLS:
        raise ValueError(f"impl={impl!r} not in {JAX_IMPLS}")
    if impl == "auto":
        impl = "pallas" if x.is_cuda else (
            "chunked" if x.shape[1] % chunk == 0 else "ref")
    if impl == "chunked":
        return ref.ssd_scan_chunked(x, dt, a, b, c, chunk=chunk,
                                    d_skip=d_skip)
    if impl == "ref":
        return ref.ssd_scan(x, dt, a, b, c, d_skip=d_skip)
    return ssd_kernel.ssd_scan(x, dt, a, b, c, d_skip=d_skip)
