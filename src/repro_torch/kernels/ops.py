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

Where autograd records (grad mode on and an input requires grad), the
kernels run through their ``autograd.Function``: ``FlashAttentionFn`` and
``SsdScanFn``, whose backwards are the hand-written backward kernels.

A ``FakeTensor`` (shapes and strides, no memory: ``launch/dryrun.py``)
takes the card's route under ``"auto"`` whatever its device: the kernels'
ops give its outputs' shapes and launch nothing, where a plain version
would run its intermediate tensors.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import composite as composite_kernel
from repro_torch.kernels import flash_attention as flash_kernel
from repro_torch.kernels import grad_mag as grad_mag_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.kernels.backend import is_fake

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


def _on_card(t: torch.Tensor) -> bool:
    """Where ``"auto"`` takes the hand-written kernel: a CUDA tensor, or a
    fake one."""
    return t.is_cuda or is_fake(t)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, impl: str = "auto") -> torch.Tensor:
    """GQA attention: q [B,Hq,Sq,D], k/v [B,Hkv,Sk,D] -> [B,Hq,Sq,D].
    Causal with Sq > Sk raises ``ValueError`` on every path."""
    if impl not in JAX_IMPLS:
        raise ValueError(f"impl={impl!r} not in {JAX_IMPLS}")
    if impl == "auto":
        impl = "pallas" if _on_card(q) else (
            "chunked" if q.shape[2] >= CHUNKED_FROM else "ref")
    if impl == "ref":
        return ref.attention(q, k, v, causal=causal)
    if impl == "chunked":
        return ref.attention_chunked(q, k, v, causal=causal)
    return flash_kernel.flash_attention(q, k, v, causal=causal)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, impl: str = "auto"):
    """GQA attention and each query row's log-sum-exp of its scaled scores:
    -> (out [B,Hq,Sq,D] in q's dtype, lse [B,Hq,Sq] f32, natural log), what
    :func:`combine_lse` merges over shards of the keys.  ``"pallas"`` (and
    ``"auto"`` on a CUDA or fake tensor) is the forward kernel writing its
    log-sum-exp (``flash_attention.flash_attention_with_lse``); ``"ref"``
    and ``"chunked"`` (and ``"auto"`` on a CPU tensor) the plain
    ``ref.attention`` and ``ref.attention_lse``.  No autograd: the kernel
    raises where it records."""
    if impl not in JAX_IMPLS:
        raise ValueError(f"impl={impl!r} not in {JAX_IMPLS}")
    if impl == "pallas" or (impl == "auto" and _on_card(q)):
        return flash_kernel.flash_attention_with_lse(q, k, v, causal=causal)
    return (ref.attention(q, k, v, causal=causal),
            ref.attention_lse(q, k, causal=causal))


def combine_lse(outs: torch.Tensor, lses: torch.Tensor,
                max_over=None, sum_over=None) -> torch.Tensor:
    """Attention over the union of shards of the keys from each shard's
    output [.., D] and log-sum-exp [..] (f32) -> [.., D] in the outputs'
    dtype: each output weighted by exp(its lse - the total's), summed in
    f32.  ``max_over`` and ``sum_over`` reduce over the shards: by default
    the shards are stacked along the first dimension; on a mesh they are
    the reductions over the ranks that hold them (``common.seq_max``,
    ``common.seq_sum``)."""
    max_over = max_over or (lambda t: t.amax(dim=0))
    sum_over = sum_over or (lambda t: t.sum(dim=0))
    m = max_over(lses)
    total = m + torch.log(sum_over(torch.exp(lses - m)))
    w = torch.exp(lses - total)
    return sum_over(outs.float() * w[..., None]).to(outs.dtype)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, *, d_skip: torch.Tensor | None = None,
        impl: str = "auto", chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD scan: x [B,L,H,P], dt [B,L,H], a [H], b/c [B,L,H,N] ->
    [B,L,H,P] (see ``ref.ssd_scan``).  b and c may also be [B,L,1,N], one
    group shared by every head: the plain versions take it expanded (stride
    0), and under autograd the kernel's backward sums its gradient over the
    heads.  ``chunk`` is the plain chunked version's; the kernel takes any
    L."""
    if impl not in JAX_IMPLS:
        raise ValueError(f"impl={impl!r} not in {JAX_IMPLS}")
    H = x.shape[2]
    if b.dim() != 4 or b.shape[2] not in (1, H) or c.shape != b.shape:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"be [B, L, H={H} or 1, N]")
    if impl == "auto":
        impl = "pallas" if _on_card(x) else (
            "chunked" if x.shape[1] % chunk == 0 else "ref")
    bh, ch = ssd_kernel.expand_heads(b, H), ssd_kernel.expand_heads(c, H)
    if impl == "chunked":
        return ref.ssd_scan_chunked(x, dt, a, bh, ch, chunk=chunk,
                                    d_skip=d_skip)
    if impl == "ref":
        return ref.ssd_scan(x, dt, a, bh, ch, d_skip=d_skip)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, a, b, c, d_skip)):
        return ssd_kernel.SsdScanFn.apply(x, dt, a, b, c, d_skip)
    return ssd_kernel.ssd_scan(x, dt, a, bh, ch, d_skip=d_skip)
