"""Public entry points for the kernels.

``impl="auto"`` launches the hand-written kernel for CUDA tensors and runs
the plain PyTorch version for CPU tensors; ``"ref"`` always runs the plain
version; ``"kernel"`` always launches the kernel and raises on CPU tensors.
A CUDA tensor never falls back to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import composite as composite_kernel
from repro_torch.kernels import grad_mag as grad_mag_kernel
from repro_torch.kernels import ref

IMPLS = ("auto", "ref", "kernel")


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
