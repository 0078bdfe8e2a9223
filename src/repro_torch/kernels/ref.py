"""Plain PyTorch versions of the kernels (the port's oracles).

Each function computes what its kernel computes, in the same order of
operations as the JAX package's oracle in ``repro/kernels/ref.py``.  They
run on CPU tensors in the tests and on the card in ``chip_smoke.py``, where
each kernel is held against them; on the main path a CUDA tensor always
goes to the kernel instead.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Weighted temporal composite (paper §V.C: cloud-free global base layer)
# ---------------------------------------------------------------------------
def composite(images: torch.Tensor, weights: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """images [T, H, W, C], weights [T, H, W] (>= 0) -> [H, W, C] =
    sum_t w[t]*x[t] / (sum_t w[t] + eps), all sums in f32, output in the
    images' dtype.  Materialises a [T, H, W, C] f32 product."""
    imf = images.float()
    wf = weights.float()[..., None]
    num = (imf * wf).sum(dim=0)
    den = wf.sum(dim=0)
    return (num / (den + eps)).to(images.dtype)


def composite_weights(cloud_score: torch.Tensor, nir: torch.Tensor,
                      red: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The paper's weighting: favour cloud-free, verdant pixels.

    cloud_score [T, H, W] in [0, 1] (1 = certainly cloud); nir/red
    [T, H, W] reflectances give the NDVI verdancy term.
    """
    ndvi = (nir - red) / (nir + red + eps)
    verdancy = ndvi.clamp(0.0, 1.0)
    return (1.0 - cloud_score) * (0.25 + 0.75 * verdancy)


# ---------------------------------------------------------------------------
# Temporal-mean gradient magnitude (paper §V.B: field segmentation edges)
# ---------------------------------------------------------------------------
def grad_mag(images: torch.Tensor, valid: torch.Tensor,
             eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulated cloud-masked spatial gradient magnitude.

    images [T, H, W, C], valid [T, H, W] bool (False = cloud/missing) ->
    (grad_sum [H, W], count [H, W]), both f32.  East and south forward
    differences; a difference counts only where both pixels are valid, and a
    neighbour outside the frame is invalid.  mag = sqrt(sum_c dx^2 +
    sum_c dy^2 + eps), grad_sum = sum_t mag * v, count = sum_t v.

    The JAX oracle's operations, one timestep at a time with the sums in
    f32, so no [T, H, W, C] temporary is made (at [16, 6144, 6144, 4] each
    one is 9.7 GB)."""
    T, H, W, _ = images.shape
    grad_sum = torch.zeros((H, W), dtype=torch.float32, device=images.device)
    count = torch.zeros_like(grad_sum)
    for t in range(T):
        x = images[t].float()
        v = valid[t].float()
        dx = torch.zeros_like(x)
        dy = torch.zeros_like(x)
        dx[:, :-1] = (x[:, 1:] - x[:, :-1]) * (v[:, 1:] * v[:, :-1])[..., None]
        dy[:-1] = (x[1:] - x[:-1]) * (v[1:] * v[:-1])[..., None]
        mag = torch.sqrt((dx * dx).sum(dim=-1) + (dy * dy).sum(dim=-1) + eps)
        grad_sum += mag * v
        count += v
    return grad_sum, count


def temporal_mean_gradient(images: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    g, c = grad_mag(images, valid)
    return g / c.clamp_min(1.0)
