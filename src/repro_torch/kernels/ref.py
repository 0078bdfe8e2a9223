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
