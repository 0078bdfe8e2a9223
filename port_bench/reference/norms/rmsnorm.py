"""RMSNorm with a scale."""

from __future__ import annotations

import torch


def layout(d: int):
    return [("scale", (d,), "scale")]


def apply(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) \
        * p["scale"]
