"""SwiGLU feed-forward."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from reference.model import Spec


def layout(spec: Spec):
    d, f = spec.d_model, spec.d_ff
    return [("w_gate", (d, f), f"normal:{d}"), ("w_up", (d, f), f"normal:{d}"),
            ("w_down", (f, d), f"normal:{f}")]


def swiglu(p, h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]


def forward(p, spec: Spec, h: torch.Tensor,
            margins: Optional[list] = None) -> torch.Tensor:
    return swiglu(p, h)
