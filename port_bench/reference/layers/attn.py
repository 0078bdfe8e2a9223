"""Causal grouped-query attention with RoPE on the two halves of each
head."""

from __future__ import annotations

from typing import Optional

import torch

from reference.model import Spec


def layout(spec: Spec):
    d, q, kv = (spec.d_model, spec.num_heads * spec.head_dim,
                spec.num_kv_heads * spec.head_dim)
    return [("wq", (d, q), f"normal:{d}"), ("wk", (d, kv), f"normal:{d}"),
            ("wv", (d, kv), f"normal:{d}"), ("wo", (q, d), f"normal:{q}")]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [B, H, S, D]: position s rotates the pair (x_i, x_{i + D/2}) by s
    theta^(-2i/D)."""
    S, D = x.shape[2], x.shape[3]
    freqs = theta ** -(torch.arange(0, D, 2, dtype=torch.float32,
                                    device=x.device) / D)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(p, spec: Spec, h: torch.Tensor,
            margins: Optional[list] = None) -> torch.Tensor:
    """One row at a time, so that a row's [H, S, S] scores are the
    largest temporary."""
    Bsz, S, _ = h.shape
    Hq, Hkv, D = spec.num_heads, spec.num_kv_heads, spec.head_dim
    mask = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    rows = []
    for r in range(Bsz):
        x = h[r:r + 1]
        q = (x @ p["wq"]).view(1, S, Hq, D).transpose(1, 2)
        k = (x @ p["wk"]).view(1, S, Hkv, D).transpose(1, 2)
        v = (x @ p["wv"]).view(1, S, Hkv, D).transpose(1, 2)
        q, k = rope(q, spec.rope_theta), rope(k, spec.rope_theta)
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
        s = (q @ k.transpose(-1, -2)) * D ** -0.5
        o = torch.softmax(s.masked_fill(mask, float("-inf")), dim=-1) @ v
        rows.append(o.transpose(1, 2).reshape(1, S, Hq * D) @ p["wo"])
    return torch.cat(rows)
