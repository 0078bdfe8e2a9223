"""Top-k MoE (GShard): softmax router, the top k experts of each token
(ties to the lower index), weights renormalised over the k, a per-row
capacity of int(S k c / E) slots an expert; assignments counted in
token-major order past the capacity are dropped.  Each expert a SwiGLU."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from reference.layers.ffn import swiglu
from reference.model import Spec


def layout(spec: Spec):
    d, f, E = spec.d_model, spec.d_ff, spec.num_experts
    return [("router", (d, E), f"normal:{d}"),
            ("w_gate", (E, d, f), f"normal:{d}"),
            ("w_up", (E, d, f), f"normal:{d}"),
            ("w_down", (E, f, d), f"normal:{f}")]


def capacity(spec: Spec, group_len: int) -> int:
    """Slots an expert has in one row of ``group_len`` tokens."""
    return max(1, int(group_len * spec.experts_per_token
                      * spec.capacity_factor / spec.num_experts))


def forward(p, spec: Spec, h: torch.Tensor,
            margins: Optional[list] = None) -> torch.Tensor:
    """Each row of h [B, S, d] its own capacity group: every token's k
    experts, each assignment kept while its expert has had fewer than
    ``capacity`` earlier assignments in the row (counted token by token, k
    by k), the kept outputs summed with the renormalised router weights.
    ``margins`` gets each token's router margin [B, S]: the k-th
    probability less the next."""
    Bsz, S, d = h.shape
    E, K = spec.num_experts, spec.experts_per_token
    C = capacity(spec, S)
    probs = torch.softmax(h @ p["router"], dim=-1)  # [B, S, E]
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    if margins is not None:
        margins.append(top_p[..., K - 1] - top_p[..., K])
    top_p, top_e = top_p[..., :K], top_e[..., :K]
    weight = top_p / top_p.sum(dim=-1, keepdim=True)
    flat_e = top_e.reshape(Bsz, S * K)
    onehot = F.one_hot(flat_e, E)
    position = (onehot.cumsum(dim=1) * onehot).sum(dim=-1) - 1  # [B, S*K]
    kept = (position < C).reshape(Bsz, S, K)
    out = torch.zeros_like(h)
    x2, out2 = h.reshape(Bsz * S, d), out.view(Bsz * S, d)
    for e in range(E):
        hit = (top_e == e) & kept  # [B, S, K]
        token = hit.any(dim=-1).reshape(-1).nonzero()[:, 0]
        if token.numel() == 0:
            continue
        w = (weight * hit).sum(dim=-1).reshape(-1)[token]
        y = swiglu({"w_gate": p["w_gate"][e], "w_up": p["w_up"][e],
                    "w_down": p["w_down"][e]}, x2[token])
        out2.index_add_(0, token, y * w[:, None])
    return out
