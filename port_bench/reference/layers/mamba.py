"""Mamba-2 mixer (arXiv:2405.21060, one group of B and C): x, z, B, C and
dt projected from the normed input; a causal depthwise convolution and
SiLU over x and over [B | C]; dt = softplus(dt_raw + dt_bias), A =
-exp(A_log); y = SSD(x, dt, A, B, C) + D x; out_proj(RMSNorm(y *
silu(z)))."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from reference.model import Spec
from reference.norms import rmsnorm


def layout(spec: Spec):
    d, di, N, H, W = (spec.d_model, spec.d_inner, spec.ssm_state,
                      spec.ssm_heads, spec.ssm_conv_width)
    return [("w_xz", (d, 2 * di), f"normal:{d}"),
            ("w_bc", (d, 2 * N), f"normal:{d}"),
            ("w_dt", (d, H), f"normal:{d}"),
            ("conv_x_w", (W, di), f"normal:{W}"),
            ("conv_bc_w", (W, 2 * N), f"normal:{W}"),
            ("out_proj", (di, d), f"normal:{di}"),
            ("conv_x_b", (di,), "bias"),
            ("conv_bc_b", (2 * N,), "bias"),
            ("a_log", (H,), "a_log"),
            ("dt_bias", (H,), "dt_bias"),
            ("d_skip", (H,), "ones"),
            ("norm.scale", (di,), "scale")]


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution: x [B, L, C], w [W, C], b [C];
    out[t] = b + sum_k w[k] x[t - (W - 1) + k]."""
    W, C = w.shape
    xt = F.pad(x.transpose(1, 2), (W - 1, 0))
    return F.conv1d(xt, w.t()[:, None, :], b, groups=C).transpose(1, 2)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
        c: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """The SSD recurrence h_t = exp(a dt_t) h_{t-1} + dt_t b_t x_t^T, y_t =
    c_t . h_t, computed chunk by chunk: x [B, L, H, P], dt [B, L, H], a [H],
    b and c [B, L, N] (one group for every head) -> y [B, L, H, P]."""
    Bsz, L, H, P = x.shape
    N = b.shape[-1]
    pad = -L % chunk
    if pad:  # zero dt past the end: no input, no decay
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        b, c = F.pad(b, (0, 0, 0, pad)), F.pad(c, (0, 0, 0, pad))
    Z = x.shape[1] // chunk
    xs = (x * dt[..., None]).view(Bsz, Z, chunk, H, P)
    ad = (dt * a).view(Bsz, Z, chunk, H)
    bs, cs = b.view(Bsz, Z, chunk, N), c.view(Bsz, Z, chunk, N)
    cum = ad.cumsum(dim=2)  # [B, Z, Q, H], inclusive
    # within a chunk: decay from j to i (i >= j) is exp(cum_i - cum_j)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B, Z, i, j, H]
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()[None, None, :, :, None]
    zero = torch.zeros((), device=x.device)
    decay = torch.where(lower, torch.exp(torch.where(lower, seg, zero)), zero)
    cb = torch.einsum("bzin,bzjn->bzij", cs, bs)
    y = torch.einsum("bzij,bzijh,bzjhp->bzihp", cb, decay, xs)
    # each chunk's own state, and the state entering each chunk
    to_end = torch.exp(cum[:, :, -1:, :] - cum)  # [B, Z, Q, H]
    own = torch.einsum("bzjn,bzjh,bzjhp->bzhnp", bs, to_end, xs)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # [B, Z, H]
    h = torch.zeros(Bsz, H, N, P, dtype=x.dtype, device=x.device)
    entering = []
    for z in range(Z):
        entering.append(h)
        h = h * chunk_decay[:, z, :, None, None] + own[:, z]
    h_in = torch.stack(entering, dim=1)  # [B, Z, H, N, P]
    y = y + torch.einsum("bzin,bzhnp,bzih->bzihp", cs, h_in, torch.exp(cum))
    return y.reshape(Bsz, Z * chunk, H, P)[:, :L]


def forward(p, spec: Spec, h: torch.Tensor,
            margins: Optional[list] = None) -> torch.Tensor:
    Bsz, L, _ = h.shape
    di, N = spec.d_inner, spec.ssm_state
    x, z = (h @ p["w_xz"]).split(di, dim=-1)
    bc = h @ p["w_bc"]
    dt_raw = h @ p["w_dt"]
    x = F.silu(causal_conv(x, p["conv_x_w"], p["conv_x_b"]))
    b, c = F.silu(causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"])).split(
        N, dim=-1)
    dt = F.softplus(dt_raw + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    xh = x.reshape(Bsz, L, spec.ssm_heads, spec.ssm_head_dim)
    y = ssd(xh, dt, a, b, c) + p["d_skip"][:, None] * xh
    y = rmsnorm.apply(p["norm"], y.reshape(Bsz, L, di) * F.silu(z),
                      spec.norm_eps)
    return y @ p["out_proj"]
