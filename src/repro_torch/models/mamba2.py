"""Mamba-2 block (SSD, state-space duality, arXiv:2405.21060).

The counterpart of ``repro/models/mamba2.py``.  Block layout (ngroups 1):

    w_xz : d -> [x (di) | z (di)]      (input and gate streams)
    w_bc : d -> [B (N) | C (N)]        (state in and out projections)
    w_dt : d -> H                      (per-head step sizes)
    causal depthwise conv (width 4) over x and over [B|C], SiLU
    dt = softplus(dt_raw + dt_bias); A = -exp(A_log)
    y = SSD(x, dt, A, B, C) + D * x    (kernels.ops.ssd)
    y = RMSNorm(y * silu(z))           (gated norm)
    out_proj : di -> d

The full-sequence path runs the SSD through ``kernels.ops.ssd``: the
hand-written kernel on the card, with B and C handed over as stride-0
views expanded to every head.  The decode path keeps a [B, H, N, P] f32
state plus (width - 1)-deep conv tails, O(1) per token whatever the
context, and has no kernel (nor has the JAX package's).

Matmul weights and the conv weights and biases are stored in ``cfg.dtype``
(the JAX package casts them to the activations' dtype at each use; the cast
rounds the same either way).  ``a_log``, ``d_skip``, ``dt_bias`` and the
norm's scale stay f32, as the JAX package uses them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import common


class MambaCache(NamedTuple):
    """Decode-time state of one Mamba layer."""

    conv_x: torch.Tensor  # [B, W-1, di] trailing x inputs
    conv_bc: torch.Tensor  # [B, W-1, 2N] trailing B|C inputs
    ssm: torch.Tensor  # [B, H, N, P] f32 state
    length: torch.Tensor  # [] int32


def _dims(cfg: ModelConfig):
    return cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim


def init_mamba(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    """One layer's parameters on the generator's device, drawn in a fixed
    order; the distributions of the JAX package's ``init_mamba``."""
    di, n, h, _ = _dims(cfg)
    w = cfg.ssm_conv_width
    dev = generator.device
    f32 = dict(dtype=torch.float32, device=dev)
    w_xz = common.dense_init(generator, cfg.d_model, 2 * di, dtype)
    w_bc = common.dense_init(generator, cfg.d_model, 2 * n, dtype)
    w_dt = common.dense_init(generator, cfg.d_model, h, dtype)
    conv_x_w = torch.randn((w, di), generator=generator, **f32) * w ** -0.5
    conv_bc_w = torch.randn((w, 2 * n), generator=generator, **f32) * w ** -0.5
    out_proj = common.dense_init(generator, di, cfg.d_model, dtype)
    # dt bias so that softplus(bias) spans [1e-3, 1e-1] (mamba2's default)
    u = torch.rand((h,), generator=generator, **f32)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))  # inverse softplus
    return {
        "w_xz": w_xz,
        "w_bc": w_bc,
        "w_dt": w_dt,
        "conv_x_w": conv_x_w.to(dtype),
        "conv_x_b": torch.zeros((di,), dtype=dtype, device=dev),
        "conv_bc_w": conv_bc_w.to(dtype),
        "conv_bc_b": torch.zeros((2 * n,), dtype=dtype, device=dev),
        "a_log": torch.log(torch.arange(1, h + 1, **f32)),
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": dt_bias,
        "norm": common.init_norm("rmsnorm", di, dev),
        "out_proj": out_proj,
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 width: int) -> torch.Tensor:
    """Depthwise causal conv over [B, L, C] as width shifted taps, summed in
    x's dtype in tap order from 0, as the JAX package does (``F.conv1d``
    would sum in f32, and in TF32 for f32 inputs on the card)."""
    cw = conv_w.to(x.dtype)
    L = x.shape[1]
    taps = [F.pad(x, (0, 0, width - 1 - w, 0))[:, :L] * cw[w]
            for w in range(width)]
    out = taps[0]  # 0 + taps[0], exactly
    for tap in taps[1:]:
        out = out + tap
    return out + conv_b.to(x.dtype)


def mamba_forward(params: dict, cfg: ModelConfig, xin: torch.Tensor,
                  ssd_impl: str = "auto") -> torch.Tensor:
    """Full-sequence path: xin [B, L, d_model] -> [B, L, d_model].
    ``ssd_impl`` picks the SSD's implementation (``kernels.ops.ssd``)."""
    B, L, _ = xin.shape
    di, n, h, p = _dims(cfg)
    xz = xin @ params["w_xz"].to(xin.dtype)
    x, z = xz.chunk(2, dim=-1)
    bc = xin @ params["w_bc"].to(xin.dtype)
    dt_raw = xin @ params["w_dt"].to(xin.dtype)

    x = F.silu(_causal_conv(x, params["conv_x_w"], params["conv_x_b"],
                            cfg.ssm_conv_width))
    bc = F.silu(_causal_conv(bc, params["conv_bc_w"], params["conv_bc_b"],
                             cfg.ssm_conv_width))
    b, c = bc.chunk(2, dim=-1)

    dt = _softplus(dt_raw.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    xh = x.reshape(B, L, h, p)
    bh = b[:, :, None, :].expand(B, L, h, n)  # ngroups 1: stride 0 along H
    ch = c[:, :, None, :].expand(B, L, h, n)
    y = kops.ssd(xh, dt, a, bh, ch, d_skip=params["d_skip"], impl=ssd_impl)
    y = y.reshape(B, L, di)
    y = common.apply_norm(params["norm"], y * F.silu(z))
    return y @ params["out_proj"].to(xin.dtype)


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
def init_mamba_cache(cfg: ModelConfig, batch: int, device) -> MambaCache:
    """Zero state, all f32: the JAX package's default, which its block
    caches keep (they pass no dtype for this family)."""
    di, n, h, p = _dims(cfg)
    w = cfg.ssm_conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return MambaCache(
        conv_x=torch.zeros((batch, w - 1, di), **f32),
        conv_bc=torch.zeros((batch, w - 1, 2 * n), **f32),
        ssm=torch.zeros((batch, h, n, p), **f32),
        length=torch.zeros((), dtype=torch.int32, device=device),
    )


def _conv_step(tail: torch.Tensor, cur: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor):
    """One conv tap window -> (new tail, silu(conv)).  The window is formed
    in the activations' dtype; its weighted sum is an f32 sum of exact
    products, rounded once (a bf16 ``dot`` with f32 accumulation)."""
    window = torch.cat([tail.to(cur.dtype), cur[:, None, :]], dim=1)  # [B,W,C]
    out = (window.float() * conv_w.to(cur.dtype).float()).sum(dim=1)
    return window[:, 1:], F.silu(out.to(cur.dtype) + conv_b.to(cur.dtype))


def mamba_decode_step(params: dict, cfg: ModelConfig, cache: MambaCache,
                      xin: torch.Tensor):
    """One-token step: xin [B, 1, d_model] -> (cache, y [B, 1, d_model]).

    The SSM state and the length are updated in place (the returned cache
    shares them with ``cache``); the conv tails are new tensors."""
    B = xin.shape[0]
    di, n, h, p = _dims(cfg)
    x1 = xin[:, 0]
    xz = x1 @ params["w_xz"].to(xin.dtype)
    x, z = xz.chunk(2, dim=-1)
    bc = x1 @ params["w_bc"].to(xin.dtype)
    dt_raw = x1 @ params["w_dt"].to(xin.dtype)

    new_conv_x, x = _conv_step(cache.conv_x, x, params["conv_x_w"],
                               params["conv_x_b"])
    new_conv_bc, bc = _conv_step(cache.conv_bc, bc, params["conv_bc_w"],
                                 params["conv_bc_b"])
    b, c = bc.chunk(2, dim=-1)

    dt = _softplus(dt_raw.float() + params["dt_bias"])  # [B, H]
    a = -torch.exp(params["a_log"])  # [H]
    decay = torch.exp(a[None] * dt)  # [B, H]
    xh = x.reshape(B, h, p).float()
    bh = b.float()[:, None, :].expand(B, h, n)
    ch = c.float()[:, None, :].expand(B, h, n)

    ssm = cache.ssm
    ssm.mul_(decay[..., None, None]).add_(
        dt[..., None, None] * bh[..., :, None] * xh[..., None, :])
    y = torch.einsum("bhn,bhnp->bhp", ch, ssm)  # [B, H, P]
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(B, di).to(xin.dtype)
    y = common.apply_norm(params["norm"], y * F.silu(z))
    y = (y @ params["out_proj"].to(xin.dtype))[:, None, :]
    cache.length.add_(1)
    return MambaCache(conv_x=new_conv_x.to(cache.conv_x.dtype),
                      conv_bc=new_conv_bc.to(cache.conv_bc.dtype),
                      ssm=ssm, length=cache.length), y
