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
hand-written kernel on the card (its backward under autograd), with B and
C handed over as one group [B, L, 1, N] that it expands to every head as
stride-0 views.  The decode path keeps a [B, H, N, P] f32 state plus
(width - 1)-deep conv tails, O(1) per token whatever the context, and has
no kernel (nor has the JAX package's).

On a mesh (``tp``) a rank runs its heads (``common.partition`` of H):
``params`` hold its heads' x and z columns of ``w_xz``, its channels of
the x conv and of the gated norm, its heads' columns of ``w_dt`` and
entries of ``dt_bias``, ``a_log`` and ``d_skip``, and its rows of
``out_proj``; ``w_bc`` and the B|C conv are whole, so B and C are whole
on every rank.  The SSD runs on the local heads; the gated norm's sum of
squares is all-reduced over the model axis (``common.apply_norm``), and
``out_proj``'s partial output summed (``common.tp_out``).  The input
enters the model axis whole (``common.tp_in``: under sequence parallelism
the conv and the SSD see the whole sequence).  The head count and
d_inner are read off the parameters' shapes.

Matmul weights and the conv weights and biases are stored in ``cfg.dtype``
(the JAX package casts them to the activations' dtype at each use; the cast
rounds the same either way).  ``a_log``, ``d_skip``, ``dt_bias`` and the
norm's scale stay f32, as the JAX package uses them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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
                  ssd_impl: str = "auto",
                  tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """Full-sequence path: xin [B, L, d_model] -> [B, L, d_model].
    ``ssd_impl`` picks the SSD's implementation (``kernels.ops.ssd``)."""
    xin = common.tp_in(tp, xin)
    B, L, _ = xin.shape
    p = cfg.ssm_head_dim
    h, di = params["a_log"].shape[0], params["w_xz"].shape[-1] // 2
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
    # ngroups 1: one group of b and c for every head, [B, L, 1, N]; ops.ssd
    # expands it (stride 0 along H), and its backward sums over the heads
    y = kops.ssd(xh, dt, a, b[:, :, None, :], c[:, :, None, :],
                 d_skip=params["d_skip"], impl=ssd_impl)
    y = y.reshape(B, L, di)
    y = common.apply_norm(params["norm"], y * F.silu(z), tp=tp,
                          channels=cfg.ssm_d_inner)
    return common.tp_out(tp, y @ params["out_proj"].to(xin.dtype))


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
def init_mamba_cache(cfg: ModelConfig, batch: int, device,
                     place=None) -> MambaCache:
    """Zero state, all f32: the JAX package's default, which its block
    caches keep (they pass no dtype for this family).  ``place(name,
    shape, dtype, value)`` (on a mesh) allocates each tensor as the
    rank's shard of it."""
    di, n, h, p = _dims(cfg)
    w = cfg.ssm_conv_width
    shapes = {"conv_x": (batch, w - 1, di), "conv_bc": (batch, w - 1, 2 * n),
              "ssm": (batch, h, n, p)}
    f32 = torch.float32
    if place is None:
        made = {k: torch.zeros(v, dtype=f32, device=device)
                for k, v in shapes.items()}
        length = torch.zeros((), dtype=torch.int32, device=device)
    else:
        made = {k: place(k, v, f32, None) for k, v in shapes.items()}
        length = place("length", (), torch.int32, None)
    return MambaCache(length=length, **made)


def _conv_step(tail: torch.Tensor, cur: torch.Tensor, conv_w: torch.Tensor,
               conv_b: torch.Tensor):
    """One conv tap window -> (new tail, silu(conv)).  The window is formed
    in the activations' dtype; its weighted sum is an f32 sum of exact
    products, rounded once (a bf16 ``dot`` with f32 accumulation)."""
    window = torch.cat([tail.to(cur.dtype), cur[:, None, :]], dim=1)  # [B,W,C]
    out = (window.float() * conv_w.to(cur.dtype).float()).sum(dim=1)
    return window[:, 1:], F.silu(out.to(cur.dtype) + conv_b.to(cur.dtype))


def _compute_slice(tp: Optional[common.TensorParallel], t: torch.Tensor,
                   dim: int, whole: int, unit: int):
    """A cache leaf's part that this rank computes with, its heads' (each
    ``unit`` wide along ``dim``, ``whole`` wide in all) -> (that part, a
    function taking a new part to the leaf's local tensor).  The leaf's
    local tensor is the part itself (its shard over the model axis, the
    case wherever the heads divide the axis), or the whole leaf (the
    guard replicated it), or an even shard of other channels; then the
    part is cut from the whole and the new parts gathered whole again."""
    if tp is None:
        return t, lambda new: new
    ranges = [tuple(unit * i for i in common.partition(whole // unit,
                                                       tp.size, r))
              for r in range(tp.size)]
    lo, hi = ranges[tp.rank]
    width = t.shape[dim]
    start = 0 if width == whole else tp.rank * width
    if (start, start + width) == (lo, hi):
        return t, lambda new: new
    full = t if width == whole else common.all_gather_dim(
        t, dim, tp.group, tp.size)
    return full.narrow(dim, lo, hi - lo), lambda new: common.gather_ranges(
        tp, new, dim, ranges).narrow(dim, start, width)


def mamba_decode_step(params: dict, cfg: ModelConfig, cache: MambaCache,
                      xin: torch.Tensor,
                      tp: Optional[common.TensorParallel] = None):
    """One-token step: xin [B, 1, d_model] -> (cache, y [B, 1, d_model]).

    The SSM state and the length are updated in place (the returned cache
    shares them with ``cache``); the conv tails are new tensors.

    On a mesh (``tp``) the rank runs its heads as ``mamba_forward`` does:
    its x channels' conv tail and its heads' SSM state (the shards
    ``decode_shardings`` gives it: ``conv_x`` by channel and ``ssm`` by
    head over the model axis), the B|C path and its conv tail whole, the
    gated norm reduced over the model axis, ``out_proj`` row-parallel and
    summed."""
    xin = common.tp_in(tp, xin)
    B = xin.shape[0]
    _, n, H, p = _dims(cfg)
    h, di = params["a_log"].shape[0], params["w_xz"].shape[-1] // 2
    x1 = xin[:, 0]
    xz = x1 @ params["w_xz"].to(xin.dtype)
    x, z = xz.chunk(2, dim=-1)
    bc = x1 @ params["w_bc"].to(xin.dtype)
    dt_raw = x1 @ params["w_dt"].to(xin.dtype)

    tail_x, conv_x_back = _compute_slice(tp, cache.conv_x, 2, H * p, p)
    new_conv_x, x = _conv_step(tail_x, x, params["conv_x_w"],
                               params["conv_x_b"])
    new_conv_bc, bc = _conv_step(cache.conv_bc, bc, params["conv_bc_w"],
                                 params["conv_bc_b"])
    b, c = bc.chunk(2, dim=-1)

    dt = _softplus(dt_raw.float() + params["dt_bias"])  # [B, h]
    a = -torch.exp(params["a_log"])  # [h]
    decay = torch.exp(a[None] * dt)  # [B, h]
    xh = x.reshape(B, h, p).float()
    bh = b.float()[:, None, :].expand(B, h, n)
    ch = c.float()[:, None, :].expand(B, h, n)

    ssm, ssm_back = _compute_slice(tp, cache.ssm, 1, H, 1)
    ssm.mul_(decay[..., None, None]).add_(
        dt[..., None, None] * bh[..., :, None] * xh[..., None, :])
    if ssm is not cache.ssm:
        cache.ssm.copy_(ssm_back(ssm))
    y = torch.einsum("bhn,bhnp->bhp", ch, ssm)  # [B, h, P]
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(B, di).to(xin.dtype)
    y = common.apply_norm(params["norm"], y * F.silu(z), tp=tp,
                          channels=cfg.ssm_d_inner)
    y = common.tp_out(tp, (y @ params["out_proj"].to(xin.dtype))[:, None, :])
    cache.length.add_(1)
    return MambaCache(
        conv_x=conv_x_back(new_conv_x.to(cache.conv_x.dtype)),
        conv_bc=new_conv_bc.to(cache.conv_bc.dtype),
        ssm=cache.ssm, length=cache.length), y
