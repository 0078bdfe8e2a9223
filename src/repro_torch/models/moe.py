"""Mixture-of-experts FFN: top-k routing, capacity-bounded scatter dispatch.

The counterpart of ``repro/models/moe.py`` (GShard/Switch lineage, with the
scatter formulation that avoids a one-hot dispatch product):

* routing is per *batch row*: each (token, k) assignment's position in its
  expert's buffer is a cumulative count over the row's S·K assignments in
  token-major order, and the capacity C is per row;
* the kept assignments are added into an expert-major [E, B, C, d] buffer
  (JAX's [B, E, C, d] with the expert axis first, so that each expert's
  B·C rows are one batch of a ``torch.bmm`` against its weights); dropped
  ones (position >= C) are zeroed and added into slot C-1, as in JAX, so
  each slot holds at most one non-zero term and the sum does not depend on
  the order of the adds;
* the combine gathers each assignment's row, times ``keep`` and its
  normalised router weight, summed over k; a shared expert (Llama-4) is a
  plain FFN added on top;
* the Switch aux loss E·Σ_e f_e·P_e·w, of the batch's fractions f_e
  (assignments) and P_e (mean router probability).  Under
  :func:`global_batch` (a data-parallel train step, each rank on its own
  rows) the fractions are the global batch's: the expert counts are summed
  over the ranks, and each rank's aux is its rows' share of the global
  E·Σ_e f_e·P_e·w, so the shares add up to it (a mean of the ranks' own
  aux losses would be another number).

Nothing here synchronises with the host: no boolean-mask indexing, no
``nonzero``, no ``.item()``.  The expert products are cuBLAS batched
matmuls (the JAX package's are ``einsum``s outside any kernel).
``moe_forward`` calls :func:`route`, :func:`dispatch`, :func:`experts` and
:func:`combine` through this module, so a caller can wrap each (a
profiler range, a record of the routing).

Expert parallelism (``tp``, a mesh's model axis): ``params`` hold this
rank's experts (``common.partition`` of E) and its columns of the shared
expert.  The router is whole on every rank and routes the whole sequence
of every row (under sequence parallelism the sequence is gathered first:
routing a shard would change the capacity groups, and so the drops), so
every rank holds the same routing and aux loss, those of one device.  Each
rank then dispatches into a buffer of its own experts only
(:func:`dispatch` with ``experts=``), runs them, and combines their
outputs: its partial sum of each token's k outputs, summed over the model
axis with the shared expert's partial output (``common.tp_out``).  The
tokens and the routing weights enter the expert path through
``common.copy_to``, their gradients summed over the ranks.

DBRX (16 experts top-4), Llama-4 Maverick (128 top-1 + 1 shared) and Jamba
(16 top-2, every other layer) all instantiate this module.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.ffn import add_b_out, ffn_partial, init_ffn


#: set by :func:`global_batch`: sums a tensor over the data-parallel ranks
_BATCH_SUM: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@contextlib.contextmanager
def global_batch(batch_sum: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]]):
    """Inside, the aux loss takes its fractions over the global batch,
    ``batch_sum`` summing a tensor over the ranks (None: this rank's batch
    is the batch).  A train step keeps it set through its backward, where
    remat recomputes the layers."""
    global _BATCH_SUM
    old, _BATCH_SUM = _BATCH_SUM, batch_sum
    try:
        yield
    finally:
        _BATCH_SUM = old


class Route(NamedTuple):
    """One MoE layer's routing of x [B, S, d]."""

    probs: torch.Tensor  # [B, S, E] f32 router probabilities
    topk_idx: torch.Tensor  # [B, S, K] int64 experts, best first
    topk_w: torch.Tensor  # [B, S, K] normalised weights, x's dtype
    pos: torch.Tensor  # [B, S*K] int64 position in the expert's buffer
    keep: torch.Tensor  # [B, S*K] 1 where pos < C, else 0; x's dtype


def init_moe(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype) -> dict:
    """Router [d, E], experts w_gate and w_up [E, d, ff], w_down [E, ff, d]
    (each expert drawn as one ``dense_init``, as the JAX package's vmap
    does), and the shared expert's FFN of width ff · num_shared_experts.
    All stored in ``dtype``: the JAX package casts them to the activations'
    dtype at each use."""
    d, ff, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dev = generator.device

    def expert_stack(in_dim, out_dim):
        w = torch.empty((e, in_dim, out_dim), dtype=dtype, device=dev)
        for i in range(e):  # one expert at a time: no f32 copy of all E
            w[i] = common.dense_init(generator, in_dim, out_dim, dtype)
        return w

    params = {
        "router": common.dense_init(generator, d, e, dtype),
        "w_gate": expert_stack(d, ff),
        "w_up": expert_stack(d, ff),
        "w_down": expert_stack(ff, d),
    }
    if cfg.num_shared_experts:
        params["shared"] = init_ffn(generator, cfg, dtype,
                                    d_ff=ff * cfg.num_shared_experts)
    return params


def capacity_per_group(cfg: ModelConfig, group_len: int) -> int:
    """Slots per expert in one batch row: the JAX package's expression,
    evaluated in the same Python float order."""
    c = int(group_len * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(1, c)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, and on equal
    values the lower index first (``torch.topk`` promises no order among
    ties; a stable descending sort keeps the index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: dict, cfg: ModelConfig, x: torch.Tensor) -> Route:
    """x [B, S, d] -> its :class:`Route`, with S's capacity."""
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = capacity_per_group(cfg, S)
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    topk_p, topk_idx = top_k(probs, K)
    topk_w = (topk_p / topk_p.sum(dim=-1, keepdim=True).clamp_min(1e-9)
              ).to(x.dtype)
    # each assignment's position among its row's assignments to the same
    # expert, counted in token-major order
    e_flat = topk_idx.reshape(B, S * K)
    onehot = (e_flat[..., None]
              == torch.arange(E, device=x.device)).to(torch.int32)
    counts = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    pos = counts.gather(-1, e_flat[..., None])[..., 0].long() - 1
    keep = (pos < C).to(x.dtype)
    return Route(probs, topk_idx, topk_w, pos, keep)


def dispatch(x: torch.Tensor, r: Route, num_experts: int,
             capacity: int, experts: Optional[tuple] = None):
    """x [B, S, d] -> (the expert-major buffer [E, B·C, d], each
    assignment's flat slot [B, S·K], and its keep mask: ``r.keep``, or
    with ``experts`` = (e0, e1) the buffer of those experts alone, [e1 -
    e0, B·C, d], the assignments to others kept out).  Each token is
    copied once per k, dropped copies zeroed, and added into slot (e, b,
    min(pos, C-1))."""
    B, S, d = x.shape
    K = r.topk_idx.shape[-1]
    E, C = num_experts, capacity
    e_flat = r.topk_idx.reshape(B, S * K)
    keep = r.keep
    if experts is not None:
        e0, e1 = experts
        mine = (e_flat >= e0) & (e_flat < e1)
        keep = keep * mine.to(keep.dtype)
        e_flat = (e_flat - e0).clamp(0, e1 - e0 - 1)
        E = e1 - e0
    b_idx = torch.arange(B, device=x.device)[:, None]
    slot = (e_flat * B + b_idx) * C + r.pos.clamp_max(C - 1)
    xt = x[:, :, None, :].expand(B, S, K, d).reshape(B, S * K, d)
    xt = xt * keep[..., None]
    buf = torch.zeros((E * B * C, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot.reshape(-1), xt.reshape(B * S * K, d))
    return buf.view(E, B * C, d), slot, keep


def experts(params: dict, cfg: ModelConfig, buf: torch.Tensor
            ) -> torch.Tensor:
    """Every expert's gated FFN on its B·C rows: [E, B·C, d] -> same."""
    dtype = buf.dtype
    gate = torch.bmm(buf, params["w_gate"].to(dtype))
    up = torch.bmm(buf, params["w_up"].to(dtype))
    h = common.gated_act(cfg.act if cfg.act != "gelu" else "swiglu", gate, up)
    return torch.bmm(h, params["w_down"].to(dtype))


def combine(out_buf: torch.Tensor, r: Route, slot: torch.Tensor,
            keep: Optional[torch.Tensor] = None,
            weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each assignment's row, times keep and its weight, summed over k ->
    [B, S, d] in the buffer's dtype (``keep`` and ``weights``: the route's
    unless given)."""
    B, S, K = r.topk_idx.shape
    d = out_buf.shape[-1]
    keep = r.keep if keep is None else keep
    weights = r.topk_w if weights is None else weights
    y_flat = out_buf.reshape(-1, d)[slot] * keep[..., None]
    return (y_flat.view(B, S, K, d) * weights[..., None]).sum(dim=2).to(
        out_buf.dtype)


def moe_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                tp: Optional[common.TensorParallel] = None):
    """x [B, S, d] -> (y [B, S, d], aux loss, a 0-dim f32 tensor).  On a
    mesh ``x`` is the rank's input (under sequence parallelism its share of
    S) and ``y`` its share of the output."""
    x = common.gather_replicated(tp, x)
    B, S, _ = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    r = route(params, cfg, x)
    rng = None  # every expert on one device
    if tp is not None:
        if E < tp.size:
            raise ValueError(f"expert parallelism needs an expert a rank: "
                             f"{E} experts on {tp.size} ranks")
        e0 = common.partition(E, tp.size, tp.rank)[0]
        rng = (e0, e0 + params["w_gate"].shape[0])
    xs = common.copy_to(tp, x)
    buf, slot, keep = dispatch(xs, r, E, capacity_per_group(cfg, S),
                               experts=rng)
    y = combine(experts(params, cfg, buf), r, slot, keep,
                common.copy_to(tp, r.topk_w))
    if cfg.num_shared_experts:
        y = y + ffn_partial(params["shared"], cfg, xs)
    y = common.tp_out(tp, y)
    if cfg.num_shared_experts:
        y = add_b_out(params["shared"], y, tp)

    # Switch aux loss: fraction dispatched x mean router prob, per expert
    n = B * S * K
    frac = torch.zeros((E,), dtype=torch.float32, device=x.device)
    frac.index_add_(0, r.topk_idx.reshape(-1),
                    torch.ones((n,), dtype=torch.float32, device=x.device))
    if _BATCH_SUM is None:
        mean_p = r.probs.reshape(-1, E).mean(dim=0)
        aux = E * (frac / n * mean_p).sum() * cfg.router_aux_weight
        return y, aux
    # this rank's share: the global counts (n of them over n / K tokens)
    # against its own rows' probabilities over the global token count
    frac = _BATCH_SUM(frac)
    n = frac.sum()
    mean_p = r.probs.reshape(-1, E).sum(dim=0) / (n / K)
    aux = E * (frac / n * mean_p).sum() * cfg.router_aux_weight
    return y, aux
