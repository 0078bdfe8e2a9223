"""Shared model building blocks: initializers, norms, RoPE, activations.

The counterpart of ``repro/models/common.py``.  Parameters are
plain dicts of tensors, as the JAX package's pytrees are, so a JAX
parameter tree carries across leaf for leaf (``repro_torch.convert``).
Every function keeps the JAX package's arithmetic: which dtype each step
runs in and where it rounds.

On a mesh the JAX package pins activations (``set_activation_mesh``,
``constrain``) and GSPMD partitions the compute.  The port's counterpart is
explicit: a :class:`TensorParallel` context (the mesh's ``model`` group,
this rank's index in it, its size) that the step passes down the layers
as an argument.  Each sublayer enters the model axis with :func:`tp_in`
and leaves it with :func:`tp_out` (Megatron's pair of conjugate
collectives: the identity and an all-reduce, or under sequence
parallelism an all-gather and a reduce-scatter over the sequence), and
reads its parameters through :func:`layer`, which gathers one layer's
shards for compute (``launch/sharding.py``).  Every rank of the model axis
computes the same loss: a value the ranks hold alike has the same
gradient on each, and a rank-local one its own.  Without a context
(``tp=None``, one device) every helper returns its input.

Decode on a mesh adds a :class:`CacheShard` (where a rank's share of a
KV cache lies), the reductions over the cache's sequence axes
(:func:`seq_max`, :func:`seq_sum`), the gathers of a projection's heads
and of the vocab-parallel logits over the model axis
(:func:`gather_ranges`: uneven or shared parts, each index once) and the
cut back to a rank's heads (:func:`own_heads`); they run under
``no_grad`` and carry no gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _trunc_normal(generator: torch.Generator, shape, std: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """std * (a standard normal truncated to [-2, 2]), drawn in f32 on the
    generator's device, then cast (the JAX package's
    ``std * truncated_normal(key, -2, 2, shape, f32)).astype(dtype)``)."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in scaling (the LLaMA/MaxText default)."""
    return _trunc_normal(generator, (in_dim, out_dim), in_dim ** -0.5, dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """std d^-1/2: tied unembedding then yields O(1) logits at init."""
    return _trunc_normal(generator, (vocab, dim), dim ** -0.5, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(norm: str, dim: int, device) -> dict:
    """Norm parameters, f32 whatever the model's dtype."""
    if norm == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=torch.float32,
                                    device=device)}
    if norm == "layernorm":
        return {"scale": torch.ones((dim,), dtype=torch.float32,
                                    device=device),
                "bias": torch.zeros((dim,), dtype=torch.float32,
                                    device=device)}
    raise ValueError(f"unknown norm {norm}")


def apply_norm(params: dict, x: torch.Tensor, eps: float = 1e-6,
               tp: Optional["TensorParallel"] = None,
               channels: int = 0) -> torch.Tensor:
    """RMSNorm (or LayerNorm where the params hold a bias) in f32 with an
    f32 scale, cast back to x's dtype.

    With ``tp`` and ``channels`` (an RMSNorm over channels sharded over the
    model axis, ``x`` this rank's share of ``channels``: mamba's gated
    norm) the sum of squares is all-reduced over the model axis before the
    rsqrt.  With ``tp`` alone, ``x`` is a sequence shard of the residual
    stream (sequence parallelism): the parameters the ranks hold alike are
    used on rank-local rows, so their gradients are summed over the model
    axis (:func:`copy_to`)."""
    xf = x.float()
    if tp is not None and channels:
        ss = reduce_sum(tp, (xf * xf).sum(dim=-1, keepdim=True))
        y = xf * torch.rsqrt(ss / channels + eps) * params["scale"]
        return y.to(x.dtype)
    if tp is not None and tp.sequence_parallel:
        params = {k: copy_to(tp, v) for k, v in params.items()}
    if "bias" in params:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, H, S, D]; positions [S] or [B, S].  Rotates the two halves of
    D (not interleaved pairs), with the angles in f32; returns x's dtype."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)  # [D/2]
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None, :]
        angles = angles[None, None]  # [1, 1, S, D/2]
    else:
        angles = positions[:, :, None].float() * freqs[None, None, :]
        angles = angles[:, None]  # [B, 1, S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal positions (the enc-dec stacks)
# ---------------------------------------------------------------------------
def _sinusoid_div(dim: int, device) -> torch.Tensor:
    return torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device)
                     * (-math.log(10000.0) / dim))


def sinusoidal_at(position: int, dim: int, device=None) -> torch.Tensor:
    """The sinusoidal embedding of one position, [dim] f32: sin on even
    channels, cos on odd.  ``position`` is a host int (a ``KVCache.length``),
    so a decode step computes it on the device without a sync."""
    angles = _sinusoid_div(dim, device) * float(position)
    return torch.stack([torch.sin(angles), torch.cos(angles)],
                       dim=-1).reshape(dim)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Additive absolute positions [seq_len, dim] f32 (the seamless enc
    and dec stacks)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    angles = pos * _sinusoid_div(dim, device)
    pe = torch.zeros((seq_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def gated_act(act: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(f"{act} is not a gated activation")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss_weight: float = 1e-4,
                  tp: Optional["TensorParallel"] = None,
                  vocab_start: int = 0):
    """Stable softmax cross-entropy with z-loss (PaLM-style logit drift
    guard), the JAX package's ``repro.models.common.cross_entropy``.

    logits [..., V] (any dtype; reduced in f32), labels [...] int.  Returns
    (mean loss, metrics) with the same metrics: ``nll``, ``z_loss`` and
    ``tokens``.  The log-sum-exp is taken in f32 after subtracting the
    row's max (held out of the gradient, as ``stop_gradient`` there).

    The JAX package picks each label's logit with a one-hot sum, for
    GSPMD's sake (a gather along a sharded vocab axis all-gathers the
    logits); on one card that one-hot would be a [..., V] f32 tensor (4.2
    GB at 2 x 4096 x 128256), so the port picks it with ``torch.gather``:
    the same value, the one product of a one-hot row being exact.

    With ``tp``, ``logits`` are this rank's columns of the vocabulary,
    from ``vocab_start`` on (the unembedding's vocab-parallel output): the
    row max is all-reduced (max) and the sum of exponentials (sum) over
    the model axis, and each label's logit is picked on the rank whose
    columns hold it and summed over the ranks (the others add 0)."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    if tp is not None:
        m = all_reduce_max(tp, m)
    shifted = logits - m
    sum_exp = torch.exp(shifted).sum(dim=-1)
    labels = labels.long()
    if tp is None:
        lse = torch.log(sum_exp) + m[..., 0]
        ll = shifted.gather(-1, labels[..., None])[..., 0] + m[..., 0]
    else:
        lse = torch.log(reduce_replicated(tp, sum_exp)) + m[..., 0]
        local = labels - vocab_start
        owned = (local >= 0) & (local < logits.shape[-1])
        picked = shifted.gather(
            -1, local.clamp(0, logits.shape[-1] - 1)[..., None])[..., 0]
        ll = reduce_replicated(tp, picked * owned) + m[..., 0]
    nll = lse - ll
    z = lse * lse
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    zloss = (z * mask).sum() / denom
    total = loss + z_loss_weight * zloss
    return total, {"nll": loss, "z_loss": zloss, "tokens": denom}


# ---------------------------------------------------------------------------
# tensor parallelism over the mesh's model axis
# ---------------------------------------------------------------------------
class Shards(NamedTuple):
    """One layer's parameters as a rank stores them: its storage shards (a
    tensor or a dict of them) and the plan that gathers them for compute
    (``launch/sharding.py:LeafPlan``, one per tensor)."""

    local: Any
    plan: Any


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The model axis as the layers see it: its process group (None: a
    group of one), this rank's index in it and its size.
    ``sequence_parallel``: the residual stream between sublayers is this
    rank's share of the sequence (``transformer.forward`` sets it where
    ``cfg.sequence_parallel`` asks and the sequence divides).  ``gather``
    turns a layer's :class:`Shards` into its compute tensors."""

    group: Any
    rank: int
    size: int
    sequence_parallel: bool = False
    gather: Optional[Callable[[Shards], Any]] = None


def layer(tp: Optional[TensorParallel], params):
    """A layer's compute parameters: ``params`` as they are on one device,
    its :class:`Shards` gathered on a mesh."""
    return params if tp is None else tp.gather(params)


def partition(n: int, size: int, rank: int) -> Tuple[int, int]:
    """Rank ``rank``'s contiguous share [start, stop) of ``n`` items split
    over ``size`` ranks, the first ``n % size`` ranks taking one more."""
    base, extra = divmod(n, size)
    start = rank * base + min(rank, extra)
    return start, start + base + (1 if rank < extra else 0)


def head_ranges(num_heads: int, num_kv_heads: int, size: int,
                rank: int) -> Tuple[int, int, int, int]:
    """A rank's attention heads over a model axis of ``size``: its query
    heads [q0, q1) and the KV heads [k0, k1) they read, so that its heads
    are whole GQA groups or part of one (the flash kernel's grouping,
    query head h on KV head h // group, holds on the rank).

    * KV heads at least the axis: each rank takes whole groups, its share
      of the KV heads (``partition``) and their query heads.
    * Fewer KV heads than ranks: each KV head takes its share of the ranks,
      which split its group's query heads between them; the KV head is
      computed on each of them, its gradient summed over them.

    Where the axis does not divide the heads, the first ranks take one
    more; a rank may hold none (internvl2-1b: 14 query heads, 2 KV heads on
    16 ranks; the busiest rank, 0, has the most, so the dry run, which
    traces rank 0, counts the most any rank computes)."""
    group = num_heads // num_kv_heads
    if num_kv_heads >= size:
        k0, k1 = partition(num_kv_heads, size, rank)
        return k0 * group, k1 * group, k0, k1
    for kv in range(num_kv_heads):
        r0, r1 = partition(size, num_kv_heads, kv)
        if r0 <= rank < r1:
            s, e = partition(group, r1 - r0, rank - r0)
            return kv * group + s, kv * group + e, kv, kv + 1
    raise AssertionError("unreachable")


def _no_op(tp: Optional[TensorParallel]) -> bool:
    return tp is None or tp.size == 1


def all_reduce(t: torch.Tensor, group,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the ranks of ``group``, in a new tensor."""
    out = t.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_gather_dim(t: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """``t`` concatenated along ``dim`` over the ``n`` ranks of ``group``,
    in rank order (one ``all_gather_into_tensor``; another dim than the
    first goes through a moved copy)."""
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_scatter_dim(t: torch.Tensor, dim: int, group,
                       n: int) -> torch.Tensor:
    """``t`` summed over the ``n`` ranks of ``group``, this rank's chunk
    along ``dim`` (one ``reduce_scatter_tensor``)."""
    if n == 1:
        return t
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous() if dim else out


def own_chunk(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    size = t.shape[dim] // n
    return t.narrow(dim, rank * size, size).contiguous()


class _CopyTo(torch.autograd.Function):
    """The identity; its backward sums the gradient over the model axis
    (a value the ranks hold alike, used by each on its own share)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.tp.group), None


class _ReduceReplicated(torch.autograd.Function):
    """An all-reduce (sum) whose result the ranks then use alike: its
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceSum(torch.autograd.Function):
    """An all-reduce (sum) whose result each rank uses on its own share:
    its backward sums the gradients too."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_reduce(x, tp.group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.tp.group), None


class _GatherSeq(torch.autograd.Function):
    """All-gather along ``dim``; backward: a reduce-scatter (the result
    used by each rank on its own share) or the rank's chunk (used alike)."""

    @staticmethod
    def forward(ctx, x, tp, dim, summed):
        ctx.tp, ctx.dim, ctx.summed = tp, dim, summed
        return all_gather_dim(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        tp = ctx.tp
        if ctx.summed:
            return reduce_scatter_dim(g, ctx.dim, tp.group, tp.size), \
                None, None, None
        return own_chunk(g, ctx.dim, tp.rank, tp.size), None, None, None


class _ScatterSeq(torch.autograd.Function):
    """Reduce-scatter along ``dim`` (a partial sum -> this rank's chunk of
    the total); backward: all-gather."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return reduce_scatter_dim(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.tp.group, ctx.tp.size), \
            None, None


class _SplitSeq(torch.autograd.Function):
    """This rank's chunk along ``dim`` of a value the ranks hold alike;
    backward: all-gather."""

    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return own_chunk(x, dim, tp.rank, tp.size)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.tp.group, ctx.tp.size), \
            None, None


def copy_to(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: ``x`` as it is, its gradient summed over the ranks."""
    return x if _no_op(tp) else _CopyTo.apply(x, tp)


def reduce_replicated(tp: Optional[TensorParallel],
                      x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the sum over the ranks, used alike by each."""
    return x if _no_op(tp) else _ReduceReplicated.apply(x, tp)


def reduce_sum(tp: Optional[TensorParallel], x: torch.Tensor) -> torch.Tensor:
    """The sum over the ranks, each using it on its own share."""
    return x if _no_op(tp) else _ReduceSum.apply(x, tp)


def all_reduce_max(tp: Optional[TensorParallel],
                   x: torch.Tensor) -> torch.Tensor:
    """The maximum over the ranks (no gradient: a detached value)."""
    return x if _no_op(tp) else all_reduce(x, tp.group, dist.ReduceOp.MAX)


def tp_in(tp: Optional[TensorParallel], x: torch.Tensor,
          dim: int = 1) -> torch.Tensor:
    """A sublayer's input entering the model axis: the whole sequence on
    every rank, its gradient summed over the ranks (the identity, or under
    sequence parallelism an all-gather along ``dim``)."""
    if _no_op(tp):
        return x
    if tp.sequence_parallel:
        return _GatherSeq.apply(x, tp, dim, True)
    return _CopyTo.apply(x, tp)


def tp_out(tp: Optional[TensorParallel], y: torch.Tensor,
           dim: int = 1) -> torch.Tensor:
    """A sublayer's partial output leaving the model axis: summed over the
    ranks (an all-reduce, or under sequence parallelism a reduce-scatter
    along ``dim`` to this rank's share of the sequence)."""
    if _no_op(tp):
        return y
    if tp.sequence_parallel:
        return _ScatterSeq.apply(y, tp, dim)
    return _ReduceReplicated.apply(y, tp)


def gather_replicated(tp: Optional[TensorParallel], x: torch.Tensor,
                      dim: int = 1) -> torch.Tensor:
    """Under sequence parallelism the whole sequence of ``x``, used alike
    by every rank (all-gather; backward: the rank's chunk); ``x``
    otherwise."""
    if _no_op(tp) or not tp.sequence_parallel:
        return x
    return _GatherSeq.apply(x, tp, dim, False)


def gather_columns(tp: Optional[TensorParallel],
                   x: torch.Tensor) -> torch.Tensor:
    """A column-parallel output gathered whole along its last dimension,
    then used alike by every rank (backward: the rank's columns)."""
    if _no_op(tp):
        return x
    return _GatherSeq.apply(x, tp, x.dim() - 1, False)


def split_seq(tp: Optional[TensorParallel], x: torch.Tensor,
              dim: int = 1) -> torch.Tensor:
    """Under sequence parallelism this rank's share of a sequence the ranks
    hold alike (backward: all-gather); ``x`` otherwise."""
    if _no_op(tp) or not tp.sequence_parallel:
        return x
    return _SplitSeq.apply(x, tp, dim)


# ---------------------------------------------------------------------------
# decode on a mesh: caches sharded by sequence or by KV head
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CacheShard:
    """Where a rank's share of a layer's KV cache lies
    (``launch/sharding.py:kv_shard`` reads it off the cache's placement):
    the first position it holds (``start``) of the whole cache's
    ``total``; the process groups its positions are split over, one a
    mesh axis of more than one rank (``groups``: the reductions of
    split-K attention; none where the rank holds every position); and
    under ``cache_shard="heads"`` the KV heads [c0, c1) it holds
    (``heads``; None: every KV head).  One device holds the whole cache:
    ``CacheShard(total=S)``."""

    start: int = 0
    total: int = 0
    groups: Tuple[Any, ...] = ()
    heads: Optional[Tuple[int, int]] = None


def seq_max(shard: CacheShard, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a shard's partial) as its maximum over the ranks that split
    the cache's positions (no gradient)."""
    for group in shard.groups:
        t = all_reduce(t, group, dist.ReduceOp.MAX)
    return t


def seq_sum(shard: CacheShard, t: torch.Tensor) -> torch.Tensor:
    """``t`` (a shard's partial) summed over the ranks that split the
    cache's positions (no gradient)."""
    for group in shard.groups:
        t = all_reduce(t, group)
    return t


def rank_heads(cfg, tp: Optional[TensorParallel]) -> Tuple[int, int, int,
                                                           int]:
    """This rank's query heads [q0, q1) and the KV heads [k0, k1) they read
    (:func:`head_ranges`; every head on one device)."""
    if tp is None:
        return 0, cfg.num_heads, 0, cfg.num_kv_heads
    return head_ranges(cfg.num_heads, cfg.num_kv_heads, tp.size, tp.rank)


def gather_ranges(tp: Optional[TensorParallel], x: torch.Tensor, dim: int,
                  ranges) -> torch.Tensor:
    """Every rank's ``x``, its part [a, b) of a dimension (``ranges``: each
    rank's of the model axis, in rank order, neither bound decreasing from
    one rank to the next, together covering [0, n): uneven, shared or
    empty parts), gathered whole along ``dim``, each index taken from the
    first rank that holds it: one all-gather of the parts padded to the
    widest, then slices (no index tensor: nothing is copied from the
    host).  No gradient."""
    if _no_op(tp):
        return x
    width = max(b - a for a, b in ranges)
    if x.shape[dim] < width:
        pad = list(x.shape)
        pad[dim] = width - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    whole = all_gather_dim(x, dim, tp.group, tp.size)
    runs, done = [], 0  # [offset into the gather, length]; indices taken
    for r, (a, b) in enumerate(ranges):
        if b <= done:
            continue
        if a > done:
            raise ValueError(f"ranges {ranges} leave [{done}, {a}) out")
        at = r * width + done - a
        if runs and runs[-1][0] + runs[-1][1] == at:
            runs[-1][1] += b - done
        else:
            runs.append([at, b - done])
        done = b
    parts = [whole.narrow(dim, at, n) for at, n in runs]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts,
                                                                   dim)


def gather_heads(tp: Optional[TensorParallel], cfg, x: torch.Tensor,
                 kv: bool = False) -> torch.Tensor:
    """A projection of this rank's heads, [B, heads, S, D], gathered over
    the model axis into every head (``kv``: the KV heads, each taken once
    where several ranks compute it)."""
    if _no_op(tp):
        return x
    lo = 2 if kv else 0
    ranges = [head_ranges(cfg.num_heads, cfg.num_kv_heads, tp.size,
                          r)[lo:lo + 2] for r in range(tp.size)]
    return gather_ranges(tp, x, 1, ranges)


def own_heads(tp: Optional[TensorParallel], cfg,
              x: torch.Tensor) -> torch.Tensor:
    """Every query head's [B, Hq, ...] cut back to this rank's heads."""
    if _no_op(tp):
        return x
    q0, q1, _, _ = rank_heads(cfg, tp)
    return x[:, q0:q1]


def gather_vocab(tp: Optional[TensorParallel], logits: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """The vocab-parallel logits (this rank's columns of the ``vocab``
    entries, :func:`partition`'s share) gathered whole along their last
    dimension (no gradient)."""
    if _no_op(tp):
        return logits
    ranges = [partition(vocab, tp.size, r) for r in range(tp.size)]
    return gather_ranges(tp, logits, logits.dim() - 1, ranges)
