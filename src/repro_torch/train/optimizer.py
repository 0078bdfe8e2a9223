"""AdamW with f32 math, and optional int8 row-quantized moments.

The counterpart of ``repro/train/optimizer.py``: the same schedule, clip,
update and quantization, as functions over trees of tensors (dicts, lists
and tuples; :class:`QTensor` and :class:`AdamState` are leaves and nodes as
they are there).  Trees are walked with dict keys sorted, as ``jax.tree``
walks them, so the global norm sums its leaves in the JAX package's order.

The int8 moments (one absmax scale per row of the last axis, the second
moment stored in the sqrt domain) are the JAX package's: see its module
for why rows and why the sqrt.  ``torch.round`` and ``jnp.round`` both
round half to even.

Where the JAX package decides on a leaf's shape (weight decay on leaves of
two or more dimensions; int8 moments for :func:`quantizable` shapes), its
leaves are the stacked ones: a layer's norm scale is a [L, d] leaf there.
:func:`update` and :func:`init` take ``shapes``, a tree laid out as the
params holding the shape to decide on (``convert.reference_shapes``), so
the port's per-layer tree is updated as the JAX package updates its own;
without it a leaf's own shape decides.

:func:`update` writes the new parameters and moments into the given
tensors in place, under ``torch.no_grad()``: at llama3-8b's 8 layers the
f32 masters and two moments are 33.5 GB, which a functional update would
hold twice.  The returned parameter tree and state hold the same tensors.
Every leaf with int8 moments is updated whole rows at a time, at most
:data:`UPDATE_PART` elements a part (a smaller leaf is one part): its f32
moments, their update and the step live only for one part, and the new
payloads and row scales are written into the moments' own rows (a leaf's
math is elementwise and its scales are per row, so the numbers are the
same bits as a whole-leaf update).  Updated whole, dbrx-132b's [16, 6144,
10752] expert stacks held four or more f32 copies of a 4.2 GB leaf at
once, past one card beside the masters and gradients.

On a mesh (``launch/train.py``) the update runs on each rank's local
shards, given ``layouts``: a tree laid out as the params holding each
leaf's ``launch.sharding.Sharding``.  The global norm is then one sum over
every rank's shards, all-reduced, each shard's sum divided by its number
of replicas so that a replicated leaf counts once; an int8 moment's row
absmax is all-reduced (max) over the ranks that share the row, where the
last axis is sharded, one all-reduce a part and moment.  Every rank of
such a group cuts the same parts (:func:`part_rows`), so they make the
same all-reduces in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple

import torch
import torch.distributed as dist

#: the JAX package's quantization threshold: leaves of at least this many
#: elements (and two dimensions) get int8 moments
Q_MIN_SIZE = 65536
#: the most elements of a leaf with int8 moments that one part of the
#: update takes (whole rows of its last axis; 256 MB of f32 a temporary)
UPDATE_PART = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moments_dtype: str = "fp32"  # fp32 | int8


class QTensor(NamedTuple):
    """Row-quantized tensor: int8 payload (parameter-shaped) and per-row
    f32 absmax scales (last axis reduced).  In a checkpoint its leaves are
    named ``.qv`` and ``.qscale``, as the JAX package registers them."""

    q: torch.Tensor  # int8, shape == original shape
    scale: torch.Tensor  # f32, shape[:-1]
    shape: tuple  # the original shape (not a leaf)


class AdamState(NamedTuple):
    step: torch.Tensor  # [] int32
    mu: Any  # tree of f32 tensors or QTensors
    nu: Any


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------
def _is_leaf(x) -> bool:
    return isinstance(x, QTensor) or not isinstance(x, (dict, list, tuple))


def tree_leaves(tree) -> List[Any]:
    """Leaves in the JAX package's order: dict keys sorted, sequences in
    order; a QTensor is one leaf here."""
    if _is_leaf(tree):
        return [tree]
    items = ([tree[k] for k in sorted(tree)] if isinstance(tree, dict)
             else list(tree))
    return [leaf for item in items for leaf in tree_leaves(item)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves (or
    subtrees, where ``rest`` has a leaf there) of ``rest``, called in
    :func:`tree_leaves`' order."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    out = [tree_map(fn, t, *(r[i] for r in rest))
           for i, t in enumerate(tree)]
    if isinstance(tree, tuple):
        return type(tree)(*out) if hasattr(tree, "_fields") else tuple(out)
    return out


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------
def quantizable(shape) -> bool:
    return math.prod(shape) >= Q_MIN_SIZE and len(shape) >= 2


def quantize(x: torch.Tensor, layout=None, out=None) -> QTensor:
    """Row absmax int8; ``layout`` (a local shard's ``Sharding``) takes
    each row's absmax over the ranks that share the row; ``out`` (a
    QTensor of ``x``'s shape) takes the payload and row scales in place."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if layout is not None:
        amax = layout.reduce_last_axis_max(amax)
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127)
    if out is None:
        return QTensor(q=q.to(torch.int8), scale=scale, shape=tuple(x.shape))
    out.q.copy_(q)
    out.scale.copy_(scale)
    return out


def dequantize(t: QTensor) -> torch.Tensor:
    return t.q.float() * t.scale[..., None]


def part_rows(local_shape) -> tuple:
    """(rows, last, rows a part) of a leaf's local shard: its rows of the
    last axis, taken in parts of whole rows of at most UPDATE_PART
    elements.  On a mesh each part's row maxima are all-reduced over the
    ranks that share its rows, so they must all cut the same parts: they
    do, as every rank's local shape is the global shape over its layout's
    ``shard_counts``.  That rests on even shards
    (``sharding.to_named_sharding`` replicates a dimension that does not
    divide); an uneven sharding would break it."""
    last = local_shape[-1]
    return math.prod(local_shape[:-1]), last, max(1, UPDATE_PART // last)


def _row_view(t: torch.Tensor, shape, *dims) -> torch.Tensor:
    """``t`` viewed as ``dims`` without a copy, so that a part written
    through the view lands in ``t`` itself; raises ``ValueError`` with
    the leaf's shape where ``t``'s strides allow no such view."""
    try:
        return t.view(*dims)
    except RuntimeError:
        raise ValueError(
            f"the leaf of shape {tuple(shape)} (local {tuple(t.shape)}, "
            f"strides {t.stride()}) cannot be updated in parts of rows in "
            f"place") from None


def _zeros_moment(p: torch.Tensor, shape, cfg: OptimizerConfig):
    zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    if cfg.moments_dtype == "int8" and quantizable(shape):
        return quantize(zeros)
    return zeros


def init(params, cfg: OptimizerConfig, shapes=None) -> AdamState:
    """Zero moments (int8 where ``quantizable`` of the leaf's shape in
    ``shapes``, default its own) and step 0."""
    shapes = shapes if shapes is not None else tree_map(
        lambda p: tuple(p.shape), params)
    dev = tree_leaves(params)[0].device
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(lambda p, s: _zeros_moment(p, s, cfg), params, shapes),
        nu=tree_map(lambda p, s: _zeros_moment(p, s, cfg), params, shapes))


# ---------------------------------------------------------------------------
# schedule and clipping
# ---------------------------------------------------------------------------
def schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; f32 on the
    step's device."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = ((step - cfg.warmup_steps)
            / max(1.0, cfg.decay_steps - cfg.warmup_steps)).clamp(0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm,
                                           cos)


def global_norm(tree, layouts=None) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX order) of each leaf's f32 sum of
    squares.  With ``layouts`` the leaves are local shards: each one's sum
    is divided by its replicas and the total all-reduced over the mesh
    (which spans every rank)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if layouts is None:
        return torch.sqrt(torch.sum(torch.stack(sums)))
    total = torch.sum(torch.stack([
        s / lay.replicas for s, lay in zip(sums, tree_leaves(layouts))]))
    dist.all_reduce(total)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * factor.to(g.dtype), grads), norm


# ---------------------------------------------------------------------------
# the update
# ---------------------------------------------------------------------------
@torch.no_grad()
def update(grads, state: AdamState, params, cfg: OptimizerConfig,
           shapes=None, layouts=None):
    """One AdamW step -> (params, state, metrics ``grad_norm``, ``lr``).

    The JAX package's arithmetic: gradients in f32, clipped by the global
    norm; bias-corrected moments; decoupled weight decay on leaves whose
    shape in ``shapes`` (default: their own) has two or more dimensions;
    the new parameter rounded once to its dtype.  Parameters and f32
    moments are updated in place, and f32 gradients are clipped in place;
    int8 moments are requantized into their own payloads and row scales
    (:func:`part_rows`' parts, with ``layouts`` or without).  ``layouts``:
    the leaves are local shards on a mesh (see the module's docstring)."""
    grads = tree_map(lambda g: g.float(), grads)
    gnorm = global_norm(grads, layouts)
    if cfg.grad_clip_norm > 0:  # in place: f32 gradients may be the caller's
        factor = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
        for g in tree_leaves(grads):
            g.mul_(factor)
    shapes = shapes if shapes is not None else tree_map(
        lambda p: tuple(p.shape), params)
    layouts = layouts if layouts is not None else tree_map(
        lambda p: None, params)

    step = state.step + 1
    lr = schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(b1, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=stepf.device), stepf)

    def leaf_update(p, g, mu, nu, shape, layout):
        if isinstance(mu, QTensor):
            update_int8(p, g, mu, nu, shape, layout)
        else:  # the f32 moments in place
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * g * g)
            step_param(p, mu, nu, shape)
        return mu, nu

    def update_int8(p, g, mu, nu, shape, layout):
        """The leaf's rows in parts (part_rows), each one's moments
        dequantized, updated, applied and requantized into the moments'
        own rows; on a mesh the row maxima all-reduced a part at a
        time."""
        rows, last, per_part = part_rows(tuple(p.shape))
        p2, g2 = (_row_view(t, shape, rows, last) for t in (p, g))
        views = [(_row_view(m.q, shape, rows, last),
                  _row_view(m.scale, shape, rows)) for m in (mu, nu)]
        for r0 in range(0, rows, per_part):
            r1 = min(rows, r0 + per_part)
            m, n = [QTensor(q=q[r0:r1], scale=sc[r0:r1], shape=(r1 - r0, last))
                    for q, sc in views]
            gp = g2[r0:r1]
            mu_f = b1 * dequantize(m) + (1 - b1) * gp
            nu_f = b2 * dequantize(n) ** 2 + (1 - b2) * gp * gp
            step_param(p2[r0:r1], mu_f, nu_f, shape)
            quantize(mu_f, layout, out=m)
            quantize(torch.sqrt(nu_f), layout, out=n)

    def step_param(p, mu_f, nu_f, shape):
        """p's step from its new f32 moments, rounded once to its
        dtype."""
        upd = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps)
        if len(shape) >= 2:  # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))

    moments = tree_map(leaf_update, params, grads, state.mu, state.nu,
                       shapes, layouts)

    def pick(tree, i):  # the parameter tree's nodes are dicts and lists
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        if isinstance(tree, list):
            return [pick(v, i) for v in tree]
        return tree[i]  # a leaf's (mu, nu)

    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamState(step=step, mu=pick(moments, 0),
                             nu=pick(moments, 1)), metrics
