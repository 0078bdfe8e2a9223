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
A leaf with int8 moments is updated whole rows at a time, at most
:data:`UPDATE_PART` elements a part: its f32 moments, their update and the
step live only for one part (a leaf's math is elementwise and its scales
are per row, so the numbers are the same bits as a whole-leaf update).
Updated whole, dbrx-132b's [16, 6144, 10752] expert stacks held four or
more f32 copies of a 4.2 GB leaf at once, past one card beside the
masters and gradients.

On a mesh (``launch/train.py``) the update runs on each rank's local
shards, given ``layouts``: a tree laid out as the params holding each
leaf's ``launch.sharding.Sharding``.  The global norm is then one sum over
every rank's shards, all-reduced, each shard's sum divided by its number
of replicas so that a replicated leaf counts once; an int8 moment's row
absmax is all-reduced (max) over the ranks that share the row, where the
last axis is sharded.
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


def quantize(x: torch.Tensor, layout=None) -> QTensor:
    """Row absmax int8; ``layout`` (a local shard's ``Sharding``) takes
    each row's absmax over the ranks that share the row."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    if layout is not None:
        amax = layout.reduce_last_axis_max(amax)
    scale = (amax / 127.0).clamp_min(1e-12)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return QTensor(q=q, scale=scale, shape=tuple(x.shape))


def dequantize(t: QTensor) -> torch.Tensor:
    return t.q.float() * t.scale[..., None]


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
    int8 moments are replaced by their new quantization.  ``layouts``:
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
        if (isinstance(mu, QTensor) and layout is None
                and p.numel() > UPDATE_PART and p.is_contiguous()):
            return update_in_parts(p, g, mu, nu, shape)
        return update_whole(p, g, mu, nu, shape, layout)

    def update_in_parts(p, g, mu, nu, shape):
        """The leaf's rows in parts of at most UPDATE_PART elements, each
        through update_whole; its moments reassembled."""
        last = p.shape[-1]
        rows = p.numel() // last
        step_rows = max(1, UPDATE_PART // last)
        p2, g2 = p.view(rows, last), g.reshape(rows, last)
        new = [QTensor(q=torch.empty_like(m.q), scale=torch.empty_like(
            m.scale), shape=m.shape) for m in (mu, nu)]
        for r0 in range(0, rows, step_rows):
            r1 = min(rows, r0 + step_rows)
            part = [QTensor(q=m.q.reshape(rows, last)[r0:r1],
                            scale=m.scale.reshape(rows)[r0:r1],
                            shape=(r1 - r0, last)) for m in (mu, nu)]
            for out, m in zip(new, update_whole(p2[r0:r1], g2[r0:r1],
                                                *part, shape, None)):
                out.q.view(rows, last)[r0:r1] = m.q
                out.scale.view(rows)[r0:r1] = m.scale
        return tuple(new)

    def update_whole(p, g, mu, nu, shape, layout):
        quantized = isinstance(mu, QTensor)
        mu_f = dequantize(mu) if quantized else mu
        nu_f = dequantize(nu) ** 2 if quantized else nu
        if quantized:
            mu_f = b1 * mu_f + (1 - b1) * g
            nu_f = b2 * nu_f + (1 - b2) * g * g
        else:  # the same arithmetic, in the state's own tensors
            mu_f.mul_(b1).add_((1 - b1) * g)
            nu_f.mul_(b2).add_((1 - b2) * g * g)
        upd = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps)
        if len(shape) >= 2:  # decoupled weight decay on matrices only
            upd = upd + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * upd).to(p.dtype))
        if quantized:
            return (quantize(mu_f, layout),
                    quantize(torch.sqrt(nu_f), layout))
        return mu_f, nu_f

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
