"""Int8 gradient compression with error feedback (the data-parallel
reduction across pods).

The counterpart of ``repro/train/grad_compression.py``, with the same
names and arithmetic.  Inter-pod bandwidth is the expensive kind, so the
gradient bytes that cross the ``pod`` axis are the ones worth compressing:

    g_eff = g + error                        (error feedback carry)
    q     = int8_quantize(g_eff)             per-tensor absmax scale
    G     = reduce-scatter(q) via all_to_all int8 on the wire both hops
    error = g_eff - dequant(q)               (local residual)

Where the JAX package runs inside ``shard_map`` over a mesh axis name, the
port takes a ``torch.distributed`` process group (a mesh axis's group,
``mesh.get_group("pod")``); its size is ``n_dev``.  The reduce-scatter is
an ``all_to_all_single`` of int8 chunks and an ``all_gather`` of the
scales, then an f32 sum over the peers, a requantization of this rank's
chunk, and an int8 ``all_gather`` back: 2 bytes an element on the wire
where an f32 ring all-reduce puts 8.

``with_error_feedback`` computes each leaf's residual with that leaf's own
scale, while the wire quantizes the concatenated tree with one scale: the
carried residual is not the wire's own error.  That is the reference's
semantics, kept here (``ROADMAP.md`` §3).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.train.optimizer import tree_leaves, tree_map


def quantize_per_tensor(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, the f32 scale absmax / 127); round half to even,
    ``x / scale`` a true division, as ``jnp.round(x / scale)``."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_per_tensor(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _all_gather(t: torch.Tensor, group, n_dev: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, stacked in rank order: [n_dev,
    *t.shape] (``all_gather`` into the rows: PyTorch 2.11 and 2.13 both
    take it, where the single-tensor form is deprecated in 2.13)."""
    out = torch.empty((n_dev,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


def _compressed_allreduce_flat(x: torch.Tensor, group, n_dev: int
                               ) -> torch.Tensor:
    """All-reduce-mean of a flat f32 vector over ``group`` with an int8 wire
    format: zero-pad to a multiple of ``n_dev`` and view as [n_dev, chunk];
    one absmax scale over the whole padded local vector; row j goes to
    rank j (``all_to_all_single``: row j of what arrives is rank j's row
    for this rank), the scales are gathered; the f32 sum over the peers
    divided by ``n_dev``; this rank's chunk requantized and gathered back
    with its scale; dequantized, the pad stripped."""
    pad = (-x.numel()) % n_dev
    xp = torch.nn.functional.pad(x, (0, pad)).reshape(n_dev, -1)
    q, scale = quantize_per_tensor(xp)
    q_recv = torch.empty_like(q)
    dist.all_to_all_single(q_recv, q, group=group)  # [n_dev, chunk]
    scales = _all_gather(scale, group, n_dev)  # [n_dev]
    partial = torch.sum(q_recv.to(torch.float32) * scales[:, None],
                        dim=0) / n_dev
    q2, s2 = quantize_per_tensor(partial)
    q_all = _all_gather(q2, group, n_dev)  # [n_dev, chunk]
    s_all = _all_gather(s2, group, n_dev)  # [n_dev]
    full = (q_all.to(torch.float32) * s_all[:, None]).reshape(-1)
    return full[:x.numel()]


def compressed_psum_mean(grads, group, n_dev: int):
    """The tree's compressed all-reduce-mean over ``group`` (``n_dev``
    ranks): its leaves, in order, concatenated as f32, reduced, and split
    back into f32 leaves of their shapes."""
    flat = tree_leaves(grads)
    cat = torch.cat([g.to(torch.float32).reshape(-1) for g in flat])
    red = _compressed_allreduce_flat(cat, group, n_dev)
    pieces = iter(torch.split(red, [g.numel() for g in flat]))
    return tree_map(lambda g: next(pieces).reshape(g.shape), grads)


def with_error_feedback(grads, error_state):
    """The carry before compression -> (g_eff, new_error): g_eff = grads +
    error in f32, and each leaf's residual g_eff - dequant(quant(g_eff))
    with its own scale."""
    g_eff = tree_map(lambda g, e: g.to(torch.float32) + e, grads, error_state)

    def residual(g):
        q, s = quantize_per_tensor(g)
        return g - dequantize_per_tensor(q, s)

    return g_eff, tree_map(residual, g_eff)


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
