"""Grouped-query attention layer: the prefill path and the cached decode
path.

The prefill path reaches the hand-written flash-attention kernel through
``kernels.ops.flash_attention`` (``cfg.attention_impl``).  The decode path
attends with the plain ``kernels.ref.decode_attention``, as the JAX package
does (it has no Pallas decode kernel).  Cross-attention (the enc-dec
decoder) reaches the flash kernel, non-causal, in the prefill and in every
decode step (one query row against the encoder's K/V), as in the JAX
package.

The KV cache is bf16 whatever ``cfg.dtype`` is, as in the JAX package.
Where the JAX package writes the new token's K and V with
``dynamic_update_slice`` into a new cache, the port writes them into the
cache's tensors in place; the returned :class:`KVCache` shares them.

On a mesh (``tp``, ``common.TensorParallel``) the layer is Megatron's:
``params`` hold this rank's heads (``common.head_ranges``): the q, k and v
columns of its query heads and of the KV heads they read, with the
biases' shards, and ``wo``'s rows of its query heads.  The input enters
the model axis (``common.tp_in``), flash attention runs on the local
heads, and the output of the row-parallel ``wo`` is summed over the ranks
(``common.tp_out``: an all-reduce, or a reduce-scatter over the sequence
under sequence parallelism).  The head counts are read off the
parameters' shapes, so one device is the case of one rank holding every
head.

A decode step on a mesh (:func:`attn_decode_step` with ``tp`` and a
``common.CacheShard``) runs on the rank's shard of the layer's cache:
split by sequence, each rank attends over its positions with every query
head and the split-K pieces of ``ref.decode_attention`` combine over the
sequence's ranks; split by KV head, each rank attends to its own.  The
cross-attention's memory split by sequence merges the flash kernel's
per-shard outputs by their log-sum-exps.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import common


class KVCache(NamedTuple):
    """Decode-time cache for one attention layer."""

    k: torch.Tensor  # [B, Hkv, S_max, D]
    v: torch.Tensor  # [B, Hkv, S_max, D]
    length: int  # tokens currently valid (a host int: no sync per layer)


def init_attn(generator: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> dict:
    dq = cfg.num_heads * cfg.head_dim
    dkv = cfg.num_kv_heads * cfg.head_dim
    params = {
        "wq": common.dense_init(generator, cfg.d_model, dq, dtype),
        "wk": common.dense_init(generator, cfg.d_model, dkv, dtype),
        "wv": common.dense_init(generator, cfg.d_model, dkv, dtype),
        "wo": common.dense_init(generator, dq, cfg.d_model, dtype),
    }
    if cfg.qkv_bias:
        dev = generator.device
        params["bq"] = torch.zeros((dq,), dtype=dtype, device=dev)
        params["bk"] = torch.zeros((dkv,), dtype=dtype, device=dev)
        params["bv"] = torch.zeros((dkv,), dtype=dtype, device=dev)
    return params


def _heads(params: dict, cfg: ModelConfig, name: str) -> int:
    """The heads a projection's columns hold (all of them on one
    device)."""
    return params[name].shape[-1] // cfg.head_dim


def _attend(q, k, v, causal: bool, impl: str) -> torch.Tensor:
    """Flash attention over the local heads; a rank that holds no query
    head (more ranks than a GQA group splits into) attends to nothing."""
    if q.shape[1] == 0:
        return q
    return kops.flash_attention(q, k, v, causal=causal, impl=impl)


def _project_qkv(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor], rope: bool = True):
    """x [B, S, d_model] -> q [B, Hq, S, D], k and v [B, Hkv, S, D].  v (and
    q, k without RoPE) are transposed views of the projections, not copies;
    the flash kernel reads them through their strides."""
    B, S, _ = x.shape
    hq, hkv = _heads(params, cfg, "wq"), _heads(params, cfg, "wk")
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    q = q.reshape(B, S, hq, cfg.head_dim).transpose(1, 2)
    k = k.reshape(B, S, hkv, cfg.head_dim).transpose(1, 2)
    v = v.reshape(B, S, hkv, cfg.head_dim).transpose(1, 2)
    if rope and positions is not None:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                 causal: bool = True,
                 positions: Optional[torch.Tensor] = None,
                 rope: bool = True,
                 tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """Full-sequence attention (prefill). x: [B, S, d_model] (on a mesh
    under sequence parallelism: this rank's share of S)."""
    x = common.tp_in(tp, x)
    B, S, _ = x.shape
    if positions is None and rope:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, cfg, x, positions, rope=rope)
    out = _attend(q, k, v, causal, cfg.attention_impl)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return common.tp_out(tp, out @ params["wo"].to(x.dtype))


def cross_attn_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                       memory_kv: tuple,
                       tp: Optional[common.TensorParallel] = None,
                       shard: Optional[common.CacheShard] = None
                       ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (from
    :func:`encode_memory_kv`): x [B, S, d_model], non-causal, S == 1 in a
    decode step.

    ``shard``: the K/V are a decode state's shards (``cross_k`` and
    ``cross_v``).  Split by sequence (``shard.groups``), each rank runs
    the flash kernel with its log-sum-exp (``kernels.ops.
    flash_attention_lse``) on its frames with every query head (gathered
    over the model axis), and the partial outputs are combined by their
    log-sum-exps over the sequence's ranks: the kernel normalises inside
    its tiles, so the combine is of normalised outputs
    (``kernels.ops.combine_lse``).  A rank that
    holds every frame attends with its own heads."""
    x = common.tp_in(tp, x)
    B, S, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(B, S, _heads(params, cfg, "wq"),
                  cfg.head_dim).transpose(1, 2)
    k, v = memory_kv
    if shard is None or not shard.groups:
        k, v = _own_kv(cfg, tp, shard, k), _own_kv(cfg, tp, shard, v)
        out = _attend(q, k, v, False, cfg.attention_impl)
    else:
        q_all = common.gather_heads(tp, cfg, q)
        o, lse = kops.flash_attention_lse(q_all, k, v, causal=False,
                                          impl=cfg.attention_impl)
        o = kops.combine_lse(o, lse, functools.partial(common.seq_max, shard),
                             functools.partial(common.seq_sum, shard))
        out = common.own_heads(tp, cfg, o)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return common.tp_out(tp, out @ params["wo"].to(x.dtype))


def _own_kv(cfg: ModelConfig, tp: Optional[common.TensorParallel],
            shard: Optional[common.CacheShard],
            t: torch.Tensor) -> torch.Tensor:
    """The KV heads this rank's query heads read, of the KV heads a cache
    shard holds (every one, or [c0, c1) under ``cache_shard="heads"``)."""
    if shard is None:
        return t
    _, _, k0, k1 = common.rank_heads(cfg, tp)
    c0 = 0 if shard.heads is None else shard.heads[0]
    if (k0 - c0, k1 - c0) == (0, t.shape[1]):
        return t
    return t[:, k0 - c0:k1 - c0]


def encode_memory_kv(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                     tp: Optional[common.TensorParallel] = None):
    """Project the encoder's output once into cross-attention K and V,
    [B, Hkv, S_enc, D] each: transposed views of the projections, which
    the flash kernel reads through their strides.  On a mesh, the KV heads
    of this rank's query heads, the memory entering the model axis."""
    memory = common.tp_in(tp, memory)
    B, S, _ = memory.shape
    hkv = _heads(params, cfg, "wk")
    k = memory @ params["wk"].to(memory.dtype)
    v = memory @ params["wv"].to(memory.dtype)
    if cfg.qkv_bias:
        k = k + params["bk"].to(memory.dtype)
        v = v + params["bv"].to(memory.dtype)
    k = k.reshape(B, S, hkv, cfg.head_dim).transpose(1, 2)
    v = v.reshape(B, S, hkv, cfg.head_dim).transpose(1, 2)
    return k, v


# ---------------------------------------------------------------------------
# decode path
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int, device,
               dtype: torch.dtype = torch.bfloat16,
               place=None) -> KVCache:
    """An empty cache of ``batch`` rows.  ``place(name, shape, dtype,
    value)`` (on a mesh, ``launch/train.py:MeshModel``) allocates each
    tensor as the rank's shard of it instead of whole."""
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if place is not None:
        return KVCache(k=place("k", shape, dtype, None),
                       v=place("v", shape, dtype, None), length=0)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def attn_decode_step(params: dict, cfg: ModelConfig, cache: KVCache,
                     x: torch.Tensor, rope: bool = True,
                     tp: Optional[common.TensorParallel] = None,
                     shard: Optional[common.CacheShard] = None
                     ) -> tuple[KVCache, torch.Tensor]:
    """One-token decode: x [B, 1, d_model]; writes the token's K and V into
    the cache at ``length`` (in place) and attends over the valid prefix.
    A write past the cache raises ``IndexError``.

    On a mesh ``cache`` holds this rank's shard of the layer's cache
    (``shard`` says which).  The rank projects its heads.

    * Split by sequence (``cache_shard="seq"``): the new K and V are
      gathered over the model axis (each KV head once) and written by the
      rank that holds position ``length`` alone.  Each rank attends over
      its positions with every query head (gathered over the model axis),
      and the split-K pieces of ``ref.decode_attention`` combine over the
      sequence's ranks (``shard.groups``): the row max and the sum of
      exponentials reduced first, two [B, Hq] all-reduces, then each rank
      normalises its probabilities, casts them to the cache's dtype as the
      JAX oracle does and takes its P·V partial in f32, summed by one
      [B, Hq, D] all-reduce.  The output is cut back to the rank's heads.
    * By KV head (``cache_shard="heads"``, or positions the guard left
      whole): the rank holds every position; it attends with its own query
      heads on their KV heads, with no reduction.  Where it holds KV heads
      it does not compute (the guard replicated them) it writes the
      gathered ones."""
    x = common.tp_in(tp, x)
    B = x.shape[0]
    pos = cache.length  # position of the incoming token
    shard = shard or common.CacheShard(total=cache.k.shape[2])
    if pos >= shard.total:
        raise IndexError(f"decode position {pos} is past the cache's "
                         f"{shard.total} positions")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions, rope=rope)
    _, _, k0, k1 = common.rank_heads(cfg, tp)
    c0, c1 = shard.heads or (0, cfg.num_kv_heads)
    if (c0, c1) != (k0, k1):  # it holds KV heads it does not compute
        k_new = common.gather_heads(tp, cfg, k_new, kv=True)[:, c0:c1]
        v_new = common.gather_heads(tp, cfg, v_new, kv=True)[:, c0:c1]
    held = cache.k.shape[2]
    local = pos - shard.start
    if 0 <= local < held:
        cache.k[:, :, local] = k_new[:, :, 0].to(cache.k.dtype)
        cache.v[:, :, local] = v_new[:, :, 0].to(cache.v.dtype)
    n = min(max(pos + 1 - shard.start, 0), held)
    if not shard.groups:
        k = _own_kv(cfg, tp, shard, cache.k)
        v = _own_kv(cfg, tp, shard, cache.v)
        out = q if q.shape[1] == 0 else kref.decode_attention(q, k, v, n)
    else:
        q_all = common.gather_heads(tp, cfg, q)
        scores = kref.decode_scores(q_all, cache.k, n)
        m = common.seq_max(shard, kref.decode_max(scores))
        e = kref.decode_exp(scores, m)
        total = common.seq_sum(shard, e.sum(dim=-1))
        o = common.seq_sum(shard, kref.decode_pv(e, total, cache.v))
        out = common.own_heads(tp, cfg, o.reshape(q_all.shape).to(q.dtype))
    out = out.transpose(1, 2).reshape(B, 1, -1)
    y = common.tp_out(tp, out @ params["wo"].to(x.dtype))
    return KVCache(k=cache.k, v=cache.v, length=pos + 1), y
