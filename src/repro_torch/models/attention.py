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
"""

from __future__ import annotations

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
                       tp: Optional[common.TensorParallel] = None
                       ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (from
    :func:`encode_memory_kv`): x [B, S, d_model], non-causal, S == 1 in a
    decode step."""
    x = common.tp_in(tp, x)
    B, S, _ = x.shape
    q = x @ params["wq"].to(x.dtype)
    if cfg.qkv_bias:
        q = q + params["bq"].to(x.dtype)
    q = q.reshape(B, S, _heads(params, cfg, "wq"),
                  cfg.head_dim).transpose(1, 2)
    k, v = memory_kv
    out = _attend(q, k, v, False, cfg.attention_impl)
    out = out.transpose(1, 2).reshape(B, S, -1)
    return common.tp_out(tp, out @ params["wo"].to(x.dtype))


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
               dtype: torch.dtype = torch.bfloat16) -> KVCache:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=0)


def attn_decode_step(params: dict, cfg: ModelConfig, cache: KVCache,
                     x: torch.Tensor, rope: bool = True
                     ) -> tuple[KVCache, torch.Tensor]:
    """One-token decode: x [B, 1, d_model]; writes the token's K and V into
    the cache at ``length`` (in place) and attends over the valid prefix."""
    B = x.shape[0]
    pos = cache.length  # position of the incoming token
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, positions, rope=rope)
    cache.k[:, :, pos] = k_new[:, :, 0].to(cache.k.dtype)
    cache.v[:, :, pos] = v_new[:, :, 0].to(cache.v.dtype)
    out = kref.decode_attention(q, cache.k, cache.v, pos + 1)
    out = out.transpose(1, 2).reshape(B, 1, -1)
    y = out @ params["wo"].to(x.dtype)
    return KVCache(k=cache.k, v=cache.v, length=pos + 1), y
