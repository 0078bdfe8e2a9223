"""Encoder-decoder assembly (the seamless-m4t family).

The counterpart of ``repro/models/encdec.py``.  The speech frontend is a
stub, as in the JAX package: the encoder takes precomputed frame embeddings
[B, S_enc, frontend_dim].  Above it: a bidirectional encoder, a decoder
with causal self-attention and cross-attention, sinusoidal positions,
plain-GELU FFNs, LayerNorm and a tied unembedding over the padded
vocabulary.  Every attention (the encoder's, the decoder's self- and
cross-attention) reaches the flash kernel through ``kernels.ops``.

The JAX package scans stacked layers; here ``params["encoder"]`` and
``params["decoder"]`` are lists of per-layer dicts and the layer loops are
Python loops, as in ``models/transformer.py``.

On a mesh (``tp``) the encoder and decoder layers run their attention and
FFNs tensor-parallel (``models/attention.py``, ``models/ffn.py``), each
layer gathering its own shards; the frontend projection and the tied
vocab-parallel embedding are ``models/transformer.py``'s.  The JAX
package pins no sequence-parallel stream here, nor does the port.

Decode: per-layer self-attention KV caches, and the cross-attention K/V
computed once from the encoder memory (:class:`DecCache`).  Each step's
cross-attention is the flash kernel with one query row.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import (
    KVCache,
    attn_decode_step,
    attn_forward,
    cross_attn_forward,
    encode_memory_kv,
    init_attn,
    init_cache,
)
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.models.transformer import (embed_tokens, model_dtype,
                                            project_frontend, remat_call,
                                            unembed)


def init_enc_block(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    dev = generator.device
    return {
        "norm_attn": common.init_norm(cfg.norm, cfg.d_model, dev),
        "attn": init_attn(generator, cfg, dtype),
        "norm_ffn": common.init_norm(cfg.norm, cfg.d_model, dev),
        "ffn": init_ffn(generator, cfg, dtype),
    }


def init_dec_block(generator: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype) -> dict:
    dev = generator.device
    return {
        "norm_self": common.init_norm(cfg.norm, cfg.d_model, dev),
        "self_attn": init_attn(generator, cfg, dtype),
        "norm_cross": common.init_norm(cfg.norm, cfg.d_model, dev),
        "cross_attn": init_attn(generator, cfg, dtype),
        "norm_ffn": common.init_norm(cfg.norm, cfg.d_model, dev),
        "ffn": init_ffn(generator, cfg, dtype),
    }


def init_model(generator: torch.Generator, cfg: ModelConfig,
               param_dtype: Optional[torch.dtype] = None) -> dict:
    """Parameters on the generator's device, drawn from it in a fixed
    order: embedding, frontend projection, encoder, decoder.  Matmul
    weights in ``param_dtype`` (default ``cfg.dtype``), norms f32 (see
    ``transformer.init_model``)."""
    dtype, dev = param_dtype or model_dtype(cfg), generator.device
    return {
        "embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dtype),
        "frontend_proj": common.dense_init(
            generator, cfg.frontend_dim or cfg.d_model, cfg.d_model, dtype),
        "encoder": [init_enc_block(generator, cfg, dtype)
                    for _ in range(cfg.enc_layers)],
        "decoder": [init_dec_block(generator, cfg, dtype)
                    for _ in range(cfg.num_layers)],
        "norm_enc": common.init_norm(cfg.norm, cfg.d_model, dev),
        "norm_out": common.init_norm(cfg.norm, cfg.d_model, dev),
    }


def encode(params: dict, cfg: ModelConfig, frontend: torch.Tensor,
           tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """frontend [B, S_enc, frontend_dim] -> memory [B, S_enc, d_model]."""
    dtype = model_dtype(cfg)
    x = project_frontend(params, cfg, frontend, tp)
    x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model,
                                        x.device).to(dtype)
    for block in params["encoder"]:
        x = remat_call(cfg, _enc_layer, block, cfg, x, tp)
    return common.apply_norm(common.layer(tp, params["norm_enc"]), x)


def _enc_layer(block: dict, cfg: ModelConfig, x: torch.Tensor,
               tp: Optional[common.TensorParallel] = None):
    block = common.layer(tp, block)
    a = common.apply_norm(block["norm_attn"], x)
    x = x + attn_forward(block["attn"], cfg, a, causal=False, rope=False,
                         tp=tp)
    f = common.apply_norm(block["norm_ffn"], x)
    return x + ffn_forward(block["ffn"], cfg, f, tp)


def _dec_layer(block: dict, cfg: ModelConfig, x: torch.Tensor,
               memory: torch.Tensor,
               tp: Optional[common.TensorParallel] = None):
    block = common.layer(tp, block)
    a = common.apply_norm(block["norm_self"], x)
    x = x + attn_forward(block["self_attn"], cfg, a, causal=True, rope=False,
                         tp=tp)
    c = common.apply_norm(block["norm_cross"], x)
    mem_kv = encode_memory_kv(block["cross_attn"], cfg, memory, tp)
    x = x + cross_attn_forward(block["cross_attn"], cfg, c, mem_kv, tp)
    f = common.apply_norm(block["norm_ffn"], x)
    return x + ffn_forward(block["ffn"], cfg, f, tp)


def decode_train(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                 tokens: torch.Tensor,
                 tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """Teacher-forced decoder pass -> logits [B, S_dec, V] (on a mesh this
    rank's columns of V)."""
    dtype = model_dtype(cfg)
    x = embed_tokens(params, dataclasses.replace(cfg, embed_scale=False),
                     tokens, dtype, tp)
    x = x + common.sinusoidal_positions(x.shape[1], cfg.d_model,
                                        x.device).to(dtype)
    for block in params["decoder"]:
        x = remat_call(cfg, _dec_layer, block, cfg, x, memory, tp)
    x = common.apply_norm(common.layer(tp, params["norm_out"]), x)
    return unembed(params, cfg, x, tp)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            frontend: torch.Tensor,
            tp: Optional[common.TensorParallel] = None):
    """Prefill: tokens [B, S] and frontend [B, S_enc, frontend_dim] ->
    (logits [B, S, V], aux = 0)."""
    memory = encode(params, cfg, frontend, tp)
    return (decode_train(params, cfg, memory, tokens, tp),
            torch.zeros((), dtype=torch.float32, device=memory.device))


# ---------------------------------------------------------------------------
# incremental decode
# ---------------------------------------------------------------------------
class DecCache(NamedTuple):
    self_kv: List[KVCache]  # one per decoder layer
    cross_k: List[torch.Tensor]  # [B, Hkv, S_enc, D] per layer, precomputed
    cross_v: List[torch.Tensor]


def _cross_kv(block, cfg: ModelConfig, memory: torch.Tensor,
              tp: Optional[common.TensorParallel] = None):
    """A decoder layer's cross K and V of ``memory``, every KV head; on a
    mesh the rank projects its heads' (the layer gathered here) and the
    KV heads are gathered over the model axis."""
    block = common.layer(tp, block)
    k, v = encode_memory_kv(block["cross_attn"], cfg, memory, tp)
    return (common.gather_heads(tp, cfg, k, kv=True),
            common.gather_heads(tp, cfg, v, kv=True))


def init_decode_state(params: dict, cfg: ModelConfig, memory: torch.Tensor,
                      batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      tp: Optional[common.TensorParallel] = None,
                      place=None) -> DecCache:
    """Project the memory into each layer's cross K/V once; allocate the
    self-attention caches (``dtype``, bf16 by default, as in JAX).

    On a mesh (``tp``, ``memory`` the rank's rows) each rank projects its
    heads' cross K/V over all frames, the KV heads are gathered over the
    model axis, and ``place(name, shape, dtype, value)`` lays each one out
    as the rank's shard (by sequence, or by KV head); the self caches are
    allocated as the rank's shards."""
    cross_k, cross_v = [], []
    for block in params["decoder"]:
        k, v = _cross_kv(block, cfg, memory, tp)
        if place is not None:
            k = place("cross_k", tuple(k.shape), k.dtype, k)
            v = place("cross_v", tuple(v.shape), v.dtype, v)
        cross_k.append(k)
        cross_v.append(v)
    return DecCache(
        self_kv=[init_cache(cfg, batch, max_len, memory.device, dtype, place)
                 for _ in params["decoder"]],
        cross_k=cross_k, cross_v=cross_v)


def _dec_layer_decode(block, cfg: ModelConfig, cache: KVCache, ck, cv,
                      x: torch.Tensor, tp, shards: dict):
    block = common.layer(tp, block)
    a = common.apply_norm(block["norm_self"], x)
    cache, y = attn_decode_step(block["self_attn"], cfg, cache, a,
                                rope=False, tp=tp, shard=shards.get("k"))
    x = x + y
    c = common.apply_norm(block["norm_cross"], x)
    x = x + cross_attn_forward(block["cross_attn"], cfg, c, (ck, cv), tp,
                               shards.get("cross_k"))
    f = common.apply_norm(block["norm_ffn"], x)
    return cache, x + ffn_forward(block["ffn"], cfg, f, tp)


def decode_step(params: dict, cfg: ModelConfig, state: DecCache,
                token: torch.Tensor,
                tp: Optional[common.TensorParallel] = None,
                shards: Optional[dict] = None):
    """token [B, 1] -> (state, logits [B, 1, V]).  The self-attention
    caches are written in place (see ``attention.attn_decode_step``).  On
    a mesh each layer gathers its shards and runs tensor-parallel on the
    rank's shards of the caches (``shards``: their geometry, ``"k"`` and
    ``"cross_k"``), and the logits are gathered whole for its rows."""
    dtype = model_dtype(cfg)
    x = embed_tokens(params, dataclasses.replace(cfg, embed_scale=False),
                     token, dtype, tp)
    # the incoming token's position: the caches' length, a host int
    pos = state.self_kv[0].length
    x = x + common.sinusoidal_at(pos, cfg.d_model, x.device).to(dtype)
    new_self = []
    for block, cache, ck, cv in zip(params["decoder"], state.self_kv,
                                    state.cross_k, state.cross_v):
        cache, x = _dec_layer_decode(block, cfg, cache, ck, cv, x, tp,
                                     shards or {})
        new_self.append(cache)
    x = common.apply_norm(common.layer(tp, params["norm_out"]), x)
    logits = common.gather_vocab(tp, unembed(params, cfg, x, tp),
                                 cfg.vocab_size)
    return state._replace(self_kv=new_self), logits
