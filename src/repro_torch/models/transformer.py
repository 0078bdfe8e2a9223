"""Decoder-only model assembly: the dense, MoE, SSM (Mamba-2) and hybrid
(Jamba) families:

    dense / moe : [norm -> attn -> +res] [norm -> ffn|moe -> +res]   x L
    ssm         : [norm -> mamba -> +res]                            x L
    hybrid      : super-blocks of `attn_layer_period` sublayers, one
                  attention sublayer per block (at `attn_layer_offset`),
                  the rest mamba, each followed by an FFN, or an MoE every
                  `moe_layer_period`-th sublayer (Jamba's 1:7 and 1:2)

The counterpart of those paths of ``repro/models/transformer.py``.  The
JAX package scans one stacked block (a hybrid super-block holds its
sublayers' parameters stacked inside); here ``params["blocks"]`` is a list
of per-layer parameter dicts, one per sublayer, and the layer loop is a
Python loop.  :func:`layer_plan` says what each layer holds.  A model with
a modality frontend (the VLM family, internvl2-1b) projects its
precomputed embeddings with ``frontend_proj`` and puts them before the
token embeddings.  The encoder-decoder family is ``models/encdec.py``.

Matmul weights and embeddings are stored in ``cfg.dtype`` by default
(serving).  The JAX package keeps f32 masters and casts them to
``cfg.dtype`` at every use; the cast rounds to nearest even either way, so
the numbers are the same, and a bf16 llama3-8b holds 16 GB on the card
instead of 32 GB plus a cast per layer per step.  Training asks for the
JAX package's f32 masters (``init_model(..., param_dtype=torch.float32)``):
every layer casts each weight to the activations' dtype where it uses it
(``.to(x.dtype)``), so one forward serves both storages.  Norm scales stay
f32.

On a mesh (``tp``, ``common.TensorParallel``) ``params`` hold each
layer's :class:`common.Shards`, and each layer gathers its own
(``common.layer``) inside its remat region, so the backward gathers again
rather than keeping the layer.  The embedding is vocab-parallel (this
rank's rows of the table: a masked lookup, summed over the model axis),
the unembedding gives this rank's columns of the logits (the loss takes
them vocab-sharded, ``common.cross_entropy``), a frontend's projection
its columns, gathered before the concatenation.  With
``cfg.sequence_parallel`` (where the sequence divides over the axis) the
residual stream between sublayers is this rank's share of the sequence:
the norms run on the share, each sublayer gathers the whole sequence on
entry and reduce-scatters its output.

With ``cfg.remat`` and autograd recording, each layer runs under
``torch.utils.checkpoint`` (:func:`remat_call`): the layer's activations
are recomputed in the backward, as the JAX package's ``jax.checkpoint``
of its scanned block does; ``remat_policy="dots"`` keeps the matmul
outputs instead of recomputing them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.attention import (
    KVCache,
    attn_decode_step,
    attn_forward,
    init_attn,
    init_cache,
)
from repro_torch.models.ffn import ffn_forward, init_ffn
from repro_torch.models.mamba2 import (
    MambaCache,
    init_mamba,
    init_mamba_cache,
    mamba_decode_step,
    mamba_forward,
)
from repro_torch.models.moe import init_moe, moe_forward

PORTED = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family neither package
    knows."""
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.arch_id}: unknown model family {cfg.family!r}; the port "
            f"builds {', '.join(PORTED)}")


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
def _layer_is_moe(cfg: ModelConfig, sub: int) -> bool:
    """The JAX package's rule, ``sub`` counted inside a hybrid super-block
    (every layer of an moe model has period 1)."""
    return cfg.is_moe and (sub % cfg.moe_layer_period
                           == cfg.moe_layer_period - 1)


def num_blocks(cfg: ModelConfig) -> int:
    """The JAX package's scanned blocks: hybrid super-blocks, or layers."""
    if cfg.is_hybrid:
        if cfg.num_layers % cfg.attn_layer_period:
            raise ValueError("hybrid num_layers must divide attn_layer_period")
        return cfg.num_layers // cfg.attn_layer_period
    return cfg.num_layers


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """Each layer's (mixer, feed-forward): mixer "attn" or "mamba",
    feed-forward "ffn", "moe" or "" (ssm).  A hybrid super-block's sublayer
    ``sub`` is attention where ``sub == attn_layer_offset``."""
    if cfg.family == "ssm":
        return [("mamba", "")] * cfg.num_layers
    if cfg.is_hybrid:
        period = cfg.attn_layer_period
        block = [("attn" if sub == cfg.attn_layer_offset else "mamba",
                  "moe" if _layer_is_moe(cfg, sub) else "ffn")
                 for sub in range(period)]
        return block * num_blocks(cfg)
    return [("attn", "moe" if cfg.is_moe else "ffn")] * cfg.num_layers


def mixer_norm_name(cfg: ModelConfig, mixer: str) -> str:
    """The JAX package's name of the norm before a layer's mixer:
    ``norm_attn`` before a dense or moe model's attention, ``norm_mix``
    before a mamba mixer or a hybrid's attention."""
    return "norm_attn" if mixer == "attn" and not cfg.is_hybrid \
        else "norm_mix"


def init_block(generator: torch.Generator, cfg: ModelConfig, mixer: str,
               ff: str, dtype: torch.dtype) -> dict:
    """One layer's parameters: a ``layer_plan`` entry's mixer and
    feed-forward, each after its norm; matmul weights in ``dtype``."""
    dev = generator.device
    block = {mixer_norm_name(cfg, mixer):
             common.init_norm(cfg.norm, cfg.d_model, dev)}
    block[mixer] = (init_attn(generator, cfg, dtype) if mixer == "attn"
                    else init_mamba(generator, cfg, dtype))
    if ff:
        block["norm_ffn"] = common.init_norm(cfg.norm, cfg.d_model, dev)
        block[ff] = (init_moe(generator, cfg, dtype) if ff == "moe"
                     else init_ffn(generator, cfg, dtype))
    return block


def _mixer_norm(block: dict) -> dict:
    return block["norm_attn"] if "norm_attn" in block else block["norm_mix"]


def _feed_forward(block: dict, cfg: ModelConfig, x: torch.Tensor,
                  tp: Optional[common.TensorParallel] = None):
    """The layer's FFN or MoE of its normed input -> (y, aux or None)."""
    h = common.apply_norm(block["norm_ffn"], x, tp=tp)
    if "moe" in block:
        return moe_forward(block["moe"], cfg, h, tp)
    return ffn_forward(block["ffn"], cfg, h, tp), None


def apply_block(block: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, ssd_impl: str = "auto",
                tp: Optional[common.TensorParallel] = None):
    """Full-sequence layer application -> (x, aux); aux is the MoE's
    load-balancing loss, 0 in a layer without one.  ``ssd_impl`` picks the
    SSD's implementation (``kernels.ops.ssd``) in a mamba layer.  On a
    mesh ``block`` is the layer's shards, gathered here."""
    block = common.layer(tp, block)
    h = common.apply_norm(_mixer_norm(block), x, tp=tp)
    if "mamba" in block:
        x = x + mamba_forward(block["mamba"], cfg, h, ssd_impl, tp)
    else:
        x = x + attn_forward(block["attn"], cfg, h, positions=positions,
                             rope=cfg.pos_embed == "rope", tp=tp)
    if "norm_ffn" in block:
        y, aux = _feed_forward(block, cfg, x, tp)
        x = x + y
        if aux is not None:
            return x, aux
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _save_matmuls(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of the weight matmuls (``x @ W`` reaches ``aten.mm`` /
    ``aten.addmm``), recompute the rest; the counterpart of
    ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` (the
    attention's batched products, ``aten.bmm``, are recomputed)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_call(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) where
    ``cfg.remat`` is set and autograd records; as it is otherwise (serving,
    decode, ``torch.no_grad()``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_matmuls)
                  if cfg.remat_policy == "dots" else None)
    if context_fn is None:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


# ---------------------------------------------------------------------------
# model init / forward
# ---------------------------------------------------------------------------
def init_model(generator: torch.Generator, cfg: ModelConfig,
               param_dtype: Optional[torch.dtype] = None) -> dict:
    """Parameters on the generator's device, drawn from it in a fixed
    order: embedding, blocks, unembedding, frontend projection.  Matmul
    weights and embeddings are stored in ``param_dtype`` (default
    ``cfg.dtype``; ``torch.float32`` gives the JAX package's f32 masters):
    each is drawn in f32 and cast, so the two storages hold the same draws."""
    require_ported(cfg)
    dtype, dev = param_dtype or model_dtype(cfg), generator.device
    params = {
        "embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dtype),
        "blocks": [init_block(generator, cfg, mixer, ff, dtype)
                   for mixer, ff in layer_plan(cfg)],
        "norm_out": common.init_norm(cfg.norm, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = common.embed_init(generator, cfg.vocab_size,
                                              cfg.d_model, dtype)
    if cfg.frontend_tokens:
        params["frontend_proj"] = common.dense_init(
            generator, cfg.frontend_dim or cfg.d_model, cfg.d_model, dtype)
    return params


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 dtype: torch.dtype,
                 tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """The tokens' embeddings; on a mesh this rank's rows of the table
    (``params["embed"]`` its shards) look up the tokens they hold, the
    others 0, summed over the model axis: the whole embedding on every
    rank."""
    if tp is None:
        x = params["embed"].to(dtype)[tokens.long()]
    else:
        table = common.layer(tp, params["embed"]).to(dtype)
        start = common.partition(cfg.vocab_size, tp.size, tp.rank)[0]
        local = tokens.long() - start
        owned = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)] * owned[..., None]
        x = common.reduce_replicated(tp, x)
    if cfg.embed_scale:
        # the scale is rounded to the activations' dtype first, as in JAX
        # (a 0-dim CPU tensor: no copy to the card)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor,
            tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """The logits of ``x``; on a mesh this rank's columns of them (its rows
    of the table), ``x`` entering the model axis."""
    table = common.layer(tp, params.get("unembed", params["embed"]))
    return common.tp_in(tp, x) @ table.to(x.dtype).T


def project_frontend(params: dict, cfg: ModelConfig, frontend: torch.Tensor,
                     tp: Optional[common.TensorParallel] = None
                     ) -> torch.Tensor:
    """Frontend embeddings [B, F, frontend_dim] -> [B, F, d_model] in the
    model's dtype; on a mesh each rank projects its columns, gathered
    whole."""
    dtype = model_dtype(cfg)
    w = common.layer(tp, params["frontend_proj"]).to(dtype)
    fx = frontend.to(dtype) @ w
    return fx if fx.shape[-1] == cfg.d_model else common.gather_columns(
        tp, fx)


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            ssd_impl: str = "auto", frontend: Optional[torch.Tensor] = None,
            tp: Optional[common.TensorParallel] = None):
    """tokens [B, S] (and frontend embeddings [B, F, frontend_dim]) ->
    (logits [B, F + S, V], aux): with a frontend the logits cover the
    whole sequence, as in JAX; callers slice.  ``ssd_impl`` picks the SSD's
    implementation in the mamba layers (the JAX config has no field for
    it: there the backend decides).  On a mesh the logits are this rank's
    columns of V."""
    dtype = model_dtype(cfg)
    x = embed_tokens(params, cfg, tokens, dtype, tp)
    if frontend is not None:
        x = torch.cat([project_frontend(params, cfg, frontend, tp), x], dim=1)
    S = x.shape[1]
    if cfg.pos_embed == "sinusoidal":
        x = x + common.sinusoidal_positions(S, cfg.d_model,
                                            x.device).to(dtype)
        positions = None
    else:
        positions = torch.arange(S, device=x.device)
    if tp is not None:
        tp = dataclasses.replace(tp, sequence_parallel=bool(
            cfg.sequence_parallel and S % tp.size == 0))
        x = common.split_seq(tp, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params["blocks"]:
        x, a = remat_call(cfg, apply_block, block, cfg, x, positions,
                          ssd_impl, tp)
        aux = aux + a
    x = common.apply_norm(common.layer(tp, params["norm_out"]), x, tp=tp)
    return unembed(params, cfg, x, tp), aux


# ---------------------------------------------------------------------------
# decode path (serve_step)
# ---------------------------------------------------------------------------
def init_block_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                      dtype: torch.dtype = torch.bfloat16, place=None
                      ) -> List[Union[KVCache, MambaCache]]:
    """One cache per layer: a KV cache for an attention layer, bf16 by
    default whatever ``cfg.dtype``; a Mamba state for a mamba layer (f32
    conv tails and state, ``max_len`` and ``dtype`` unused, as in the JAX
    package).  ``place`` (on a mesh) allocates each tensor as the rank's
    shard of it (``attention.init_cache``)."""
    return [init_cache(cfg, batch, max_len, device, dtype, place)
            if mixer == "attn"
            else init_mamba_cache(cfg, batch, device, place)
            for mixer, _ in layer_plan(cfg)]


def apply_block_decode(block: dict, cfg: ModelConfig, cache,
                       x: torch.Tensor,
                       tp: Optional[common.TensorParallel] = None,
                       shards: Optional[dict] = None):
    """One-token decode through one layer -> (cache, x).  On a mesh
    ``block`` is the layer's shards, gathered here (and freed when this
    returns), ``cache`` the rank's shards of the layer's cache and
    ``shards`` their geometry (``{"k": common.CacheShard}``)."""
    block = common.layer(tp, block)
    h = common.apply_norm(_mixer_norm(block), x)
    if "mamba" in block:
        cache, y = mamba_decode_step(block["mamba"], cfg, cache, h, tp)
    else:
        cache, y = attn_decode_step(block["attn"], cfg, cache, h, tp=tp,
                                    shard=(shards or {}).get("k"))
    x = x + y
    if "norm_ffn" in block:
        x = x + _feed_forward(block, cfg, x, tp)[0]
    return cache, x


def decode_step(params: dict, cfg: ModelConfig, caches: list,
                token: torch.Tensor,
                tp: Optional[common.TensorParallel] = None,
                shards: Optional[dict] = None):
    """token [B, 1] -> (new_caches, logits [B, 1, V]).  The caches' tensors
    are updated in place (the KV caches and the SSM states); the returned
    list holds the KV caches' new lengths and the new conv tails.

    On a mesh (``tp``) each layer gathers its shards and runs
    tensor-parallel (:func:`apply_block_decode`), the embedding and the
    unembedding are vocab-parallel, and the logits are gathered whole for
    the rank's rows (the JAX cell's ``out_shardings=(state, None)``)."""
    x = embed_tokens(params, cfg, token, model_dtype(cfg), tp)
    new_caches = []
    for block, cache in zip(params["blocks"], caches):
        cache, x = apply_block_decode(block, cfg, cache, x, tp, shards)
        new_caches.append(cache)
    x = common.apply_norm(common.layer(tp, params["norm_out"]), x)
    logits = common.gather_vocab(tp, unembed(params, cfg, x, tp),
                                 cfg.vocab_size)
    return new_caches, logits
