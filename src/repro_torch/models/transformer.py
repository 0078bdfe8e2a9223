"""Decoder-only model assembly, the dense and SSM (Mamba-2) families:

    dense : [norm -> attn -> +res] [norm -> ffn -> +res]   x L
    ssm   : [norm -> mamba -> +res]                        x L

The counterpart of those paths of ``repro/models/transformer.py``.  The
JAX package scans one stacked block; here ``params["blocks"]`` is a list of
per-layer parameter dicts and the layer loop is a Python loop.  The MoE,
hybrid, encoder-decoder and modality-frontend families come with later
slices (:func:`require_ported` names them).

Matmul weights and embeddings are stored once in ``cfg.dtype``.  The JAX
package keeps f32 masters and casts them to ``cfg.dtype`` at every use;
the cast rounds to nearest even either way, so the numbers are the same,
and a bf16 llama3-8b holds 16 GB on the card instead of 32 GB plus a cast
per layer per step.  Norm scales stay f32.
"""

from __future__ import annotations

from typing import List, Union

import torch

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

PORTED = ("dense", "ssm")
#: family -> where ROADMAP.md puts its slice
NOT_PORTED = {
    "moe": "ROADMAP.md queue 1 item 5b (MoE: dbrx-132b, llama4-maverick)",
    "hybrid": "ROADMAP.md queue 1 item 5c (hybrid: jamba-v0.1-52b)",
    "encdec": "ROADMAP.md queue 1 item 5d (enc-dec: seamless-m4t)",
    "vlm": "ROADMAP.md queue 1 item 5e (VLM: internvl2-1b)",
}


def require_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family the port has not yet:
    every one but dense and ssm without a modality frontend."""
    family = "vlm" if cfg.frontend_tokens else cfg.family
    if family not in PORTED:
        raise NotImplementedError(
            f"{cfg.arch_id}: the {family} family is not ported yet; see "
            f"{NOT_PORTED.get(family, 'ROADMAP.md queue 1 item 5')}")


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
def init_block(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """One layer's parameters."""
    dtype, dev = model_dtype(cfg), generator.device
    if cfg.family == "ssm":
        return {"norm_mix": common.init_norm(cfg.norm, cfg.d_model, dev),
                "mamba": init_mamba(generator, cfg, dtype)}
    return {
        "norm_attn": common.init_norm(cfg.norm, cfg.d_model, dev),
        "attn": init_attn(generator, cfg, dtype),
        "norm_ffn": common.init_norm(cfg.norm, cfg.d_model, dev),
        "ffn": init_ffn(generator, cfg, dtype),
    }


def apply_block(block: dict, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, ssd_impl: str = "auto"):
    """Full-sequence block application -> (x, aux); aux is 0 for dense and
    ssm.  ``ssd_impl`` picks the SSD's implementation (``kernels.ops.ssd``)
    in an ssm block."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = common.apply_norm(block["norm_mix"], x)
        return x + mamba_forward(block["mamba"], cfg, h, ssd_impl), aux
    h = common.apply_norm(block["norm_attn"], x)
    x = x + attn_forward(block["attn"], cfg, h, positions=positions,
                         rope=cfg.pos_embed == "rope")
    h = common.apply_norm(block["norm_ffn"], x)
    return x + ffn_forward(block["ffn"], cfg, h), aux


# ---------------------------------------------------------------------------
# model init / forward
# ---------------------------------------------------------------------------
def init_model(generator: torch.Generator, cfg: ModelConfig) -> dict:
    """Parameters on the generator's device, drawn from it in a fixed
    order: embedding, blocks, unembedding."""
    require_ported(cfg)
    dtype, dev = model_dtype(cfg), generator.device
    params = {
        "embed": common.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                   dtype),
        "blocks": [init_block(generator, cfg) for _ in range(cfg.num_layers)],
        "norm_out": common.init_norm(cfg.norm, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = common.embed_init(generator, cfg.vocab_size,
                                              cfg.d_model, dtype)
    return params


def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    x = params["embed"].to(dtype)[tokens.long()]
    if cfg.embed_scale:
        # the scale is rounded to the activations' dtype first, as in JAX
        # (a 0-dim CPU tensor: no copy to the card)
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype)
    return x


def unembed(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    table = params.get("unembed", params["embed"])
    return x @ table.to(x.dtype).T


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            ssd_impl: str = "auto"):
    """tokens [B, S] -> (logits [B, S, V], aux).  ``ssd_impl`` picks the
    SSD's implementation in an ssm model (the JAX config has no field for
    it: there the backend decides)."""
    dtype = model_dtype(cfg)
    x = embed_tokens(params, cfg, tokens, dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in params["blocks"]:
        x, a = apply_block(block, cfg, x, positions, ssd_impl)
        aux = aux + a
    x = common.apply_norm(params["norm_out"], x)
    return unembed(params, cfg, x), aux


# ---------------------------------------------------------------------------
# decode path (serve_step)
# ---------------------------------------------------------------------------
def init_block_caches(cfg: ModelConfig, batch: int, max_len: int, device,
                      dtype: torch.dtype = torch.bfloat16
                      ) -> List[Union[KVCache, MambaCache]]:
    """One cache per layer: a KV cache, bf16 by default whatever
    ``cfg.dtype``; or, for ssm, a Mamba state (f32 conv tails and state,
    ``max_len`` and ``dtype`` unused, as in the JAX package)."""
    if cfg.family == "ssm":
        return [init_mamba_cache(cfg, batch, device)
                for _ in range(cfg.num_layers)]
    return [init_cache(cfg, batch, max_len, device, dtype)
            for _ in range(cfg.num_layers)]


def apply_block_decode(block: dict, cfg: ModelConfig, cache,
                       x: torch.Tensor):
    """One-token decode through one block -> (cache, x)."""
    if cfg.family == "ssm":
        h = common.apply_norm(block["norm_mix"], x)
        cache, y = mamba_decode_step(block["mamba"], cfg, cache, h)
        return cache, x + y
    cache, y = attn_decode_step(block["attn"], cfg, cache,
                                common.apply_norm(block["norm_attn"], x))
    x = x + y
    h = common.apply_norm(block["norm_ffn"], x)
    return cache, x + ffn_forward(block["ffn"], cfg, h)


def decode_step(params: dict, cfg: ModelConfig, caches: list,
                token: torch.Tensor):
    """token [B, 1] -> (new_caches, logits [B, 1, V]).  The caches' tensors
    are updated in place (the KV caches and the SSM states); the returned
    list holds the KV caches' new lengths and the new conv tails."""
    x = embed_tokens(params, cfg, token, model_dtype(cfg))
    new_caches = []
    for block, cache in zip(params["blocks"], caches):
        cache, x = apply_block_decode(block, cfg, cache, x)
        new_caches.append(cache)
    x = common.apply_norm(params["norm_out"], x)
    return new_caches, unembed(params, cfg, x)
