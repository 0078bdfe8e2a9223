"""Model zoo: one entry point over every architecture.

`build(cfg)` returns a `Model` bundle of functions, as in the JAX package,
for all ten architectures: the dense family (llama3-8b, gemma-7b,
qwen1.5-4b, qwen2-72b), the moe family (dbrx-132b,
llama4-maverick-400b-a17b), the ssm family (mamba2-2.7b), the hybrid
family (jamba-v0.1-52b), the VLM family (internvl2-1b: ``forward`` takes
``frontend`` embeddings, put before the tokens) and the enc-dec family
(seamless-m4t-large-v2: ``forward`` takes ``tokens`` and ``frontend``
frames, ``init_decode`` the encoder's ``memory``).  A model runs on the
card unless it is built with ``device="cpu"``; on a mesh its
``forward``, ``init_decode`` and ``decode_step`` take the layers' shards
and the mesh's context (``launch/train.py:MeshModel``).  :func:`input_specs`
gives a train or prefill cell's inputs, as the JAX package's, for
``launch/dryrun.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import encdec, transformer

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(cfg: ModelConfig) -> int:
    """Embedding tables padded to a multiple of 256 rows, as in the JAX
    package (there: so the vocab axis shards evenly 256 ways)."""
    v = cfg.vocab_size
    m = VOCAB_PAD_MULTIPLE
    return ((v + m - 1) // m) * m


def _padded_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, vocab_size=padded_vocab(cfg))


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: DeviceLike  # None: the card
    # (seed, param_dtype=None) -> params on the resolved device; matmul
    # weights in param_dtype (default cfg.dtype; torch.float32: f32 masters)
    init: Callable
    # (params, *, tokens, frontend=None, ssd_impl="auto", tp=None) ->
    # (logits, aux); on a mesh (tp) params hold each layer's shards
    forward: Callable
    # (params, batch, max_len[, memory=], tp=None, place=None) -> caches
    # (enc-dec: a DecCache); on a mesh (``launch/train.py:MeshModel``)
    # ``place`` allocates each cache tensor as the rank's shard of it
    init_decode: Callable
    # (params, caches, token, tp=None, shards=None) -> (caches, logits); on
    # a mesh params hold each layer's shards and ``shards`` the caches'
    # geometry ({"k" or "cross_k": common.CacheShard})
    decode_step: Callable


def build(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    transformer.require_ported(cfg)
    pcfg = _padded_cfg(cfg)
    family = encdec if cfg.is_encdec else transformer

    def init(seed: int = 0, param_dtype: Optional[torch.dtype] = None):
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return family.init_model(generator, pcfg, param_dtype)

    if cfg.is_encdec:
        def forward(params, *, tokens, frontend, tp=None, **_):
            return encdec.forward(params, pcfg, tokens, frontend, tp)

        def init_decode(params, batch, max_len, memory=None, tp=None,
                        place=None):
            if memory is None:
                raise ValueError("enc-dec decode needs encoder memory")
            return encdec.init_decode_state(params, pcfg, memory, batch,
                                            max_len, tp=tp, place=place)

        def decode_step(p, s, t, tp=None, shards=None):
            return encdec.decode_step(p, pcfg, s, t, tp, shards)

        return Model(
            cfg=cfg, device=device, init=init, forward=forward,
            init_decode=init_decode, decode_step=decode_step)

    def forward(params, *, tokens, frontend=None, ssd_impl="auto", tp=None,
                **_):
        return transformer.forward(params, pcfg, tokens, ssd_impl,
                                   frontend=frontend, tp=tp)

    def init_decode(params, batch, max_len, tp=None, place=None):
        # a mamba layer's state does not depend on max_len, as in JAX; the
        # caches hold no parameter, so ``tp`` changes nothing here
        device = None if place is not None else params["embed"].device
        return transformer.init_block_caches(pcfg, batch, max_len, device,
                                             place=place)

    def decode_step(p, s, t, tp=None, shards=None):
        return transformer.decode_step(p, pcfg, s, t, tp, shards)

    return Model(
        cfg=cfg,
        device=device,
        init=init,
        forward=forward,
        init_decode=init_decode,
        decode_step=decode_step,
    )


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec, leaf=_meta) -> dict:
    """A train or prefill cell's inputs, each ``leaf(shape, dtype)`` (a
    ``meta`` tensor by default): tokens [B, S] int32; an enc-dec model's
    speech frames [B, max(128, S / 4), frontend_dim] and a VLM's patch
    embeddings [B, F, frontend_dim] (its tokens then S - F) in bf16;
    ``labels`` like the tokens for a train cell (the JAX package's
    ``input_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    width = cfg.frontend_dim or cfg.d_model
    if cfg.is_encdec:
        specs = {"frontend": leaf((B, max(128, S // 4), width),
                                  torch.bfloat16),
                 "tokens": leaf((B, S), torch.int32)}
    elif cfg.frontend_tokens:
        specs = {"tokens": leaf((B, S - cfg.frontend_tokens), torch.int32),
                 "frontend": leaf((B, cfg.frontend_tokens, width),
                                  torch.bfloat16)}
    else:
        specs = {"tokens": leaf((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = leaf(tuple(specs["tokens"].shape), torch.int32)
    return specs
