"""Model zoo: one entry point over the ported architectures.

`build(cfg)` returns a `Model` bundle of functions, as in the JAX package.
The port covers the dense family without a modality frontend (llama3-8b,
gemma-7b, qwen1.5-4b, qwen2-72b) and the ssm family (mamba2-2.7b); `build`
raises ``NotImplementedError`` for the others.  A model runs on the card
unless it is built with ``device="cpu"``.  The dry-run's ``input_specs`` and ``decode_specs`` come
with the dry-run slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import transformer

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
    init: Callable  # (seed) -> params on the resolved device
    forward: Callable  # (params, *, tokens, ssd_impl="auto") -> (logits, aux)
    init_decode: Callable  # (params, batch, max_len) -> caches
    decode_step: Callable  # (params, caches, token) -> (caches, logits)


def build(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    transformer.require_ported(cfg)
    pcfg = _padded_cfg(cfg)

    def init(seed: int = 0):
        dev = resolve_device(device)
        generator = torch.Generator(device=dev).manual_seed(seed)
        return transformer.init_model(generator, pcfg)

    def forward(params, *, tokens, ssd_impl="auto", **_):
        return transformer.forward(params, pcfg, tokens, ssd_impl)

    def init_decode(params, batch, max_len):
        # an ssm model's state does not depend on max_len, as in JAX
        return transformer.init_block_caches(pcfg, batch, max_len,
                                             params["embed"].device)

    return Model(
        cfg=cfg,
        device=device,
        init=init,
        forward=forward,
        init_decode=init_decode,
        decode_step=lambda p, s, t: transformer.decode_step(p, pcfg, s, t),
    )
