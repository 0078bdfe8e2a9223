"""Feed-forward layers: gated (SwiGLU/GeGLU) and plain (GELU) variants."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def init_ffn(generator: torch.Generator, cfg: ModelConfig,
             dtype: torch.dtype, d_ff: int | None = None) -> dict:
    """Matmul weights in ``dtype`` (see ``transformer.init_model``), biases
    likewise: the JAX package casts both to the activations' dtype at each
    use."""
    d_ff = d_ff or cfg.d_ff
    dev = generator.device
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": common.dense_init(generator, cfg.d_model, d_ff, dtype),
            "w_up": common.dense_init(generator, cfg.d_model, d_ff, dtype),
            "w_down": common.dense_init(generator, d_ff, cfg.d_model, dtype),
        }
    return {
        "w_in": common.dense_init(generator, cfg.d_model, d_ff, dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_out": common.dense_init(generator, d_ff, cfg.d_model, dtype),
        "b_out": torch.zeros((cfg.d_model,), dtype=dtype, device=dev),
    }


def ffn_forward(params: dict, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    if "w_gate" in params:
        gate = x @ params["w_gate"].to(x.dtype)
        up = x @ params["w_up"].to(x.dtype)
        return common.gated_act(cfg.act, gate, up) @ params["w_down"].to(x.dtype)
    h = x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"].to(x.dtype) + params["b_out"].to(x.dtype)
