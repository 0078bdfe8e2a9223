"""Feed-forward layers: gated (SwiGLU/GeGLU) and plain (GELU) variants.

On a mesh (``tp``) the layer is Megatron's: the up projections
(``w_gate`` and ``w_up``, or ``w_in`` with ``b_in``) are column-parallel,
``params`` holding this rank's columns of d_ff, and the down projection
(``w_down`` or ``w_out``) row-parallel; its partial output is summed over
the model axis (``common.tp_out``) and ``b_out`` added once, after the
sum.
"""

from __future__ import annotations

from typing import Optional

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


def ffn_partial(params: dict, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """The layer on this rank's columns of d_ff, before the sum over the
    ranks and without ``b_out`` (the whole layer on one device)."""
    if "w_gate" in params:
        gate = x @ params["w_gate"].to(x.dtype)
        up = x @ params["w_up"].to(x.dtype)
        return common.gated_act(cfg.act, gate, up) @ params["w_down"].to(x.dtype)
    h = x @ params["w_in"].to(x.dtype) + params["b_in"].to(x.dtype)
    h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"].to(x.dtype)


def add_b_out(params: dict, y: torch.Tensor,
              tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    """``y``, the layer's output summed over the ranks, plus ``b_out``
    where the layer has one."""
    if "b_out" not in params:
        return y
    b_out = params["b_out"]
    if tp is not None and tp.sequence_parallel:  # on a sequence shard
        b_out = common.copy_to(tp, b_out)
    return y + b_out.to(y.dtype)


def ffn_forward(params: dict, cfg: ModelConfig, x: torch.Tensor,
                tp: Optional[common.TensorParallel] = None) -> torch.Tensor:
    y = common.tp_out(tp, ffn_partial(params, cfg, common.tp_in(tp, x)))
    return add_b_out(params, y, tp)
