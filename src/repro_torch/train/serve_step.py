"""Serving steps: prefill and batched incremental decode.

The counterpart of ``repro/train/serve_step.py``.  ``make_prefill`` runs the
full-sequence forward, whose attention layers and SSDs (mamba layers) are
hand-written kernels on the card; ``greedy_generate`` feeds the prompt
token by token through the decode path and then decodes greedily, exactly
as the JAX package does (an MoE layer routes each step's one token per row
at the config's own capacity factor; an enc-dec model encodes its frontend
once and cross-attends to it in every step, through the flash kernel).
``greedy_generate`` also runs on a ``launch/train.py:MeshModel`` (the
same ``init_decode`` and ``decode_step``, and ``encode`` for enc-dec),
the prompt being the rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import Model
from repro_torch.models import encdec
from repro_torch.models.model_zoo import _padded_cfg


def make_prefill(model: Model):
    """Full-sequence forward (inference): returns logits only."""

    @torch.no_grad()
    def prefill(params, **inputs):
        logits, _ = model.forward(params, **inputs)
        return logits

    return prefill


def make_decode_step(model: Model):
    @torch.no_grad()
    def decode_step(params, state, token):
        return model.decode_step(params, state, token)

    return decode_step


@torch.no_grad()
def greedy_generate(model: Model, params, prompt_tokens: torch.Tensor,
                    num_steps: int, max_len: int,
                    frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """End-to-end greedy decoding: prompt [B, S] -> [B, num_steps] int32.

    The prompt is consumed token by token through the decode path (simple
    and universal across families, as in the JAX package); each next token
    is the argmax over the unpadded vocabulary.  An enc-dec model encodes
    ``frontend`` once and decodes against that memory.  Any other model
    ignores ``frontend``, as the JAX package does: a VLM decodes its
    prompt from an empty cache, without the image prefix.  Runs on the
    model's device (the card unless the model was built for the CPU):
    raises without CUDA otherwise.  No host synchronisation inside the
    loop."""
    cfg = model.cfg
    dev = resolve_device(model.device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params on {params['embed'].device}, model on {dev}")
    prompt_tokens = torch.as_tensor(prompt_tokens).to(dev)
    B, S = prompt_tokens.shape
    if cfg.is_encdec:
        if frontend is None:
            raise ValueError("enc-dec generation needs frontend frames")
        frontend = torch.as_tensor(frontend).to(dev)
        # a MeshModel encodes tensor-parallel on the rank's shards
        memory = (model.encode(params, frontend) if hasattr(model, "encode")
                  else encdec.encode(params, _padded_cfg(cfg), frontend))
        state = model.init_decode(params, B, max_len, memory=memory)
    else:
        state = model.init_decode(params, B, max_len)

    logits = None
    for t in range(S):
        state, logits = model.decode_step(params, state,
                                          prompt_tokens[:, t:t + 1])

    def next_token(logits):
        return logits[:, -1:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)

    out = []
    token = next_token(logits)
    for _ in range(num_steps):
        out.append(token)
        state, logits = model.decode_step(params, state, token)
        token = next_token(logits)
    return torch.cat(out, dim=1)
