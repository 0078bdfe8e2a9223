"""Serving steps: prefill and batched incremental decode.

The counterpart of ``repro/train/serve_step.py``.  ``make_prefill`` runs the
full-sequence forward, whose attention (dense) or SSD (ssm) is a
hand-written kernel on the card; ``greedy_generate`` feeds the prompt token by token through the decode path
and then decodes greedily, exactly as the JAX package does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.models import Model


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
                    num_steps: int, max_len: int) -> torch.Tensor:
    """End-to-end greedy decoding: prompt [B, S] -> [B, num_steps] int32.

    The prompt is consumed token by token through the decode path (simple
    and universal across families, as in the JAX package); each next token
    is the argmax over the unpadded vocabulary.  Runs on the model's device
    (the card unless the model was built for the CPU): raises without CUDA
    otherwise.  No host synchronisation inside the loop."""
    cfg = model.cfg
    dev = resolve_device(model.device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params on {params['embed'].device}, model on {dev}")
    prompt_tokens = torch.as_tensor(prompt_tokens).to(dev)
    B, S = prompt_tokens.shape
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
