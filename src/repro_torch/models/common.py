"""Shared model building blocks: initializers, norms, RoPE, activations.

The counterpart of ``repro/models/common.py`` for one card.  Parameters are
plain dicts of tensors, as the JAX package's pytrees are, so a JAX
parameter tree carries across leaf for leaf (``repro_torch.convert``).
Every function keeps the JAX package's arithmetic: which dtype each step
runs in and where it rounds.

The activation mesh and ``constrain`` have no counterpart: on a mesh
(``launch/train.py``) activations are local to a rank, each rank running
its own rows with every leaf gathered.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------
def _trunc_normal(generator: torch.Generator, shape, std: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """std * (a standard normal truncated to [-2, 2]), drawn in f32 on the
    generator's device, then cast (the JAX package's
    ``std * truncated_normal(key, -2, 2, shape, f32)).astype(dtype)``)."""
    w = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(std).to(dtype)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in scaling (the LLaMA/MaxText default)."""
    return _trunc_normal(generator, (in_dim, out_dim), in_dim ** -0.5, dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """std d^-1/2: tied unembedding then yields O(1) logits at init."""
    return _trunc_normal(generator, (vocab, dim), dim ** -0.5, dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def init_norm(norm: str, dim: int, device) -> dict:
    """Norm parameters, f32 whatever the model's dtype."""
    if norm == "rmsnorm":
        return {"scale": torch.ones((dim,), dtype=torch.float32,
                                    device=device)}
    if norm == "layernorm":
        return {"scale": torch.ones((dim,), dtype=torch.float32,
                                    device=device),
                "bias": torch.zeros((dim,), dtype=torch.float32,
                                    device=device)}
    raise ValueError(f"unknown norm {norm}")


def apply_norm(params: dict, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (or LayerNorm where the params hold a bias) in f32 with an
    f32 scale, cast back to x's dtype."""
    xf = x.float()
    if "bias" in params:  # layernorm
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"] + params["bias"]
    else:  # rmsnorm
        ms = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [B, H, S, D]; positions [S] or [B, S].  Rotates the two halves of
    D (not interleaved pairs), with the angles in f32; returns x's dtype."""
    D = x.shape[-1]
    freqs = rope_frequencies(D, theta, x.device)  # [D/2]
    if positions.dim() == 1:
        angles = positions[:, None].float() * freqs[None, :]
        angles = angles[None, None]  # [1, 1, S, D/2]
    else:
        angles = positions[:, :, None].float() * freqs[None, None, :]
        angles = angles[:, None]  # [B, 1, S, D/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# sinusoidal positions (the enc-dec stacks)
# ---------------------------------------------------------------------------
def _sinusoid_div(dim: int, device) -> torch.Tensor:
    return torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=device)
                     * (-math.log(10000.0) / dim))


def sinusoidal_at(position: int, dim: int, device=None) -> torch.Tensor:
    """The sinusoidal embedding of one position, [dim] f32: sin on even
    channels, cos on odd.  ``position`` is a host int (a ``KVCache.length``),
    so a decode step computes it on the device without a sync."""
    angles = _sinusoid_div(dim, device) * float(position)
    return torch.stack([torch.sin(angles), torch.cos(angles)],
                       dim=-1).reshape(dim)


def sinusoidal_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Additive absolute positions [seq_len, dim] f32 (the seamless enc
    and dec stacks)."""
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    angles = pos * _sinusoid_div(dim, device)
    pe = torch.zeros((seq_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angles)
    pe[:, 1::2] = torch.cos(angles)
    return pe


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
def gated_act(act: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(f"{act} is not a gated activation")


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  z_loss_weight: float = 1e-4):
    """Stable softmax cross-entropy with z-loss (PaLM-style logit drift
    guard), the JAX package's ``repro.models.common.cross_entropy``.

    logits [..., V] (any dtype; reduced in f32), labels [...] int.  Returns
    (mean loss, metrics) with the same metrics: ``nll``, ``z_loss`` and
    ``tokens``.  The log-sum-exp is taken in f32 after subtracting the
    row's max (held out of the gradient, as ``stop_gradient`` there).

    The JAX package picks each label's logit with a one-hot sum, for
    GSPMD's sake (a gather along a sharded vocab axis all-gathers the
    logits); on one card that one-hot would be a [..., V] f32 tensor (4.2
    GB at 2 x 4096 x 128256), so the port picks it with ``torch.gather``:
    the same value, the one product of a one-hot row being exact."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = logits - m
    lse = torch.log(torch.exp(shifted).sum(dim=-1)) + m[..., 0]
    ll = shifted.gather(-1, labels.long()[..., None])[..., 0] + m[..., 0]
    nll = lse - ll
    z = lse * lse
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = (nll * mask).sum() / denom
    zloss = (z * mask).sum() / denom
    total = loss + z_loss_weight * zloss
    return total, {"nll": loss, "z_loss": zloss, "tokens": denom}
