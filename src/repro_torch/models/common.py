"""Shared model building blocks: initializers, norms, RoPE, activations.

The counterpart of ``repro/models/common.py`` for one card.  Parameters are
plain dicts of tensors, as the JAX package's pytrees are, so a JAX
parameter tree carries across leaf for leaf (``repro_torch.convert``).
Every function keeps the JAX package's arithmetic: which dtype each step
runs in and where it rounds.

Left for later slices: the activation mesh and ``constrain`` (one card;
meshes are ROADMAP.md queue 1 item 8), sinusoidal positions (enc-dec) and
``cross_entropy`` (training).
"""

from __future__ import annotations

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
# activations
# ---------------------------------------------------------------------------
def gated_act(act: str, gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    raise ValueError(f"{act} is not a gated activation")
