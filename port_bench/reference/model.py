"""Plain float32 forward pass of the benchmark's configurations.

The architecture as the configuration files state it (``configs/*.json``,
key ``model``), written from the published descriptions and nothing of the
port.  Each layer is x + mixer(norm(x)), then x + ff(norm(x)), the mixer
and the feed-forward named by the configuration's layer ``pattern`` and
found by that name under ``reference/layers/`` (Mamba-2, attention, FFN,
MoE); the norms' kind, by the port's name, under ``reference/norms/``.

Every function takes float32 tensors and computes in float32; callers set
TF32 off (:func:`no_tf32`).  Weights are dicts named as the benchmark's
generator names them (``harness/weights.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
from types import ModuleType
from typing import List, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes a configuration file's ``model`` block states."""

    family: str  # the port's family ("ssm", "hybrid", ...)
    num_layers: int
    d_model: int
    vocab_size: int
    #: each layer's (mixer, feed-forward) over one period, repeated to
    #: ``num_layers``; "" where a layer has no feed-forward
    pattern: Tuple[Tuple[str, str], ...] = ()
    mixer_norm: str = "norm_mix"  # the name of the norm before the mixer
    norm: str = "rmsnorm"  # the port's name of its norms' kind
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = True
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    rope_theta: float = 1e4
    num_experts: int = 0
    experts_per_token: int = 0
    moe_layer_period: int = 1
    capacity_factor: float = 1.25
    attn_layer_period: int = 0
    attn_layer_offset: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    norm_eps: float = 1e-6

    @classmethod
    def from_dict(cls, d: dict) -> "Spec":
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - fields
        if unknown:
            raise ValueError(f"unknown model keys {sorted(unknown)}")
        d = dict(d, pattern=tuple(tuple(p) for p in d.get("pattern", ())))
        spec = cls(**d)
        if spec.num_heads and not spec.head_dim:
            spec = dataclasses.replace(spec,
                                       head_dim=spec.d_model // spec.num_heads)
        return spec

    @property
    def vocab_rows(self) -> int:
        """Rows of the embedding table: the vocabulary padded to a multiple
        of ``vocab_pad_multiple``."""
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim


def layer_plan(spec: Spec) -> List[Tuple[str, str]]:
    """Each layer's (mixer, feed-forward): the ``pattern`` repeated over
    the depth."""
    n = len(spec.pattern)
    if not n or spec.num_layers % n:
        raise ValueError(f"{spec.num_layers} layers cannot repeat the "
                         f"pattern {spec.pattern}")
    return list(spec.pattern) * (spec.num_layers // n)


def sublayer(name: str) -> ModuleType:
    """``reference/layers/<name>.py``: a sublayer's ``layout`` and
    ``forward``."""
    return importlib.import_module(f"reference.layers.{name}")


def norm_kind(spec: Spec) -> ModuleType:
    """``reference/norms/<spec.norm>.py``: the norm's ``layout`` and
    ``apply``."""
    return importlib.import_module(f"reference.norms.{spec.norm}")


def norm(p: dict, spec: Spec, x: torch.Tensor) -> torch.Tensor:
    return norm_kind(spec).apply(p, x, spec.norm_eps)


@contextlib.contextmanager
def no_tf32():
    """Inside, float32 matmuls and convolutions run in float32, not TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def block(p: dict, spec: Spec, mixer: str, ff: str, x: torch.Tensor,
          margins: Optional[list] = None) -> torch.Tensor:
    """One layer: x + mixer(norm(x)), then x + ff(norm(x)); ``margins``
    gets an MoE's router margins (``layers/moe.py``)."""
    h = norm(p[spec.mixer_norm], spec, x)
    x = x + sublayer(mixer).forward(p[mixer], spec, h, margins)
    if ff:
        h = norm(p["norm_ffn"], spec, x)
        x = x + sublayer(ff).forward(p[ff], spec, h, margins)
    return x


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def head(top: dict, spec: Spec, x: torch.Tensor) -> torch.Tensor:
    """Final norm and the logits over every row of the (padded) table."""
    x = norm(top["norm_out"], spec, x)
    table = top["embed"] if spec.tie_embeddings else top["unembed"]
    return x @ table.t()


def cross_entropy(logits: torch.Tensor, tokens: torch.Tensor,
                  z_loss_weight: float) -> torch.Tensor:
    """Next-token loss: logits[:, t] against tokens[:, t + 1] over every
    row of the table, mean over positions, plus ``z_loss_weight`` times the
    mean squared log-partition (PaLM's z-loss)."""
    lg = logits[:, :-1]
    lse = torch.logsumexp(lg, dim=-1)
    picked = lg.gather(-1, tokens[:, 1:].long()[..., None])[..., 0]
    return (lse - picked).mean() + z_loss_weight * (lse * lse).mean()


def top_gap(logits: torch.Tensor, tokens: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """How far each chosen token's logit lies below the best: logits [...,
    rows], tokens [...] -> max over the vocabulary minus the token's
    logit, over the first ``vocab`` columns."""
    lg = logits[..., :vocab]
    return lg.max(dim=-1).values - lg.gather(
        -1, tokens.long()[..., None])[..., 0]

