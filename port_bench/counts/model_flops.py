"""Model FLOPs of a forward pass, and of a training step.

The multiply-adds the architecture's matmuls need at the configuration's
widths, two FLOPs each: each sublayer's as its file under
``counts/layers/`` counts them (a Mamba-2 layer's in- and out-projections,
an attention layer's four projections, an FFN's three matrices, an MoE's
router and its k active experts, no capacity padding), and the head over
the published vocabulary; then what mixes positions: each attention
layer's causal pairs, 4 D a pair and query head, and each SSD's chunked
products at a chunk of 128 (``bounds.ssd_bound``'s operations).  Norms, activations, the convolution
and the loss are not counted.  A training step counts three forwards (no
remat recompute).

Hand-worked values:

* mamba2-2.7b, a token: 64 x [2560 (10240 + 256 + 80) + 5120 x 2560] +
  2560 x 50277 = 2,700,341,760 multiply-adds; SSD of a 4096-token row a
  layer 32 x [80 (128·129·64 + 4·128·128·64) + 128·129·128] =
  13,510,377,472.  A training step of 2 x 4096: 3 x (2 x 2,700,341,760 x
  8192 + 2 x 64 x 13,510,377,472) = 137,915,183,136,768 FLOPs.  A prefill
  of 4 x 2048: 44,242,399,395,840 + 4 x 64 x 6,755,188,736 =
  45,971,727,712,256.
* jamba-v0.1-52b at 16 layers (2 attention, 14 Mamba-2, 8 FFN, 8 MoE), a
  token: 2 x 41,943,040 + 14 x 101,318,656 + 8 x 176,160,768 + 8 x
  352,387,072 + 268,435,456 = 5,999,165,440 multiply-adds.  A prefill of 4
  x 2048: 98,290,326,568,960 + attention 8 x 34,376,515,584 + SSD 56 x
  3,242,229,760 = 98,746,903,560,192 FLOPs.
"""

from __future__ import annotations

import importlib
from types import ModuleType

from reference.model import Spec, layer_plan


def sublayer(name: str) -> ModuleType:
    """``counts/layers/<name>.py``."""
    return importlib.import_module(f"counts.layers.{name}")


def matmul_macs_per_token(spec: Spec) -> int:
    total = spec.d_model * spec.vocab_size  # the head
    for names in layer_plan(spec):
        total += sum(sublayer(n).macs_per_token(spec) for n in names if n)
    return total


def forward_flops(spec: Spec, batch: int, seq: int) -> int:
    """FLOPs of one forward over ``batch`` rows of ``seq`` tokens."""
    flops = 2 * matmul_macs_per_token(spec) * batch * seq
    for names in layer_plan(spec):
        flops += sum(sublayer(n).mixing_flops(spec, batch, seq)
                     for n in names if n)
    return flops


def step_flops(spec: Spec, batch: int, seq: int, train: bool) -> int:
    """A training step's FLOPs (three forwards) or a prefill's (one)."""
    return (3 if train else 1) * forward_flops(spec, batch, seq)
