"""The benchmark's weights, drawn on the device from the seed.

Both sides get the same tensors from here: the port as its parameter tree
(the names and shapes its layers read), the reference again, layer by
layer, after the port's state is freed.  Each layer (the embedding, each
block, the head) has a generator of its own, seeded from the run's seed and
the layer's index, and is drawn in two calls: one normal draw for every
matrix, convolution weight and table of the layer, in the type they are
stored in, and one uniform float32 draw for the rest.  A layer can so be
drawn again alone, bit for bit.

Scales: matrices and tables N(0, fan_in^-1); convolution weights
N(0, width^-1) and biases U(-1/2, 1/2); A_log = log U(1, 16); dt_bias the
inverse softplus of a log-uniform dt in [1e-3, 1e-1]; D = 1; norm scales
U(0.9, 1.1).  The Mamba-2 paper's initialisation, with random norm scales
so that a scale the program dropped would show.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from reference.model import Spec, layer_plan, norm_kind, sublayer

#: (name, shape, kind) of a leaf; kind "normal:<fan>" or one of the
#: uniform kinds of ``_uniform_leaf``
Leaf = Tuple[str, tuple, str]


def layers(spec: Spec) -> List[List[Leaf]]:
    """Every layer's leaves, dotted names from the layer's root: the
    embedding (0), each block (1..L), the head (L + 1); norms, mixers and
    feed-forwards as their files under ``reference/`` lay them out."""
    d = spec.d_model

    def under(prefix: str, layout) -> List[Leaf]:
        return [(f"{prefix}.{n}", s, k) for n, s, k in layout]

    norm = norm_kind(spec).layout(d)
    out = [[("embed", (spec.vocab_rows, d), f"normal:{d}")]]
    for mixer, ff in layer_plan(spec):
        leaves = under(spec.mixer_norm, norm)
        leaves += under(mixer, sublayer(mixer).layout(spec))
        if ff:
            leaves += under("norm_ffn", norm)
            leaves += under(ff, sublayer(ff).layout(spec))
        out.append(leaves)
    top = under("norm_out", norm)
    if not spec.tie_embeddings:
        top.append(("unembed", (spec.vocab_rows, d), f"normal:{d}"))
    out.append(top)
    return out


def layer_seed(seed: int, index: int) -> int:
    """The generator seed of layer ``index`` of a run seeded ``seed``."""
    return (seed * 1_000_003 + 7_919 * (index + 1)) % (1 << 63)


def _uniform_leaf(u: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "bias":
        return u - 0.5
    if kind == "a_log":
        return torch.log(1 + 15 * u)
    if kind == "dt_bias":
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        return dt + torch.log(-torch.expm1(-dt))
    if kind == "ones":
        return torch.ones_like(u)
    if kind == "scale":
        return 0.9 + 0.2 * u
    raise ValueError(kind)


def draw_layer(spec: Spec, seed: int, index: int, dtype: torch.dtype,
               device) -> Dict[str, torch.Tensor]:
    """Layer ``index``'s leaves, dotted name -> tensor: matrices, tables
    and convolution leaves in ``dtype``, the SSM's scalars and the norm
    scales in float32."""
    leaves = layers(spec)[index]
    g = torch.Generator(device=device).manual_seed(layer_seed(seed, index))
    normal = [lf for lf in leaves if lf[2].startswith("normal:")]
    rest = [lf for lf in leaves if not lf[2].startswith("normal:")]
    out = {}
    n = sum(math.prod(s) for _, s, _ in normal)
    flat = torch.randn(n, generator=g, dtype=dtype, device=device)
    at = 0
    for name, shape, kind in normal:
        size = math.prod(shape)
        std = int(kind.split(":")[1]) ** -0.5
        out[name] = flat[at:at + size].view(shape).mul_(std)
        at += size
    n = sum(math.prod(s) for _, s, _ in rest)
    if n:
        u = torch.rand(n, generator=g, dtype=torch.float32, device=device)
        at = 0
        for name, shape, kind in rest:
            size = math.prod(shape)
            t = _uniform_leaf(u[at:at + size], kind).view(shape)
            out[name] = t.to(dtype) if kind == "bias" else t
            at += size
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """Dotted names -> nested dicts."""
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


def draw(spec: Spec, seed: int, dtype: torch.dtype, device) -> dict:
    """The whole parameter tree: {"embed", "blocks": [...], "norm_out"
    (, "unembed")}."""
    n = spec.num_layers
    tree = nest(draw_layer(spec, seed, 0, dtype, device))
    tree["blocks"] = [nest(draw_layer(spec, seed, i, dtype, device))
                      for i in range(1, n + 1)]
    tree.update(nest(draw_layer(spec, seed, n + 1, dtype, device)))
    return tree
