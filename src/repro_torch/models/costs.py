"""Analytic HBM-traffic model of the port's eager program, for the
roofline's memory term.

The counterpart of ``repro/models/costs.py``, with its functions and
signatures.  Those constants model the TPU's fused lowering (one HBM pass
for a chain of elementwise ops, the cross entropy fused with the logits);
none of them carries over.  The port runs eagerly on the card: every op
reads its inputs from HBM and writes its output there.  So each constant
below is a sum of passes, one per op of the port's code, each op's bytes
per element of the width it streams: a bf16 tensor read or written is 2,
an f32 one 4, an int64 index 8.  A broadcast operand (a norm's scale, a
bias, a [.., 1] row statistic) is read once and left out.
``launch/dryrun.py`` counts the same passes op by op on fake tensors; this
model predicts them from the configuration.

Forward passes, per element (bf16 activations, f32 inside the norms and
RoPE, f32 master weights cast at each use):

* the norm before each sublayer (``common.apply_norm``): RMSNorm = to f32
  (2+4) + x·x (4+4+4) + mean (4) + ·rsqrt (4+4) + ·scale (4+4) + to bf16
  (4+2) = 44; LayerNorm = to f32 6 + mean 4 + var 4 + x−μ 8 + ·rsqrt 8 +
  ·scale 8 + +bias 8 + to bf16 6 = 52.
* attention, beyond its norm (``models/attention.py``), per d_model
  element: the q, k and v projections read h (3·2), wo writes (2), the
  residual add (2+2+2): 14.  Per query element: the projection writes
  (2), the kernel reads q (2) and writes o (2), o's transpose copy (2+2),
  wo reads (2): 12.  Per K or V element: the projection writes (2), the
  kernel reads (2): 4, so 8 per KV width.  RoPE (``common.apply_rope``)
  on each q and k element: to f32 6 + the four half-width products
  4·(4+4)/2 + the difference and the sum 2·(4+4+4)/2 + the concatenation
  4+4 + to bf16 6 = 48.  A qkv bias: the add, 2+2 per biased element.
* a gated FFN (``models/ffn.py``), per d_model element: gate and up read
  h (2+2), down writes (2), the residual add (6): 12; per d_ff element:
  gate and up write (2+2), the activation (2+2), the product (2+2+2),
  down reads (2): 16.  The plain GELU FFN with biases: d_model 2 + 2 +
  b_out's add 4 + 6 = 14; d_ff: w_in writes 2, b_in's add 4, GELU 4, w_out
  reads 2 = 12.
* mamba (``models/mamba2.py``), beyond its norm: per d_model element the
  three projections read h (3·2), out_proj writes (2), the residual add
  (6): 14.  Per d_inner element: x and z written by w_xz (2+2); x's
  causal conv, four zero-pad copies (4·(2+2)), four tap products (4·4),
  three sums (3·6), the bias (4), SiLU (4): 58; the SSD kernel reads x and
  writes y (2+2); SiLU(z) (4); y·SiLU(z) (6); the gated RMSNorm (44);
  out_proj reads (2): 122.  Per state element N: b and c written (2·2),
  their conv (2·58), the kernel reads them (2+2): 124.  Per head: dt
  written (2), to f32 (6), +dt_bias (8), softplus (8), the kernel reads
  (4): 28.
* MoE (``models/moe.py``), beyond its norm, by the width each pass
  streams: per d_model element the router reads h (2), the dispatch reads
  x (2), the combine writes y (2), the residual add (6): 12.  Per token
  and expert: the router's logits (2), to f32 (2+4), softmax (4+4), the
  sort's read (4), values (4) and int64 indices (8), the aux loss's mean
  read (4): 36.  Per token, choice and expert: the one-hot compare (1),
  to int32 (1+4), the cumsum (4+4), the gather's read (4): 18.  Per token
  and choice: the int64 slot arithmetic, the keep mask and the
  normalised weights: 252.  Per token, choice and d_model element: the
  expanded copy (2), ·keep (2+2), the scatter's read (2), the combine's
  gather (2), ·keep (2+2), ·weight (2+2), the sum's read (2): 20.  Per
  buffer slot (E·B·C of them) and d_model element: the zeroed buffer
  (2), the scatter's read and write (2+2), the expert products' reads
  (2+2), the down product's write (2), the combine's read (2): 14; and
  per slot and expert-width element, a gated FFN's 16.  A shared expert
  is a gated FFN of its width.
* the head (``transformer.forward``): per d_model element the embedding
  gather writes (2) and the unembedding reads (2): 4, beside the final
  norm; per vocabulary entry the bf16 logits written: 2.
* parameters: each f32 master is cast where a layer uses it (4+2) and
  the matmul reads the copy (2): 8 a step to prefill (the embedding's
  gather reads the whole cast table: the same 2).  A decode cell's bf16
  weights are read once by their matmul: 2.  A tied table is cast and
  read at both uses: its compute passes count twice.

Training (``train/train_step.py``) runs each layer's forward twice, the
second time in the remat recompute (``transformer.remat_call``), and its
backward once: the autograd formula of each op above.  Per element, its
passes are the norm's backward (to f32 6, eleven f32 passes 94, to bf16 6:
112 for RMSNorm, 124 for LayerNorm), the projections' input-gradient
writes and weight-gradient reads (2 each), the gradient sums of the
residual branches (6 each), the kernels' backward (flash: q, k, v, o, do
read and dq, dk, dv written; SSD: x, dt, b, c, dy read and dx, ddt, db,
dc written, in f32 where the kernel's gradients are f32), RoPE's and the
conv's transposed passes (the same bytes as forward), SiLU's and GELU's
backward (2+2+2), and the MoE's scatter and gather transposed.  Summed
with the two forwards, a train constant is
``2·forward + backward``; the sums are the tables below (``NORM``:
2·44 + 112 = 200, 2·52 + 124 = 228).  The head is not recomputed: its
final norm costs forward + backward (156, 176), and the cross entropy
(``common.cross_entropy``) reads the logits in f32 over S − 1 positions:
to f32 (2+4), max (4), the shift (4+4), exp (4+4), the sum (4), the
gather, and the backward's softmax, scatter and cast, 74 per entry, beside
8 per entry for the bf16 logits, their gradient and the unembedding's
products.  Per parameter a train step adds to the forward's 8 the
recompute's 8, the weight gradient (bf16 write 2, to f32 2+4) and the
input-gradient product's read (2): 26; then the optimizer's eager passes
(``train/optimizer.py:update``): the global norm's square and sum (4+4,
4), the clip (4+4), the two moments' updates (mu: ·b1 4+4, (1−b1)·g 4+4,
the add 4+4+4; nu likewise with g·g 4+4+4), the bias corrections (4+4
each), the sqrt, +eps and the quotient (4+4, 4+4, 4+4+4), the weight
decay (4+4, 4+4+4), ·lr and the subtraction (4+4, 4+4+4) and the write
of the parameter (4+4): 184 with f32 moments.  int8 moments add each
moment's dequantize (1+4+4, ·scale 4+4) and requantize (|x| 4+4, the row
max 4, the quotient 4+4, round 4+4, clamp 4+4, to int8 4+1), and nu's
square and sqrt (4+4 each): 308.  So a parameter costs ``PARAM`` 26 and
``OPTIMIZER`` 184 with f32 moments, 308 with int8 ones (matrices of at
least 65,536 elements; a smaller leaf keeps f32 moments).

By table, train = 2·forward + backward: attention d 2·14 + 26, q
2·12 + 22, kv 2·8 + 24, RoPE 2·48 + 52, a bias 2·4 + 2; the gated FFN d
2·12 + 16, d_ff 2·16 + 28; the plain one d 2·14 + 4, d_ff 2·12 + 14;
mamba d 2·14 + 26, d_inner 2·122 + 256, N 2·124 + 228, heads 2·28 + 58;
MoE d 2·12 + 16, experts 2·36 + 50, choices·experts 2·18, choices
2·252 + 90, choices·d 2·20 + 22, slots·d 2·14 + 26, slots·width
2·16 + 30.

Decode (one position per row, ``decode_step``) takes other code paths
in attention and mamba.  Attention's query (``attn_decode_step``,
``ref.decode_attention``): the projection writes (2), to f32 (2+4), the
score product reads it (4), the output product writes f32 (4), to bf16
(4+2), wo reads (2): 24; per K or V element the projection writes (2) and
the write into the cache reads the slice and the value and writes the
slice (2+2+2): 16 per KV width.  Mamba's conv is a window step
(``_conv_step``: the f32 tail cast to bf16, the concatenation, to f32, the
f32 tap products and their sum, the cast, the bias, SiLU, the new tail
back to f32) and its SSD the f32 state update and product: 258 per
d_inner, 308 per N, 48 per head.  The MoE's capacity is one slot an
expert a row.  Beside them the caches: ``ref.decode_attention``
casts the valid K and V to f32 (2+4 each) and its two products read them
(4 each): 20 per cached position and KV width; its split-K pieces write
the f32 scores (4), scale them (4+4), read them for the row max (4),
subtract it (4+4), exponentiate (4+4), read them for the row sum (4),
divide by it into bf16 (4+2), back to f32 (2+4) and read them (4): 52
per cached position and query head.  A mamba layer updates
its f32 state in place (·decay 4+4, the new term 4, the add 4+4+4, the
read by the output product 4): 28 per element of [H, N, P].

Left out: terms per token and not per element (a norm's [.., 1]
statistics: under 1 % at d_model 64), per position (RoPE's tables), the
frontends' projections, and a VLM's concatenation.

All results are bytes per step of one device running the rows of the
batch it is given.

*On a mesh, train and prefill* (``launch/train.py``'s tensor-parallel
step; ``tp`` ranks on ``model``, ``dp`` on the data-parallel axes) each
rank computes with its compute slices (``launch/sharding.py:
compute_slice``): the same passes as above over its widths, its query
and KV heads (``common.head_ranges``: rank 0, the one the dry run
traces, has the most), its share of d_ff, of mamba's heads, of the
experts' buffer slots and of the vocabulary; what every rank computes
whole stays whole (the stream's d_model, the router, mamba's B and C, the
MoE's per-choice copies of each token).  Under sequence parallelism the
norms and the residual adds run on the rank's share of the sequence
(``RESIDUAL`` of each sublayer's d constant: the add 2+2+2, twice, and
its gradient's sum, 6). The passes the model axis adds, per d_model
element of the whole sequence and sublayer (``TP_PASSES``): without
sequence parallelism the output's all-reduce copies its operand (2+2)
in each forward, and the input's backward all-reduce copies the gradient
(2+2): train 12, prefill 4; with it, the all-gather on entry copies the
rank's share to put the sequence first (2+2 on S/tp) and the gathered
result back (2+2 on S), the reduce-scatter on exit likewise the other
way, each forward, and the backward the same: train 3·(8 + 8/tp),
prefill 8 + 8/tp.  The vocab-parallel embedding's mask (2+2), in
training its backward (2+2) (``EMBED_TP``), its all-reduce's copy (2+2)
and in training the unembedding input's backward all-reduce copy (2+2).
The expert-parallel MoE's masks of the rank's experts, per token and
choice (two int64 compares 8+1 each, their and 3, the cast 1+2, keep ·
mask 2+2+2, the shifted and clamped index 8+8 twice): 60 (``MOE_EP``,
twice in training).  No collective's own traffic is counted: the wire
prices it.

Each rank then gathers each layer over the data-parallel axes at each use
(``sharding.gather_layer``: twice in training, the forward and the remat
recompute, but the head's leaves once) and reduce-scatters its gradient.
Per parameter element the rank computes with: ``PARAM`` as on one
device; where the leaf is gathered along a dimension other than its first
(``wo``, ``w_down``, ``w_out``, ``out_proj``, the tables, the expert
stacks), each axis' gather (innermost first) copies its operand to put
that dimension first (4+4 f32) and its result back (4+4): ``8 + 8/dp`` a
gather over one axis, more over nested ones (``Mesh.moves``), and the
gradient's reduce-scatter the same: ``GATHER_MOVED``.  A leaf whose
compute slice is not its storage shard (``w_xz``, KV heads split or
shared, query heads the axis does not divide, mamba's per-head vectors)
also gathers over ``model`` and slices (the slice copied, 4+4; along a
dimension other than the first the same moves as above, over tp) and
its gradient is padded with zeros (4 per element of the whole leaf),
the slice written in (4+4) and reduce-scattered: ``GATHER_SLICED`` per
compute element and ``GATHER_PADDED`` per element of the leaf.  Then the
optimizer on the rank's shard: ``OPTIMIZER`` / shards.

*Decode on a mesh* is the same tensor-parallel step on one position a
row (``launch/train.py:make_mesh_decode_step``): the rank's widths and
compute slices, its layers gathered over the data-parallel axes (bf16
parameters: each move, slice and gather copy half the f32 bytes above),
the model axis's passes as prefill's (``TP_PASSES``, ``EMBED_TP``,
``MOE_EP``), and the logits' gather over ``model`` (the rank's columns
moved to the front and the whole row back, ``GATHER_MOVED`` in bf16).
Its cache terms are the rank's part: split by sequence (into
``Mesh.seq_shards``), its positions of every KV head, scored for every
query head; else (by KV head, or positions the guard left whole) every
position of its own KV heads, scored for its query heads.  The
reductions of split-K attention are [rows, heads] and [rows, heads,
head_dim] tensors, left out.  The collectives are priced apart, on the
wire.  The dry run multiplies by the devices for the
global figure.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.common import head_ranges, partition
from repro_torch.models.moe import capacity_per_group

#: a norm's bytes per element of its input: train = 2·forward + backward
NORM = {"rmsnorm": {"train": 200.0, "prefill": 44.0, "decode": 44.0},
        "layernorm": {"train": 228.0, "prefill": 52.0, "decode": 52.0}}
#: the final norm, not recomputed: forward + backward
NORM_HEAD = {"rmsnorm": {"train": 156.0, "prefill": 44.0, "decode": 44.0},
             "layernorm": {"train": 176.0, "prefill": 52.0, "decode": 52.0}}
#: attention beyond its norm, per element: d_model, query width, KV
#: width (K and V together); RoPE per rotated q and k element; a qkv bias
#: per biased q, k and v element
ATTN = {"train": {"d": 54.0, "q": 46.0, "kv": 40.0},
        "prefill": {"d": 14.0, "q": 12.0, "kv": 8.0},
        "decode": {"d": 14.0, "q": 24.0, "kv": 16.0}}
ROPE = {"train": 148.0, "prefill": 48.0, "decode": 48.0}
BIAS = {"train": 10.0, "prefill": 4.0, "decode": 4.0}
#: FFNs beyond their norm: gated (SwiGLU, GeGLU) and plain GELU with biases
FFN = {"train": {"d": 40.0, "ff": 60.0},
       "prefill": {"d": 12.0, "ff": 16.0},
       "decode": {"d": 12.0, "ff": 16.0}}
FFN_PLAIN = {"train": {"d": 32.0, "ff": 38.0},
             "prefill": {"d": 14.0, "ff": 12.0},
             "decode": {"d": 14.0, "ff": 12.0}}
#: mamba beyond its norm: per d_model, d_inner, state (N) and head element
MAMBA = {"train": {"d": 54.0, "di": 500.0, "n": 476.0, "h": 114.0},
         "prefill": {"d": 14.0, "di": 122.0, "n": 124.0, "h": 28.0},
         "decode": {"d": 14.0, "di": 258.0, "n": 308.0, "h": 48.0}}
#: MoE beyond its norm: per d_model element, per token·expert, per
#: token·choice·expert, per token·choice, per token·choice·d_model, per
#: buffer slot·d_model and per slot·expert width
MOE = {"train": {"d": 40.0, "e": 122.0, "ke": 36.0, "k": 594.0,
                 "kd": 62.0, "slot_d": 54.0, "slot_ff": 62.0},
       "prefill": {"d": 12.0, "e": 36.0, "ke": 18.0, "k": 252.0,
                   "kd": 20.0, "slot_d": 14.0, "slot_ff": 16.0},
       "decode": {"d": 12.0, "e": 36.0, "ke": 18.0, "k": 220.0,
                  "kd": 16.0, "slot_d": 14.0, "slot_ff": 16.0}}
#: the head beyond its final norm: per d_model element of each token, per
#: vocabulary entry of each token, and (train) per entry of the S − 1
#: positions the cross entropy reads
EMBED = {"train": 10.0, "prefill": 4.0, "decode": 4.0}
LOGITS = {"train": 8.0, "prefill": 2.0, "decode": 2.0}
CROSS_ENTROPY = 74.0
#: per parameter and step: the compute's passes, and the optimizer's by
#: the moments' dtype
PARAM = {"train": 26.0, "prefill": 8.0, "decode": 2.0}
OPTIMIZER = {"int8": 308.0, "fp32": 184.0}
#: decode: per cached position and KV width, per cached position and
#: query head, per SSM state element
CACHE_KV = 20.0
CACHE_SCORES = 52.0
STATE = 28.0
#: tensor-parallel train and prefill: a sublayer's residual add and its
#: gradient's sum, per d_model element of the stream
RESIDUAL = {"train": 18.0, "prefill": 6.0, "decode": 6.0}
#: a sublayer's model-axis copies without sequence parallelism, per
#: d_model element: the output's all-reduce copy in each forward, the
#: input's backward all-reduce copy
TP_PASSES = {"train": 12.0, "prefill": 4.0, "decode": 4.0}
#: the embedding's vocab-parallel mask (and its backward), per d_model
#: element of each token; its all-reduce's copy adds 4 where the model
#: axis has more than one rank
EMBED_TP = {"train": 8.0, "prefill": 4.0, "decode": 4.0}
#: the expert-parallel MoE's masks, per token and choice
MOE_EP = {"train": 120.0, "prefill": 60.0, "decode": 60.0}
#: a layer's gather over the data-parallel axes along a dimension other
#: than the first: per f32 element each axis' gather copies (and the
#: gradient's reduce-scatter), ``Mesh.moves``
GATHER_MOVED = 8.0
#: a compute slice taken from a leaf gathered over ``model``: the slice's
#: copy per compute element (and its gradient written in), and the zeros
#: per element of the leaf the gradient is padded into
GATHER_SLICED = 8.0
GATHER_PADDED = 4.0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The tensor-parallel step's layout as the model prices it: ``tp``
    ranks on ``model``, the data-parallel axes' sizes (``dp_axes``,
    outermost first), the stream sharded over the sequence (``seqpar``);
    ``shards`` ranks hold the state; a decode cell's KV caches split into
    ``seq_shards`` along their positions (``sharding.decode_shardings``,
    after its guard)."""

    tp: int = 1
    dp_axes: Tuple[int, ...] = (1,)
    seqpar: bool = False
    shards: int = 1
    seq_shards: int = 1

    @property
    def dp(self) -> int:
        return math.prod(self.dp_axes)

    def moves(self) -> float:
        """A gather over the data-parallel axes along a dimension other
        than the first, per element of its result: each axis' gather
        (innermost first) copies its operand and its result; the
        gradient's reduce-scatters the same, outermost first."""
        out, size = 0.0, 1.0 / self.dp
        for n in reversed(self.dp_axes):
            if n > 1:
                out += size + size * n
                size *= n
        return out


def _attn_dims(cfg: ModelConfig, mesh: Optional[Mesh] = None):
    """Query and KV widths: rank 0's heads on a mesh (the most a rank
    has), all of them on one device."""
    if mesh is None or not cfg.num_heads:
        return cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    q0, q1, k0, k1 = head_ranges(cfg.num_heads, cfg.num_kv_heads, mesh.tp, 0)
    return (q1 - q0) * cfg.head_dim, (k1 - k0) * cfg.head_dim


def _share(n: int, mesh: Optional[Mesh]) -> int:
    """Rank 0's share of ``n`` over the model axis (all on one device)."""
    if mesh is None:
        return n
    a, b = partition(n, mesh.tp, 0)
    return b - a


def enc_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """An enc-dec model's encoder positions a row (``input_specs``; a
    decode cell's memory, ``launch/dryrun.py:decode_state``)."""
    S = shape.seq_len
    if shape.kind == "decode":
        return max(128, min(8192, S // 4))
    return max(128, S // 4)


def sublayers(cfg: ModelConfig) -> Dict[str, int]:
    """How many of each sublayer a decoder position runs through:
    attention, mamba, dense FFN and MoE (an enc-dec decoder's self-
    attention; its cross-attention and its encoder are
    :func:`activation_bytes`' own)."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return {"attn": 0, "mamba": L, "ffn": 0, "moe": 0}
    if cfg.is_hybrid:
        n_attn = sum(1 for i in range(L)
                     if i % cfg.attn_layer_period == cfg.attn_layer_offset)
    else:
        n_attn = L
    n_moe = (sum(1 for i in range(L) if i % cfg.moe_layer_period
                 == cfg.moe_layer_period - 1) if cfg.is_moe else 0)
    return {"attn": n_attn, "mamba": L - n_attn, "ffn": L - n_moe,
            "moe": n_moe}


def _stream(kind: str, tokens: float, d: int, d_const: float,
            mesh: Optional[Mesh]) -> float:
    """A sublayer's d_model passes: inside it on the whole sequence, its
    residual add on the stream's share (sequence parallelism), and the
    model axis' own passes (``TP_PASSES``)."""
    if mesh is None:
        return tokens * d * d_const
    share = tokens / mesh.tp if mesh.seqpar else tokens
    res = RESIDUAL[kind]
    out = tokens * d * (d_const - res) + share * d * res
    if mesh.tp > 1:
        if mesh.seqpar:
            per = 8.0 * tokens + 8.0 * share
            out += d * (3.0 * per if kind == "train" else per)
        else:
            out += tokens * d * TP_PASSES[kind]
    return out


def _attention(cfg: ModelConfig, kind: str, tokens: float,
               kv_tokens: float, rope: bool,
               mesh: Optional[Mesh] = None) -> float:
    """One attention sublayer beyond its norm: ``tokens`` queries,
    ``kv_tokens`` keys and values projected."""
    hq, hkv = _attn_dims(cfg, mesh)
    a = ATTN[kind]
    out = _stream(kind, tokens, cfg.d_model, a["d"], mesh) \
        + tokens * hq * a["q"] + kv_tokens * hkv * a["kv"]
    if rope:
        out += (tokens * hq + kv_tokens * hkv) * ROPE[kind]
    if cfg.qkv_bias:
        out += (tokens * hq + 2 * kv_tokens * hkv) * BIAS[kind]
    return out


def _ffn(cfg: ModelConfig, kind: str, tokens: float, d_ff: int,
         mesh: Optional[Mesh] = None) -> float:
    c = (FFN_PLAIN if cfg.act == "gelu" else FFN)[kind]
    return _stream(kind, tokens, cfg.d_model, c["d"], mesh) \
        + tokens * _share(d_ff, mesh) * c["ff"]


def _moe(cfg: ModelConfig, shape: ShapeSpec,
         mesh: Optional[Mesh] = None) -> float:
    kind, B = shape.kind, shape.global_batch
    S = 1 if kind == "decode" else shape.seq_len
    T = float(B * S)
    E, K, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    slots = float(_share(E, mesh) * B * capacity_per_group(cfg, S))
    c = MOE[kind]
    out = (_stream(kind, T, d, c["d"], mesh)
           + T * (E * c["e"] + K * E * c["ke"] + K * c["k"] + K * d * c["kd"])
           + slots * (d * c["slot_d"] + cfg.moe_d_ff * c["slot_ff"]))
    if mesh is not None:
        out += T * K * MOE_EP[kind]
    if cfg.num_shared_experts:
        f = FFN[kind]  # the shared expert's width passes; its d ones are
        # the MoE's own (one input, one summed output)
        out += T * _share(cfg.moe_d_ff * cfg.num_shared_experts,
                          mesh) * f["ff"]
        if mesh is None:
            out += T * d * f["d"]
    return out


def param_bytes_per_step(nparams: int, kind: str, moments: str) -> float:
    """Per device, one device's step: the compute's passes and, to train,
    the optimizer's."""
    opt = OPTIMIZER[moments] if kind == "train" else 0.0
    return nparams * (PARAM[kind] + opt)


def _leaves(cfg: ModelConfig, vocab: int, mesh: Mesh):
    """Rank 0's matrices on the tensor-parallel step, as (elements of its
    compute slice, elements of the whole leaf, gathered along a dimension
    other than its first over dp, sliced from a gather over model: 0 no,
    1 along its first dimension, 2 along another, how many gathers: 2 in
    a remat layer, 1 at the head)."""
    d, tp = cfg.d_model, mesh.tp
    hq, hkv = _attn_dims(cfg, mesh)
    Hq, Hkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    q_sliced = tp > 1 and hq * tp != Hq
    kv_sliced = 2 if tp > 1 and hkv * tp != Hkv else 0
    attn = [(d * hq, d * Hq, False, 2 if q_sliced else 0),
            (d * hkv, d * Hkv, False, kv_sliced),
            (d * hkv, d * Hkv, False, kv_sliced),
            (hq * d, Hq * d, True, 1 if q_sliced else 0)]

    def ffn(width):
        w = _share(width, mesh)
        n = 3 if cfg.act in ("swiglu", "geglu") else 2
        return [(d * w, d * width, False, 0)] * (n - 1) \
            + [(w * d, width * d, True, 0)]

    n = sublayers(cfg)
    out = []
    if cfg.is_encdec:
        out += (cfg.enc_layers + 2 * cfg.num_layers) * attn
        out += (cfg.enc_layers + cfg.num_layers) * ffn(cfg.d_ff)
    else:
        out += n["attn"] * attn + n["ffn"] * ffn(cfg.d_ff)
    if n["mamba"]:
        di, H = cfg.ssm_d_inner, cfg.ssm_heads
        di_r = _share(H, mesh) * cfg.ssm_head_dim
        out += n["mamba"] * [(d * 2 * di_r, d * 2 * di, False,
                              2 if tp > 1 else 0),
                             (d * 2 * cfg.ssm_state, d * 2 * cfg.ssm_state,
                              False, 0),
                             (di_r * d, di * d, True, 0)]
    if n["moe"]:
        E, ff = cfg.num_experts, cfg.moe_d_ff
        e_r = _share(E, mesh)
        # w_gate and w_up [e, d, ff] are gathered along d: with one expert
        # a rank, d leads the storage already and nothing moves; w_down
        # [e, ff, d] always moves
        out += n["moe"] * ([(e_r * d * ff, E * d * ff, e_r > 1, 0)] * 2
                           + [(e_r * d * ff, E * d * ff, True, 0),
                              (d * E, d * E, False, 0)])
        if cfg.num_shared_experts:
            out += n["moe"] * ffn(ff * cfg.num_shared_experts)
    layers = [leaf + (2,) for leaf in out]
    table = (_share(vocab, mesh) * d, vocab * d, True, 0, 1)
    layers += [table] * (1 if cfg.tie_embeddings else 2)
    return layers


def sharded_param_bytes(cfg: ModelConfig, kind: str, nparams: int,
                        vocab: int, moments: str, mesh: Mesh) -> float:
    """Per device, the tensor-parallel step's parameter passes: each
    matrix's compute slice cast and read, gathered over dp and (where its
    slice needs it) over model at each use, its gradient reduced back;
    the optimizer on the rank's shard."""
    opt = OPTIMIZER[moments] / mesh.shards if kind == "train" else 0.0
    train = kind == "train"
    # the f32 masters' moves; a decode cell's bf16 parameters move half
    half = 0.5 if kind == "decode" else 1.0
    out = nparams * opt
    rest = float(nparams)
    for compute, whole, moved, sliced, gathers in _leaves(cfg, vocab, mesh):
        rest -= whole
        uses = gathers + 1 if train else 1  # + the gradient's reduction
        out += compute * PARAM[kind]
        if moved:
            out += uses * compute * GATHER_MOVED * half * mesh.moves()
        if sliced:
            out += uses * compute * GATHER_SLICED * half
            if sliced == 2:  # the gather over model, after those over
                # dp, moves its dimension: the whole leaf comes out
                out += uses * whole * GATHER_MOVED * half * (
                    1.0 + 1.0 / mesh.tp)
            if train:  # the gradient padded to the whole leaf
                out += whole * GATHER_PADDED
    if cfg.tie_embeddings:  # the tied table's second use
        out += _share(vocab, mesh) * cfg.d_model * PARAM[kind]
    # norms, biases, mamba's small leaves: whole on every rank
    return out + max(rest, 0.0) * PARAM[kind]


def activation_bytes(cfg: ModelConfig, shape: ShapeSpec,
                     mesh: Optional[Mesh] = None) -> float:
    """Every layer's activation traffic (decode: one position a row),
    each sublayer's norm included; an enc-dec model's encoder runs its
    own positions (:func:`enc_len`).  ``mesh``: rank 0's share on the
    tensor-parallel step."""
    kind = shape.kind
    T = float(shape.global_batch if kind == "decode" else shape.tokens)
    d = cfg.d_model
    norm = NORM[cfg.norm][kind]
    n = sublayers(cfg)
    rope = cfg.pos_embed == "rope"
    stream = T / mesh.tp if mesh is not None and mesh.seqpar else T
    out = 0.0
    if cfg.is_encdec:
        Te = float(shape.global_batch * enc_len(cfg, shape))
        if kind != "decode":  # the encoder, its final norm, and the
            # memory's K and V projected in each decoder layer
            out += cfg.enc_layers * (
                2 * Te * d * norm + _attention(cfg, kind, Te, Te, False, mesh)
                + _ffn(cfg, kind, Te, cfg.d_ff, mesh))
            out += Te * d * NORM_HEAD[cfg.norm][kind]
            cross_kv = Te
            if mesh is not None and mesh.tp > 1 and kind == "train":
                # the memory's backward all-reduce copy in each layer
                out += cfg.num_layers * Te * d * 4.0
        else:  # a decode step's memory K and V are the cache's
            cross_kv = 0.0
        out += cfg.num_layers * (T * d * norm + _attention(
            cfg, kind, T, cross_kv, False, mesh))
    out += n["attn"] * (stream * d * norm
                        + _attention(cfg, kind, T, T, rope, mesh))
    if n["mamba"]:
        m = MAMBA[kind]
        di = _share(cfg.ssm_heads, mesh) * cfg.ssm_head_dim
        out += n["mamba"] * (
            stream * d * norm + _stream(kind, T, d, m["d"], mesh)
            + T * (di * m["di"] + cfg.ssm_state * m["n"]
                   + di // cfg.ssm_head_dim * m["h"]))
    out += n["ffn"] * (stream * d * norm
                       + _ffn(cfg, kind, T, cfg.d_ff, mesh))
    if n["moe"]:
        out += n["moe"] * (stream * d * norm + _moe(cfg, shape, mesh))
    return out


def logits_bytes(cfg: ModelConfig, shape: ShapeSpec, vocab: int,
                 mesh: Optional[Mesh] = None) -> float:
    """The embedding, the final norm, the unembedding and (training) the
    cross entropy; ``vocab`` is the padded vocabulary the logits cover
    (``mesh``: rank 0's columns, and the vocab-parallel passes)."""
    kind = shape.kind
    T = float(shape.global_batch if kind == "decode" else shape.tokens)
    stream = T / mesh.tp if mesh is not None and mesh.seqpar else T
    cols = _share(vocab, mesh)
    d = cfg.d_model
    out = stream * d * NORM_HEAD[cfg.norm][kind] + T * d * EMBED[kind] \
        + T * cols * LOGITS[kind]
    if mesh is not None:
        out += T * d * EMBED_TP[kind]
        if mesh.tp > 1:  # the all-reduce's copy, and in training the
            # unembedding input's backward all-reduce copy
            out += T * d * (8.0 if kind == "train" else 4.0)
        if mesh.tp > 1 and kind == "decode":  # the logits gathered whole
            out += T * (cols + vocab) * GATHER_MOVED / 2
    if kind == "train":
        out += (shape.global_batch * (shape.seq_len - 1) * cols
                * CROSS_ENTROPY)
    return out


def cache_bytes(cfg: ModelConfig, shape: ShapeSpec,
                mesh: Optional[Mesh] = None) -> float:
    """Decode: the KV caches read (with the f32 scores), an enc-dec
    model's cross K and V read by the kernel, and the SSM states
    updated; ``mesh``: rank 0's part (split by sequence: its positions
    of every KV head, scored for every query head; else every position of
    its own KV heads, scored for its query heads)."""
    if shape.kind != "decode":
        return 0.0
    B, S = float(shape.global_batch), float(shape.seq_len)
    hq, hkv = cfg.num_heads, cfg.num_kv_heads * cfg.head_dim
    pos, frames = S, float(enc_len(cfg, shape))
    if mesh is not None and mesh.seq_shards > 1:
        pos, frames = pos / mesh.seq_shards, frames / mesh.seq_shards
    elif mesh is not None:
        q_width, hkv = _attn_dims(cfg, mesh)
        hq = q_width // max(1, cfg.head_dim)
    n = sublayers(cfg)
    out = n["attn"] * B * pos * (hkv * CACHE_KV + hq * CACHE_SCORES)
    if cfg.is_encdec:  # the kernel reads the cross K and V (2 + 2)
        out += cfg.num_layers * B * frames * hkv * 4.0
    if n["mamba"]:
        di = _share(cfg.ssm_heads, mesh) * cfg.ssm_head_dim
        out += n["mamba"] * B * di * cfg.ssm_state * STATE
    return out


def traffic_bytes(cfg: ModelConfig, shape: ShapeSpec, nparams: int,
                  vocab: int, moments: str = "int8",
                  mesh: Optional[Mesh] = None) -> Dict[str, float]:
    """HBM bytes per step of one device running ``shape``'s rows, by
    component.  ``mesh``: the tensor-parallel step on a mesh (rank 0's);
    without it one device's step."""
    if mesh is not None:
        out = {
            "params": sharded_param_bytes(cfg, shape.kind, nparams, vocab,
                                          moments, mesh),
            "activations": activation_bytes(cfg, shape, mesh),
            "logits": logits_bytes(cfg, shape, vocab, mesh),
            "cache": cache_bytes(cfg, shape, mesh),
        }
        out["total"] = sum(out.values())
        return out
    # a tied table is cast and read at both its uses, updated once
    tied = vocab * cfg.d_model * PARAM[shape.kind] if cfg.tie_embeddings \
        else 0.0
    out = {
        "params": param_bytes_per_step(nparams, shape.kind, moments) + tied,
        "activations": activation_bytes(cfg, shape),
        "logits": logits_bytes(cfg, shape, vocab),
        "cache": cache_bytes(cfg, shape),
    }
    out["total"] = sum(out.values())
    return out
