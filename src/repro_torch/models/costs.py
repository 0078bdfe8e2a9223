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
(4 each): 20 per cached position and KV width; the f32 scores are written
(4), scaled (4+4), softmaxed (4+4), cast to bf16 and back (4+2, 2+4) and
read (4): 36 per cached position and query head.  A mamba layer updates
its f32 state in place (·decay 4+4, the new term 4, the add 4+4+4, the
read by the output product 4): 28 per element of [H, N, P].

Left out: terms per token and not per element (a norm's [.., 1]
statistics: under 1 % at d_model 64), per position (RoPE's tables), the
frontends' projections, and a VLM's concatenation.

All results are bytes per step of one device running the rows of the
batch it is given.  With the state sharded over ``shards`` ranks
(``launch/train.py``'s mesh step) each rank gathers every leaf whole and
computes with it as above, and runs the optimizer on its own shard: per
parameter ``PARAM`` + copies · ``GATHER_COPY`` + ``OPTIMIZER`` / shards.
Gathering a leaf along a mesh axis that shards a dimension other than
its first concatenates the chunks (4+4 an f32 element): the rule table
shards a matrix's second dimension along the model axis only, one copy,
and an MoE's expert stack [E, d, ff] along a dimension other than its
first on every mesh axis, one copy an axis (2 on 16 × 16, 3 on
2 × 16 × 16).  A matrix sharded along its first dimension alone needs
none, so one copy a matrix is an upper bound.  The collectives are
priced apart, on the wire.  The dry run multiplies by the devices for the
global figure.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeSpec
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
CACHE_SCORES = 36.0
STATE = 28.0
#: on a mesh, per parameter each rank gathers whole: the gathered chunks
#: concatenated along the dimension they shard (f32 4+4; bf16 2+2)
GATHER_COPY = {"train": 8.0, "prefill": 8.0, "decode": 4.0}


def _attn_dims(cfg: ModelConfig):
    hq = cfg.num_heads * cfg.head_dim
    hkv = cfg.num_kv_heads * cfg.head_dim
    return hq, hkv


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


def _attention(cfg: ModelConfig, kind: str, tokens: float,
               kv_tokens: float, rope: bool) -> float:
    """One attention sublayer beyond its norm: ``tokens`` queries,
    ``kv_tokens`` keys and values projected."""
    hq, hkv = _attn_dims(cfg)
    a = ATTN[kind]
    out = tokens * (cfg.d_model * a["d"] + hq * a["q"]) \
        + kv_tokens * hkv * a["kv"]
    if rope:
        out += (tokens * hq + kv_tokens * hkv) * ROPE[kind]
    if cfg.qkv_bias:
        out += (tokens * hq + 2 * kv_tokens * hkv) * BIAS[kind]
    return out


def _ffn(cfg: ModelConfig, kind: str, tokens: float, d_ff: int) -> float:
    c = (FFN_PLAIN if cfg.act == "gelu" else FFN)[kind]
    return tokens * (cfg.d_model * c["d"] + d_ff * c["ff"])


def _moe(cfg: ModelConfig, shape: ShapeSpec) -> float:
    kind, B = shape.kind, shape.global_batch
    S = 1 if kind == "decode" else shape.seq_len
    T = float(B * S)
    E, K, d = cfg.num_experts, cfg.experts_per_token, cfg.d_model
    slots = float(E * B * capacity_per_group(cfg, S))
    c = MOE[kind]
    out = (T * (d * c["d"] + E * c["e"] + K * E * c["ke"] + K * c["k"]
                + K * d * c["kd"])
           + slots * (d * c["slot_d"] + cfg.moe_d_ff * c["slot_ff"]))
    if cfg.num_shared_experts:
        out += _ffn(cfg, kind, T, cfg.moe_d_ff * cfg.num_shared_experts)
    return out


def param_bytes_per_step(nparams: int, kind: str, moments: str,
                         shards: int = 1, copies: float = 1.0) -> float:
    """Per device: ``shards`` ranks hold the state between them (1: one
    device holds it all), each parameter gathered with ``copies``
    concatenations on average."""
    opt = OPTIMIZER[moments] if kind == "train" else 0.0
    if shards <= 1:
        return nparams * (PARAM[kind] + opt)
    return nparams * (PARAM[kind] + copies * GATHER_COPY[kind]
                      + opt / shards)


def expert_params(cfg: ModelConfig) -> int:
    """The parameters of the MoE layers' expert stacks."""
    if not cfg.is_moe:
        return 0
    return (sublayers(cfg)["moe"] * cfg.num_experts * 3 * cfg.d_model
            * cfg.moe_d_ff)


def activation_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Every layer's activation traffic (decode: one position a row),
    each sublayer's norm included; an enc-dec model's encoder runs its
    own positions (:func:`enc_len`)."""
    kind = shape.kind
    T = float(shape.global_batch if kind == "decode" else shape.tokens)
    d = cfg.d_model
    norm = NORM[cfg.norm][kind]
    n = sublayers(cfg)
    rope = cfg.pos_embed == "rope"
    out = 0.0
    if cfg.is_encdec:
        Te = float(shape.global_batch * enc_len(cfg, shape))
        if kind != "decode":  # the encoder, its final norm, and the
            # memory's K and V projected in each decoder layer
            out += cfg.enc_layers * (
                2 * Te * d * norm + _attention(cfg, kind, Te, Te, False)
                + _ffn(cfg, kind, Te, cfg.d_ff))
            out += Te * d * NORM_HEAD[cfg.norm][kind]
            cross_kv = Te
        else:  # a decode step's memory K and V are the cache's
            cross_kv = 0.0
        out += cfg.num_layers * (T * d * norm + _attention(
            cfg, kind, T, cross_kv, False))
    out += n["attn"] * (T * d * norm + _attention(cfg, kind, T, T, rope))
    if n["mamba"]:
        m = MAMBA[kind]
        out += n["mamba"] * T * (
            d * (norm + m["d"]) + cfg.ssm_d_inner * m["di"]
            + cfg.ssm_state * m["n"] + cfg.ssm_heads * m["h"])
    out += n["ffn"] * (T * d * norm + _ffn(cfg, kind, T, cfg.d_ff))
    if n["moe"]:
        out += n["moe"] * (T * d * norm + _moe(cfg, shape))
    return out


def logits_bytes(cfg: ModelConfig, shape: ShapeSpec, vocab: int) -> float:
    """The embedding, the final norm, the unembedding and (training) the
    cross entropy; ``vocab`` is the padded vocabulary the logits cover."""
    kind = shape.kind
    T = float(shape.global_batch if kind == "decode" else shape.tokens)
    out = T * cfg.d_model * (NORM_HEAD[cfg.norm][kind] + EMBED[kind]) \
        + T * vocab * LOGITS[kind]
    if kind == "train":
        out += (shape.global_batch * (shape.seq_len - 1) * vocab
                * CROSS_ENTROPY)
    return out


def cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Decode: the KV caches read (with the f32 scores), an enc-dec
    model's cross K and V read by the kernel, and the SSM states
    updated."""
    if shape.kind != "decode":
        return 0.0
    B, S = float(shape.global_batch), float(shape.seq_len)
    _, hkv = _attn_dims(cfg)
    n = sublayers(cfg)
    out = n["attn"] * B * S * (hkv * CACHE_KV + cfg.num_heads * CACHE_SCORES)
    if cfg.is_encdec:  # the kernel reads the cross K and V (2 + 2)
        out += cfg.num_layers * B * enc_len(cfg, shape) * hkv * 4.0
    if n["mamba"]:
        out += n["mamba"] * B * cfg.ssm_d_inner * cfg.ssm_state * STATE
    return out


def traffic_bytes(cfg: ModelConfig, shape: ShapeSpec, nparams: int,
                  vocab: int, moments: str = "int8",
                  shards: int = 1, mesh_axes: int = 2
                  ) -> Dict[str, float]:
    """HBM bytes per step of one device running ``shape``'s rows, by
    component; ``shards`` ranks of a mesh of ``mesh_axes`` axes hold the
    state (1: this device alone)."""
    # a tied table is cast and read at both its uses, updated once
    tied = vocab * cfg.d_model * PARAM[shape.kind] if cfg.tie_embeddings \
        else 0.0
    # one gather copy a matrix, one a mesh axis for an expert stack
    copies = 1.0 + (mesh_axes - 1) * expert_params(cfg) / max(1, nparams)
    out = {
        "params": param_bytes_per_step(nparams, shape.kind, moments,
                                       shards, copies) + tied,
        "activations": activation_bytes(cfg, shape),
        "logits": logits_bytes(cfg, shape, vocab),
        "cache": cache_bytes(cfg, shape),
    }
    out["total"] = sum(out.values())
    return out
