"""Config schema: architectures, input shapes, and the registry.

Every assigned architecture is one `ModelConfig` in `configs/<id>.py` with
the exact published hyperparameters, plus a reduced `smoke()` variant of the
same family for CPU tests.  Input-shape sets (train_4k / prefill_32k /
decode_32k / long_500k) are defined here once and referenced per arch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One input-shape cell: what step we lower and at what size."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


#: The assigned LM shape set (shapes are seq_len x global_batch).
SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str = ""  # provenance, e.g. "arXiv:2407.10671; hf"

    # transformer trunk
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    qkv_bias: bool = False
    act: str = "swiglu"  # swiglu | geglu | gelu (non-gated)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 1e4
    pos_embed: str = "rope"  # rope | sinusoidal (seamless enc/dec)
    embed_scale: bool = False  # gemma: embeddings * sqrt(d_model)
    tie_embeddings: bool = True

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0  # 0 -> d_ff
    num_shared_experts: int = 0
    moe_layer_period: int = 1  # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2 / jamba mamba sublayers)
    ssm_state: int = 0  # N
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2  # d_inner = expand * d_model
    ssm_conv_width: int = 4

    # hybrid (jamba)
    attn_layer_period: int = 0  # one attention layer per this many (0 = all attn)
    attn_layer_offset: int = 0

    # encoder-decoder (seamless)
    enc_layers: int = 0  # >0 -> enc-dec model; num_layers = decoder layers

    # modality frontend stub (vlm / audio): precomputed embeddings prepended
    frontend_tokens: int = 0  # e.g. 256 vision patches / audio frames
    frontend_dim: int = 0  # raw frontend feature dim (projected to d_model)

    # which shape cells apply (documented skips live in DESIGN.md)
    shape_names: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")

    # runtime knobs
    dtype: str = "bfloat16"
    remat: bool = True
    #: "full" recomputes everything in backward (min memory);
    #: "dots" saves matmul outputs (jax dots_with_no_batch_dims_saveable):
    #: ~25% less recompute FLOPs for a few hundred MB/device at mb=16
    remat_policy: str = "full"
    attention_impl: str = "auto"  # auto | ref | chunked | pallas
    #: Megatron-style sequence parallelism: the residual stream is sharded
    #: over `model` on the sequence axis between blocks, turning per-block
    #: TP all-reduces into reduce-scatter/all-gather pairs and de-duplicating
    #: norm compute (halves TP activation-collective bytes)
    sequence_parallel: bool = False
    #: fully unroll the layer scan (cost-probe lowerings only: XLA's
    #: cost_analysis counts while bodies once, so the dry-run reconstructs
    #: true per-step cost from unrolled 1- and 2-layer probes)
    scan_unroll: bool = False

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_experts and self.moe_d_ff == 0:
            object.__setattr__(self, "moe_d_ff", self.d_ff)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.attn_layer_period > 0

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def shapes(self) -> Dict[str, ShapeSpec]:
        return {n: SHAPES[n] for n in self.shape_names}

    # -- parameter counting (for roofline MODEL_FLOPS = 6*N*D) --------------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hq = self.num_heads * self.head_dim
        hkv = self.num_kv_heads * self.head_dim

        def attn_params() -> int:
            return d * hq + 2 * d * hkv + hq * d  # wq, wk, wv, wo

        def dense_ffn(width: int) -> int:
            if self.act in ("swiglu", "geglu"):
                return 3 * d * width
            return 2 * d * width

        def moe_ffn() -> int:
            e = (self.experts_per_token if active_only else self.num_experts)
            e += self.num_shared_experts
            router = d * self.num_experts
            return e * 3 * d * self.moe_d_ff + router

        def mamba_params() -> int:
            di, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * n + h)  # x, z, B, C, dt
            conv = (di + 2 * n) * self.ssm_conv_width
            return in_proj + conv + 2 * h + di * d  # + A_log, D, out_proj

        total = 0
        n_layers = self.num_layers
        for layer in range(n_layers):
            if self.family == "ssm":
                total += mamba_params()
                continue
            if self.is_hybrid:
                is_attn = (layer % self.attn_layer_period) == self.attn_layer_offset
                total += attn_params() if is_attn else mamba_params()
            else:
                total += attn_params()
            if self.is_moe and (layer % self.moe_layer_period
                                == self.moe_layer_period - 1):
                total += moe_ffn()
            elif ff:
                total += dense_ffn(ff)
        if self.is_encdec:
            enc = self.enc_layers * (attn_params() + dense_ffn(ff))
            cross = self.num_layers * attn_params()
            total += enc + cross
        total += v * d  # embedding (tied)
        if not self.tie_embeddings:
            total += v * d
        return total


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, "ConfigEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    full: ModelConfig
    smoke: ModelConfig


def register(full: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    if full.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch {full.arch_id}")
    _REGISTRY[full.arch_id] = ConfigEntry(full=full, smoke=smoke)
    return full


def get_config(arch_id: str, variant: str = "full") -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    entry = _REGISTRY[arch_id]
    return entry.full if variant == "full" else entry.smoke


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import all config modules exactly once
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        dbrx_132b,
        festivus_imagery,
        gemma_7b,
        internvl2_1b,
        jamba_v01_52b,
        llama3_8b,
        llama4_maverick,
        mamba2_2p7b,
        qwen15_4b,
        qwen2_72b,
        seamless_m4t,
    )
