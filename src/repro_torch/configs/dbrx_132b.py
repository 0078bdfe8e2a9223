"""dbrx-132b — fine-grained MoE [hf:databricks/dbrx-base; unverified].

Assigned spec: 40L, d_model=6144, 48H (GQA kv=8), d_ff=10752 (per expert),
vocab=100352, MoE 16 experts top-4.  LayerNorm trunk, SwiGLU experts, RoPE.
long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base; unverified",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    act="swiglu",
    norm="layernorm",
    rope_theta=5e5,
    num_experts=16,
    experts_per_token=4,
    tie_embeddings=False,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="dbrx-132b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    act="swiglu",
    norm="layernorm",
    num_experts=4,
    experts_per_token=2,
    tie_embeddings=False,
    attention_impl="ref",
)

register(FULL, SMOKE)
