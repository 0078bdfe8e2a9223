"""llama4-maverick-400b-a17b — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Assigned spec: 48L, d_model=5120, 40H (GQA kv=8), d_ff=8192, vocab=202048,
MoE 128 experts top-1 (+1 shared expert, per the published Maverick design).
Text trunk only (the early-fusion vision tower is outside the assigned
backbone).  long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=5e5,
    num_experts=128,
    experts_per_token=1,
    num_shared_experts=1,
    tie_embeddings=False,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="llama4-maverick-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    act="swiglu",
    norm="rmsnorm",
    num_experts=8,
    experts_per_token=1,
    num_shared_experts=1,
    tie_embeddings=False,
    attention_impl="ref",
)

register(FULL, SMOKE)
