"""llama3-8b — dense GQA, 128k vocab [arXiv:2407.21783; unverified].

Assigned spec: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=128256.
long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="llama3-8b",
    family="dense",
    source="arXiv:2407.21783; unverified",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=5e5,
    tie_embeddings=False,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="llama3-8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    attention_impl="ref",
)

register(FULL, SMOKE)
