"""qwen2-72b — dense GQA, QKV bias [arXiv:2407.10671; hf].

Assigned spec: 80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.
long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="qwen2-72b",
    family="dense",
    source="arXiv:2407.10671; hf",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    tie_embeddings=False,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="qwen2-72b-smoke",
    family="dense",
    num_layers=3,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=False,
    attention_impl="ref",
)

register(FULL, SMOKE)
