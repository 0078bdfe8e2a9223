"""qwen1.5-4b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf].

Assigned spec: 40L, d_model=2560, 20H (GQA kv=20 == MHA), d_ff=6912,
vocab=151936.  SwiGLU, RMSNorm, RoPE, QKV bias, tied embeddings.
long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="qwen1.5-4b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B; hf",
    num_layers=40,
    d_model=2560,
    num_heads=20,
    num_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    tie_embeddings=True,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="qwen1.5-4b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    attention_impl="ref",
)

register(FULL, SMOKE)
