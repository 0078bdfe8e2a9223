"""internvl2-1b — VLM: InternViT + InternLM2/Qwen2-0.5B LM
[arXiv:2404.16821; hf].

Assigned spec (LM backbone): 24L, d_model=896, 14H (GQA kv=2), d_ff=4864,
vocab=151655.  The InternViT vision tower is a STUB per the harness spec:
`input_specs` supplies 256 precomputed 1024-dim patch embeddings per image,
projected and prepended to the token sequence (so a train_4k cell carries
256 vision + 3840 text positions).  long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="internvl2-1b",
    family="vlm",
    source="arXiv:2404.16821; hf",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    rope_theta=1e6,
    tie_embeddings=True,
    frontend_tokens=256,
    frontend_dim=1024,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="internvl2-1b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    act="swiglu",
    norm="rmsnorm",
    frontend_tokens=8,
    frontend_dim=48,
    attention_impl="ref",
)

register(FULL, SMOKE)
