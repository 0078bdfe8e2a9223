"""gemma-7b — dense, GeGLU, head_dim=256 [arXiv:2403.08295; hf].

Assigned spec: 28L, d_model=3072, 16H (GQA kv=16), d_ff=24576, vocab=256000.
Gemma particulars kept: explicit head_dim=256 (so QKV projects 3072->4096),
GeGLU activation, embeddings scaled by sqrt(d_model), tied embeddings.
long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="gemma-7b",
    family="dense",
    source="arXiv:2403.08295; hf",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="geglu",
    norm="rmsnorm",
    rope_theta=1e4,
    embed_scale=True,
    tie_embeddings=True,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="gemma-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    act="geglu",
    norm="rmsnorm",
    embed_scale=True,
    attention_impl="ref",
)

register(FULL, SMOKE)
