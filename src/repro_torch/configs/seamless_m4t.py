"""seamless-m4t-large-v2 — enc-dec multimodal (audio) [arXiv:2308.11596; hf].

Assigned spec: 24L, d_model=1024, 16H (GQA kv=16), d_ff=8192, vocab=256206.
Interpretation: 24 encoder + 24 decoder layers (the HF checkpoint runs 24
per stack); plain-GELU FFN, LayerNorm, sinusoidal positions.  The speech
frontend (w2v-BERT conformer stack) is a STUB per the harness spec:
`input_specs` supplies precomputed 1024-dim frame embeddings at ~seq/4
frames.  Decode shapes lower the decoder step (self+cross KV caches);
long_500k skipped (full attention).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="seamless-m4t-large-v2",
    family="encdec",
    source="arXiv:2308.11596; hf",
    num_layers=24,  # decoder
    enc_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    act="gelu",
    norm="layernorm",
    pos_embed="sinusoidal",
    frontend_dim=1024,
    tie_embeddings=True,
    shape_names=("train_4k", "prefill_32k", "decode_32k"),
)

SMOKE = ModelConfig(
    arch_id="seamless-m4t-large-v2-smoke",
    family="encdec",
    num_layers=2,
    enc_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    act="gelu",
    norm="layernorm",
    pos_embed="sinusoidal",
    frontend_dim=48,
    attention_impl="ref",
)

register(FULL, SMOKE)
