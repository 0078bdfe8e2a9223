"""mamba2-2.7b — attention-free SSM (SSD) [arXiv:2405.21060; unverified].

Assigned spec: 64L, d_model=2560, d_ff=0 (pure Mamba blocks, no MLP),
vocab=50280, ssm_state=128.  d_inner = 2*d_model = 5120, head_dim 64 ->
80 SSD heads.  Runs all four shape cells including long_500k: decode state
is O(1) in context length (that is the architecture's point).
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060; unverified",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    norm="rmsnorm",
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
    shape_names=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    arch_id="mamba2-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    norm="rmsnorm",
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    attention_impl="ref",
)

register(FULL, SMOKE)
