"""jamba-v0.1-52b — hybrid Mamba+attention 1:7, MoE [arXiv:2403.19887; hf].

Assigned spec: 32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536,
MoE 16 experts top-2.  Structure per the paper: one attention layer per 8
(offset 4 — mid-block), MoE replacing the MLP every other layer.

Adaptation note (DESIGN.md §Arch-applicability): Jamba v0.1 uses Mamba-1
selective-scan internals (d_state=16); we realize the SSM sublayers with
the Mamba-2 SSD formulation at the same state size — the SSD paper shows
the two are duals, and SSD is the TPU-native (MXU-friendly) algorithm.

Runs long_500k: only 4 of 32 layers carry a 512k KV cache (sequence-sharded
over the mesh), the rest hold O(1) SSM state.
"""

from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    arch_id="jamba-v0.1-52b",
    family="hybrid",
    source="arXiv:2403.19887; hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    act="swiglu",
    norm="rmsnorm",
    num_experts=16,
    experts_per_token=2,
    moe_layer_period=2,
    attn_layer_period=8,
    attn_layer_offset=4,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    tie_embeddings=False,
    shape_names=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ModelConfig(
    arch_id="jamba-smoke",
    family="hybrid",
    num_layers=8,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    act="swiglu",
    norm="rmsnorm",
    num_experts=4,
    experts_per_token=2,
    moe_layer_period=2,
    attn_layer_period=4,
    attn_layer_offset=2,
    ssm_state=8,
    ssm_head_dim=16,
    ssm_expand=2,
    tie_embeddings=False,
    attention_impl="ref",
)

register(FULL, SMOKE)
