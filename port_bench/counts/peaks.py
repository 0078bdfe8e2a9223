"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

#: bf16 tensor-core operations a second
BF16_OPS_PER_S = 989e12
#: float32 operations a second outside the tensor cores
F32_OPS_PER_S = 67e12
#: HBM3 bytes a second
HBM_BYTES_PER_S = 3.35e12
