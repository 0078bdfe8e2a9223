"""Model zoo, every family (dense, moe, ssm, hybrid, VLM, enc-dec):
parameters are plain dicts of tensors, layers a Python loop; attention
(self-, bidirectional and cross-attention) goes through the hand-written
flash kernel on the card, the Mamba-2 SSD through the hand-written SSD
kernel, the MoE's experts through cuBLAS batched matmuls.  Training adds
f32 master weights (``init(seed, param_dtype=torch.float32)``), remat and
``common.cross_entropy``.
"""

from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
