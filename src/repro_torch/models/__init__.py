"""Model zoo, dense and ssm families: parameters are plain dicts of
tensors, layers a Python loop; attention goes through the hand-written
flash kernel on the card, the Mamba-2 SSD through the hand-written SSD
kernel.
"""

from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
