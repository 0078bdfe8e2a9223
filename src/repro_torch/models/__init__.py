"""Model zoo, dense family: parameters are plain dicts of tensors, layers a
Python loop, attention through the hand-written flash kernel on the card.
"""

from repro_torch.models.model_zoo import Model, build

__all__ = ["Model", "build"]
