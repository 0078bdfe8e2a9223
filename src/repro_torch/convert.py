"""The state carried from the JAX package to the port.

This system has no model weights.  Its state is the bucket (chunked arrays
behind Festivus, which both packages read and write byte for byte) and the
:class:`ImageryConfig`.  A configuration crosses over as the plain dict of
its fields (``dataclasses.asdict`` of the JAX package's config); a tile's
stack crosses over as numpy arrays and is moved to the device here.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.festivus_imagery import ImageryConfig


def imagery_config_from_dict(d: Mapping) -> ImageryConfig:
    """``dataclasses.asdict`` of an ``ImageryConfig`` -> the port's config.
    Raises on a field the port does not know, rather than dropping it."""
    names = {f.name for f in dataclasses.fields(ImageryConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown ImageryConfig fields {sorted(unknown)}")
    return ImageryConfig(**dict(d))


def stack_to_device(images: np.ndarray, valid: Optional[np.ndarray],
                    device: torch.device
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A tile's numpy stack (images [T, H, W, C], valid [T, H, W] or None)
    -> contiguous tensors on ``device``, one copy each."""
    imgs = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    if valid is None:
        return imgs, None
    return imgs, torch.from_numpy(np.ascontiguousarray(valid)).to(device)
