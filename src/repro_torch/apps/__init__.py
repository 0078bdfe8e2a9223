"""The paper's applications on the card: the §V.C cloud-free composite and
the §V.B field segmentation."""

from repro_torch.apps.composite import composite_tile, run_composite_campaign
from repro_torch.apps.segmentation import (
    run_segmentation_campaign,
    segment_tile,
    segment_to_store,
)

__all__ = ["composite_tile", "run_composite_campaign",
           "run_segmentation_campaign", "segment_tile", "segment_to_store"]
