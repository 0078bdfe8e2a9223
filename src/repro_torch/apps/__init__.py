"""The paper's applications on the card: the §V.A calibration, the §V.C
cloud-free composite and the §V.B field segmentation."""

from repro_torch.apps.calibration import (
    SceneMeta,
    make_raw_scene,
    process_scene,
    run_campaign,
    toa_reflectance,
)
from repro_torch.apps.composite import composite_tile, run_composite_campaign
from repro_torch.apps.segmentation import (
    run_segmentation_campaign,
    segment_tile,
    segment_to_store,
)

__all__ = [
    "SceneMeta", "composite_tile", "make_raw_scene", "process_scene",
    "run_campaign", "run_composite_campaign", "run_segmentation_campaign",
    "segment_tile", "segment_to_store", "toa_reflectance",
]
