"""The paper's own pipeline configuration (festivus + imagery apps).

Not an LM architecture — this is the configuration object for the satellite
imagery substrate: tiling parameters (§III.C), festivus mount settings
(§III.B), and the processing campaigns of §V (calibration, composite,
segmentation).  Values mirror the paper where it states them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.festivus import FestivusConfig
from repro_torch.core.tiling import UTMGridSpec


@dataclasses.dataclass(frozen=True)
class ImageryConfig:
    #: Landsat-like synthetic scenes: bands stored per tile
    bands: int = 4  # red, nir, green, blue (enough for NDVI + cloud mask)
    #: paper's field-segmentation tile: "6144 x 6144 pixels at 10 m"
    segmentation_tile_px: int = 6144
    #: paper's global composite: 15 m output, ~43k tiles
    composite_resolution_m: float = 15.0
    composite_tile_px: int = 4096
    #: §V.B temporal stack depth (images per tile across sensors/years)
    temporal_depth: int = 16
    #: cloud-mask threshold (Oreopoulos-style simple mask; [12] in paper)
    cloud_reflectance_threshold: float = 0.35
    #: edge threshold on the temporal-mean gradient image
    edge_threshold: float = 0.12
    #: chunk layout for stored tiles (the 4 MiB block-size lesson:
    #: 1024 x 1024 x 4 bands x uint16 = 8 MiB/chunk before compression)
    chunk_px: int = 1024
    codec: str = "zlib"

    def utm_spec(self, resolution_m: float | None = None) -> UTMGridSpec:
        return UTMGridSpec(tile_px=self.composite_tile_px, border_px=16,
                           resolution_m=resolution_m
                           or self.composite_resolution_m)

    def festivus_config(self) -> FestivusConfig:
        return FestivusConfig()  # 4 MiB blocks — Table IV's optimum


DEFAULT = ImageryConfig()

#: reduced config for CPU tests/examples
SMOKE = ImageryConfig(
    bands=4,
    segmentation_tile_px=96,
    composite_tile_px=64,
    temporal_depth=6,
    chunk_px=32,
)
