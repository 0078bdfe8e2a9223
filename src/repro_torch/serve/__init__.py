"""Serving tier — the paper's Mapserver-over-festivus role (§V.D).

The paper's web visualization "decodes JPEG 2000 imagery at the resolution
requested" behind Mapserver, on the same bucket the analytic campaigns
scan.  This package is that role over the repo's stack: XYZ-style tile
requests map onto :class:`~repro_torch.core.chunkstore.ChunkedArray` pyramid
reads through a per-server festivus mount, fronted by an LRU tile cache,
and a :class:`TileFleet` runs N servers as cluster-engine workers so
request I/O is water-filled on the same simulated zone fabric as any
concurrently-running batch campaign (the mixed-workload story of
Sector/Sphere and the Matsu wheel: serving and scanning share one
chunkstore).
"""

from repro_torch.serve.autoscale import (
    AutoscaleAction,
    AutoscalePolicy,
    AutoscaleReport,
    ServeAutoscaler,
)
from repro_torch.serve.geo import (
    GeoServingReport,
    GeoTileFleet,
    RegionalAutoscalers,
    serve_pool,
)
from repro_torch.serve.tileserver import (
    EdgeCache,
    EdgeCacheStats,
    ServingReport,
    TileCache,
    TileCacheStats,
    TileFleet,
    TileInvalidationBus,
    TileRequest,
    TileResponse,
    TileServer,
    TileServerStats,
    tile_bounds,
    tile_grid,
)
from repro_torch.serve.trace import (
    Spike,
    continental_universes,
    diurnal_spikes,
    flash_crowd_spikes,
    geo_trace,
    rate_at,
    tile_universe,
    zipf_spike_trace,
)

__all__ = [
    "AutoscaleAction", "AutoscalePolicy", "AutoscaleReport", "EdgeCache",
    "EdgeCacheStats", "GeoServingReport", "GeoTileFleet",
    "RegionalAutoscalers", "ServeAutoscaler", "ServingReport", "Spike",
    "TileCache", "TileCacheStats", "TileFleet", "TileInvalidationBus",
    "TileRequest", "TileResponse", "TileServer", "TileServerStats",
    "continental_universes", "diurnal_spikes", "flash_crowd_spikes",
    "geo_trace", "rate_at", "serve_pool", "tile_bounds", "tile_grid",
    "tile_universe", "zipf_spike_trace",
]
