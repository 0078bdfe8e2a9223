"""Core — the paper's contribution: festivus VFS + tiling + task queue.

Layering (bottom-up):

    object_store   RESTful immutable-object storage (GCS stand-in)
    metadata       shared Redis-like KV (stat cache, queue state, manifests)
    festivus       the virtual file system: block engine, cache, readahead
    codec          per-chunk compression registry
    chunkstore     chunked n-d arrays over festivus (JPEG2000/JPX role)
    tiling         UTM / Web-Mercator global domain decomposition
    taskqueue      Celery-like worker-pull queue: leases, retries, speculation
    perfmodel      paper-calibrated performance/cost constants (Tables I,III,IV)
"""

from repro_torch.core.festivus import Festivus, FestivusConfig, GcsFuseLikeFS
from repro_torch.core.metadata import MetadataStore, StatCache
from repro_torch.core.object_store import (
    FlakyObjectStore,
    InMemoryObjectStore,
    LocalDirObjectStore,
    ObjectNotFound,
    TransientStoreError,
    VirtualTimeStore,
)
from repro_torch.core.chunkstore import ArraySpec, ChunkedArray, ChunkStore
from repro_torch.core.taskqueue import Task, TaskQueue, run_workers
from repro_torch.core.tiling import (
    MercatorTile,
    TileAssignment,
    UTMGridSpec,
    UTMTile,
    global_tiles,
    mercator_tile_of,
    mercator_tiles,
    utm_tile_of,
    zone_tiles,
)

__all__ = [
    "ArraySpec", "ChunkStore", "ChunkedArray", "Festivus", "FestivusConfig",
    "FlakyObjectStore", "GcsFuseLikeFS", "InMemoryObjectStore",
    "LocalDirObjectStore", "MercatorTile", "MetadataStore", "ObjectNotFound",
    "StatCache", "Task", "TaskQueue", "TileAssignment", "TransientStoreError",
    "UTMGridSpec", "UTMTile", "VirtualTimeStore", "global_tiles",
    "mercator_tile_of", "mercator_tiles", "run_workers", "utm_tile_of",
    "zone_tiles",
]
