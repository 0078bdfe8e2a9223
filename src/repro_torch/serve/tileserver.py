"""Tile server over the chunkstore pyramids (paper §V.D, Mapserver role).

A tile request names a pyramid level and an (x, y) tile index; the server
maps it to a spatial region of the named :class:`ChunkedArray` at that
level and reads exactly the covering chunks through its festivus mount —
the paper's "decode ... at the resolution requested" with the chunk grid
playing the JPX codestream.  Request service is:

    cache hit   -> TileServingModel.cache_hit_s of virtual CPU, no I/O
    cache miss  -> covering-chunk reads (modeled object I/O, water-filled
                   against the shared fabric by the cluster DES) + a
                   decode/assembly CPU bill, then LRU insertion

:class:`TileFleet` runs N servers as cluster-engine workers in their own
worker pool: a request trace (see :mod:`repro_torch.serve.trace`) arrives over
virtual time, each request is a queue task routed to the "serve" pool, and
an optional batch campaign runs simultaneously in a "batch" pool — both
tiers' flows share one :class:`~repro_torch.core.perfmodel.SharedFabric`, which
is what makes a load spike and a composite scan degrade each other
honestly inside one simulation.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import perfmodel
from repro_torch.core.chunkstore import (ChunkedArray, ChunkStore, parse_chunk_key,
                                   spatial_dims)
from repro_torch.core.festivus import Festivus, FestivusConfig, SsdTier
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.object_store import ObjectStore
from repro_torch.launch.chaos import ChaosSchedule
from repro_torch.launch.cluster import ClusterConfig, ClusterEngine, ClusterReport, Worker
from repro_torch.serve.autoscale import AutoscalePolicy, AutoscaleReport, ServeAutoscaler

SERVE_POOL = "serve"
BATCH_POOL = "batch"
#: the continuous-ingest worker pool (scene writes + wheel reanalysis);
#: shares the fabric with serving and batch, like the other two
INGEST_POOL = "ingest"


# ---------------------------------------------------------------------------
# requests and the XYZ -> pyramid-region mapping
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, slots=True)
class TileRequest:
    """One XYZ-style request: array + pyramid level + tile column/row.

    `t` is the virtual arrival instant (seconds into the trace); `level`
    counts like the pyramid (0 = full resolution, higher = coarser), so a
    web map's zoom z maps to ``pyramid_levels - z``.  `fmt` names the
    wire encoding (:data:`repro_torch.core.perfmodel.TILE_FORMATS`): response
    bytes and a per-request encode CPU bill follow the format; the
    default "raw" is the identity (ratio 1.0, zero cost).  `region` tags
    the client's source region/continent (see
    :data:`repro_torch.configs.regions.REGIONS`) — what a geo-aware fleet
    routes on; the default "" is untagged (single-region traffic).
    ``slots`` because a million-request trace holds a million of these.
    """

    t: float
    level: int
    x: int
    y: int
    array: str = "composite"
    fmt: str = "raw"
    region: str = ""


@dataclasses.dataclass(frozen=True)
class TileResponse:
    data: np.ndarray
    nbytes: int
    cache_hit: bool
    level: int
    x: int
    y: int


def tile_grid(level_shape: Sequence[int], tile_px: int) -> Tuple[int, int]:
    """(tiles_down, tiles_across) covering a level's spatial extent."""
    dh, dw = spatial_dims(level_shape)
    return (-(-level_shape[dh] // tile_px), -(-level_shape[dw] // tile_px))


def tile_bounds(level_shape: Sequence[int], tile_px: int, x: int,
                y: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(start, stop) region of tile (x, y); edge tiles are clipped.

    Non-spatial axes (time, channel) span their full extent — a map tile
    serves every band of the composite.
    """
    dh, dw = spatial_dims(level_shape)
    ny, nx = tile_grid(level_shape, tile_px)
    if not (0 <= x < nx and 0 <= y < ny):
        raise KeyError(f"tile ({x},{y}) outside {ny}x{nx} grid "
                       f"of {tuple(level_shape)} at tile_px={tile_px}")
    start = [0] * len(level_shape)
    stop = list(level_shape)
    start[dh] = y * tile_px
    stop[dh] = min((y + 1) * tile_px, level_shape[dh])
    start[dw] = x * tile_px
    stop[dw] = min((x + 1) * tile_px, level_shape[dw])
    return tuple(start), tuple(stop)


# ---------------------------------------------------------------------------
# LRU tile cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TileCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    inserted_bytes: int = 0
    #: entries dropped because their source chunks were rewritten (the
    #: write-invalidation path — distinct from capacity `evictions`)
    invalidations: int = 0

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class _ByteBoundedLRU:
    """Shared LRU core for both cache tiers: byte accounting, replace
    without double-count, evict from the cold end, and the oversize rule
    (an entry larger than the whole capacity is served but never cached —
    it would evict everything for a single-use entry).

    Entries are ``key -> (nbytes, payload)``; subclasses choose the
    payload (decoded pixels for the server tier, the filler's identity
    for the edge tier) and expose their own get/put signatures.  The
    stats object just needs hits/misses/evictions/inserted_bytes fields.
    """

    def __init__(self, capacity_bytes: int, stats):
        self.capacity = capacity_bytes
        self.stats = stats
        self._data: "OrderedDict[Tuple, Tuple[int, Any]]" = OrderedDict()
        self._bytes = 0

    def _lookup(self, key: Tuple) -> Optional[Tuple[int, Any]]:
        entry = self._data.get(key)
        if entry is None:
            self.stats.misses += 1
            return None
        self._data.move_to_end(key)
        self.stats.hits += 1
        return entry

    def _insert(self, key: Tuple, nbytes: int, payload) -> None:
        if nbytes > self.capacity:
            return
        old = self._data.pop(key, None)
        if old is not None:
            self._bytes -= old[0]
        self._data[key] = (nbytes, payload)
        self._bytes += nbytes
        self.stats.inserted_bytes += nbytes
        while self._bytes > self.capacity:
            _, (victim_bytes, _) = self._data.popitem(last=False)
            self._bytes -= victim_bytes
            self.stats.evictions += 1

    def invalidate(self, key: Tuple) -> bool:
        """Drop `key` because its backing data changed (chunk rewrite).

        Returns whether an entry was actually dropped.  Counted separately
        from capacity evictions: an invalidation is correctness work (the
        entry is *wrong* now), an eviction is economics.
        """
        entry = self._data.pop(key, None)
        if entry is None:
            return False
        self._bytes -= entry[0]
        self.stats.invalidations += 1
        return True

    def __len__(self) -> int:
        return len(self._data)

    def contains(self, key: Tuple) -> bool:
        """Membership peek with no stats or recency side effects — for a
        caller that must know *before* serving whether a request will
        reach the backing store (the geo tier's replica routing)."""
        return key in self._data

    @property
    def bytes_used(self) -> int:
        return self._bytes


class TileCache(_ByteBoundedLRU):
    """Byte-bounded LRU of decoded tiles, keyed (array, level, x, y).

    The serving analogue of the page cache: repeated requests for a hot
    tile skip the object store entirely.
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes < 0:
            raise ValueError(f"negative cache capacity {capacity_bytes}")
        super().__init__(capacity_bytes, TileCacheStats())

    def get(self, key: Tuple) -> Optional[np.ndarray]:
        entry = self._lookup(key)
        return entry[1] if entry is not None else None

    def put(self, key: Tuple, tile: np.ndarray) -> None:
        self._insert(key, tile.nbytes, tile)


# ---------------------------------------------------------------------------
# the edge tier: a CDN-role cache in FRONT of the fleet
# ---------------------------------------------------------------------------
#: the edge tier counts exactly what the server tier counts; one class
#: serves both (the name stays exported for call-site clarity)
EdgeCacheStats = TileCacheStats


class EdgeCache(_ByteBoundedLRU):
    """Byte-bounded LRU of *encoded* tiles at the CDN/edge tier.

    Sits in front of the whole fleet (the CDN role in front of the
    paper's Mapserver tier): a hit never reaches a server — no queueing, no
    worker, just :attr:`TileServingModel.edge_hit_s` of response time.
    Unlike :class:`TileCache` it stores no pixels: the simulation needs a
    tile's *size* (byte-bounded eviction) and *identity of the request
    that filled it* (the ``leader`` — so a request arriving while the
    filler is still in flight can be coalesced onto its response, the
    CDN request-collapsing behaviour), not its contents.

    State evolves in request-arrival order, which is what makes the edge
    deterministic independent of fleet timing: whether an entry is
    *filled* by arrival time is resolved later against the leader's
    simulated completion instant.
    """

    def __init__(self, capacity_bytes: int):
        if capacity_bytes <= 0:
            raise ValueError(f"edge cache needs positive capacity, got "
                             f"{capacity_bytes}")
        super().__init__(capacity_bytes, EdgeCacheStats())

    def get(self, key: Tuple) -> Optional[str]:
        """The leader task id whose response fills `key`, or None (miss)."""
        entry = self._lookup(key)
        return entry[1] if entry is not None else None

    def put(self, key: Tuple, nbytes: int, leader: str) -> None:
        self._insert(key, nbytes, leader)


# ---------------------------------------------------------------------------
# write-invalidation: chunk rewrites -> derived-tile eviction
# ---------------------------------------------------------------------------
class TileInvalidationBus:
    """Fan chunk rewrites out to every registered tile cache.

    The stale-tiles-forever bug: ``Festivus.write`` invalidates its own
    *block* cache, but tiles are a derived product — nothing upstream
    knows a :class:`TileCache` exists, so after a chunk rewrite every
    cached tile cut from it kept serving the old pixels indefinitely.
    The bus closes that loop.  Hang :meth:`on_write` on the cluster's
    ``mount_write_hook`` (so every mount, including elastic joiners,
    reports PUTs/DELETEs) and register each serving cache; a written
    chunk key is parsed back to ``(array, level, chunk idx)``, mapped to
    the tile rectangle it intersects at that level, and those keys are
    dropped everywhere.

    Pyramid levels need no special casing: the wheel's incremental
    rebuild writes the dirty ancestors through the same mounts, so their
    tiles invalidate when (and only when) the rebuilt chunk actually
    lands — tiles over a not-yet-rebuilt level keep serving the old
    (consistent) pixels, which is the eventual-consistency contract the
    paper's serving tier offers during re-ingest.

    Array geometry (level shapes, chunk grids) is read once per array
    through a control-plane mount on the *raw* store — coherence traffic,
    deliberately outside the simulation's I/O accounting.  Single-threaded
    by design: the virtual-time DES runs one handler at a time.
    """

    def __init__(self, store: ObjectStore, meta: MetadataStore, root: str,
                 tile_px: int):
        self.root = root
        self.tile_px = tile_px
        self._fs = Festivus(store, meta=meta)
        self._cs = ChunkStore(self._fs, root)
        self._arrays: Dict[str, ChunkedArray] = {}
        #: (cache, fmts): fmts is None for decoded-pixel tiers keyed
        #: (array, level, x, y), or the format tuple for encoded tiers
        #: keyed (array, level, x, y, fmt)
        self._caches: List[Tuple[_ByteBoundedLRU, Optional[Tuple[str, ...]]]] = []
        #: every (array, level, x, y) ever invalidated — the freshness
        #: probe's worklist
        self.invalidated: set = set()
        self.chunk_writes = 0
        self.invalidations = 0

    def register_cache(self, cache: _ByteBoundedLRU,
                       fmts: Optional[Tuple[str, ...]] = None) -> None:
        self._caches.append((cache, fmts))

    def tile_span(self, name: str, level: int,
                  idx: Tuple[int, ...]) -> Tuple[int, int, int, int]:
        """Tile rectangle (x0, x1, y0, y1), half-open, covering chunk
        `idx` of `name` at `level`."""
        arr = self._arrays.get(name)
        if arr is None:
            arr = self._arrays[name] = self._cs.open(name)
        shape = arr.level_shape(level)
        dh, dw = spatial_dims(shape)
        ch, cw = arr.spec.chunks[dh], arr.spec.chunks[dw]
        r0, r1 = idx[dh] * ch, min((idx[dh] + 1) * ch, shape[dh])
        c0, c1 = idx[dw] * cw, min((idx[dw] + 1) * cw, shape[dw])
        return (c0 // self.tile_px, -(-c1 // self.tile_px),
                r0 // self.tile_px, -(-r1 // self.tile_px))

    def on_write(self, path: str) -> None:
        parsed = parse_chunk_key(self.root, path)
        if parsed is None:
            return  # manifest or foreign object, no derived tiles
        name, level, idx = parsed
        try:
            x0, x1, y0, y1 = self.tile_span(name, level, idx)
        except (KeyError, FileNotFoundError):
            return  # array being created; nothing cached yet
        self.chunk_writes += 1
        for y in range(y0, y1):
            for x in range(x0, x1):
                key = (name, level, x, y)
                self.invalidated.add(key)
                for cache, fmts in self._caches:
                    if fmts is None:
                        self.invalidations += cache.invalidate(key)
                    else:
                        for fmt in fmts:
                            self.invalidations += cache.invalidate(key + (fmt,))

    def close(self) -> None:
        self._fs.close()


# ---------------------------------------------------------------------------
# one server
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TileServerStats:
    requests: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    bytes_served: int = 0

    def hit_rate(self) -> float:
        return self.cache_hits / self.requests if self.requests else 0.0


class TileServer:
    """One serving node: festivus-mounted chunkstore + LRU tile cache.

    `charge` receives virtual CPU seconds per request (wire it to
    ``worker.charge_compute`` under the cluster DES; standalone use leaves
    it None and only the stats/caching behaviour applies).
    """

    def __init__(self, cs: ChunkStore, tile_px: int = 256,
                 cache_bytes: int = 64 * perfmodel.MiB,
                 model: Optional[perfmodel.TileServingModel] = None,
                 charge: Optional[Callable[[float], None]] = None):
        if tile_px <= 0:
            raise ValueError(f"tile_px must be positive, got {tile_px}")
        self.cs = cs
        self.tile_px = tile_px
        self.model = model if model is not None else perfmodel.TILE_SERVING_MODEL
        self.cache = TileCache(cache_bytes)
        self.stats = TileServerStats()
        self._charge = charge
        self._arrays: Dict[str, ChunkedArray] = {}

    def _array(self, name: str) -> ChunkedArray:
        arr = self._arrays.get(name)
        if arr is None:
            arr = self._arrays[name] = self.cs.open(name)
        return arr

    def serve(self, req: TileRequest) -> TileResponse:
        """Serve one tile: cache, else pyramid region read + decode bill.

        The response carries *wire* bytes — raw tile bytes through the
        request's encode format — and every non-raw response bills the
        encoder on top of the hit/miss cost (the tile cache stores
        decoded pixels, so a hit still encodes).
        """
        self.stats.requests += 1
        key = (req.array, req.level, req.x, req.y)
        fmt = req.fmt
        tile = self.cache.get(key)
        if tile is not None:
            wire = self.model.wire_bytes(tile.nbytes, fmt)
            self.stats.cache_hits += 1
            self.stats.bytes_served += wire
            if self._charge is not None:
                self._charge(self.model.hit_cost_s()
                             + self.model.encode_cost_s(tile.nbytes, fmt))
            return TileResponse(tile, wire, True, req.level, req.x, req.y)
        self.stats.cache_misses += 1
        arr = self._array(req.array)
        start, stop = tile_bounds(arr.level_shape(req.level), self.tile_px,
                                  req.x, req.y)
        tile = arr.read(start, stop, level=req.level)
        self.cache.put(key, tile)
        wire = self.model.wire_bytes(tile.nbytes, fmt)
        self.stats.bytes_served += wire
        if self._charge is not None:
            self._charge(self.model.miss_cost_s(tile.nbytes)
                         + self.model.encode_cost_s(tile.nbytes, fmt))
        return TileResponse(tile, wire, False, req.level, req.x, req.y)


# ---------------------------------------------------------------------------
# graceful degradation: the ladder a brownout walks down
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DegradePolicy:
    """What a server gives up, and in what order, when the fleet browns out.

    The ladder (cheapest concession first):

    1. **stale-while-revalidate** (``swr_s > 0``, edge tier only): a
       purged edge entry keeps serving its old bytes for up to ``swr_s``
       after the purge while a background revalidation request refills
       it — clients see edge-hit latency instead of a miss storm right
       after every ingest wave.
    2. **coarser-pyramid fallback** (``coarse_fallback``): a request
       claimed more than ``deadline_s`` after it arrived (the deadline is
       already blown — queueing ate it) is answered with the parent tile
       one pyramid level up: 4x fewer pixels to read and decode, a
       response the client can still render.
    3. **load shedding**: when the serve pool's backlog exceeds the
       brownout line — ``AutoscalePolicy.brownout_queue_per_server *
       current servers`` under an autoscaler, else the static
       ``brownout_depth`` — the request is answered with a cheap refusal
       (``shed_cost_s`` of CPU, no I/O) instead of queueing deeper.
       Shed responses count against availability, never into latency.
    """

    #: claim-time delay beyond which the response degrades to the parent
    #: pyramid level (queueing already ate the latency budget)
    deadline_s: float = 0.05
    coarse_fallback: bool = True
    #: static shed line: shed when pool backlog exceeds this (0 = only
    #: the autoscaler's brownout_queue_per_server line, if any, sheds)
    brownout_depth: int = 0
    #: stale-while-revalidate window for purged edge entries (0 = off)
    swr_s: float = 0.0
    #: CPU billed for emitting a shed response (a 503 is not free)
    shed_cost_s: float = 20e-6

    def __post_init__(self):
        if self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0, got {self.deadline_s}")
        if self.brownout_depth < 0:
            raise ValueError(f"brownout_depth must be >= 0, got "
                             f"{self.brownout_depth}")
        if self.swr_s < 0:
            raise ValueError(f"swr_s must be >= 0, got {self.swr_s}")
        if self.shed_cost_s < 0:
            raise ValueError(f"shed_cost_s must be >= 0, got "
                             f"{self.shed_cost_s}")


# ---------------------------------------------------------------------------
# the fleet: N servers as cluster-engine workers
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ServingReport:
    """Gathered serving-tier metrics (virtual time throughout)."""

    servers: int
    requests: int
    completed: int
    hit_rate: float
    cache_hits: int
    cache_misses: int
    cache_evictions: int
    bytes_served: int
    #: request latency = completion - arrival, queueing included
    p50_s: float
    p90_s: float
    p99_s: float
    mean_s: float
    max_s: float
    #: trace span (last arrival) and offered request rate over it
    trace_duration_s: float
    offered_rps: float
    #: object-store bytes the serve pool actually read (cache misses)
    serve_bytes_read: int
    #: the concurrent batch campaign, if any — same simulation, same fabric
    batch_tasks: int
    batch_bytes_read: int
    #: the underlying cluster gather (makespan, per-worker stats, fabric)
    cluster: ClusterReport
    #: per-request (arrival_t, latency_s) samples, arrival order — lets a
    #: benchmark slice percentiles by window (e.g. inside a load spike)
    samples: List[Tuple[float, float]] = dataclasses.field(default_factory=list)
    #: requests that reached the fleet (== `requests` with the edge off)
    forwarded: int = 0
    #: edge tier (requests resolve edge-hit -> server-cache-hit -> pyramid):
    #: `edge_hits` were answered from a filled edge entry, `edge_coalesced`
    #: arrived while the filling request was still in flight and rode its
    #: response (CDN request collapsing); `edge_hit_rate` counts both over
    #: all requests.  All zero when no edge cache is configured.
    edge_hits: int = 0
    edge_coalesced: int = 0
    edge_evictions: int = 0
    edge_hit_rate: float = 0.0
    #: fraction of requests served without a pyramid read (edge hit, edge
    #: coalesce, or server tile-cache hit) — the two-level hit rate
    combined_hit_rate: float = 0.0
    #: serve-pool node uptime, virtual seconds summed over servers (joined
    #: -> drained/campaign-end): the $-proxy an autoscaler economises
    serve_worker_seconds: float = 0.0
    #: autoscaler outcome (None when the fleet ran at fixed size)
    autoscale: Optional[AutoscaleReport] = None
    #: continuous-ingest outcome (None when no ingest pool ran): task and
    #: byte counts for the ingest/wheel pool, invalidation-bus counters,
    #: and the post-run freshness probe (cached tiles over rewritten
    #: chunks re-read from scratch and compared byte-for-byte)
    ingest: Optional[Dict[str, Any]] = None
    #: graceful-degradation outcomes (all zero without a DegradePolicy):
    #: `shed` requests were refused at the brownout line (no latency
    #: sample — a refusal is not a serve), `degraded` were answered with
    #: the parent pyramid level after blowing their deadline, and
    #: `stale_served` rode a purged edge entry inside its
    #: stale-while-revalidate window
    shed: int = 0
    degraded: int = 0
    stale_served: int = 0
    #: requests that dead-lettered under fault injection (every queue
    #: retry burned; only possible with a ChaosSchedule); 0 otherwise
    dead: int = 0
    #: non-shed, non-dead fraction of the trace — the availability figure
    #: the fault-matrix BENCH section reports (degraded and stale count
    #: as available: the client got renderable bytes)
    availability: float = 1.0

    def window_percentile(self, q: float, t0: float = 0.0,
                          t1: float = float("inf")) -> float:
        """Latency percentile over requests arriving in [t0, t1).

        An empty window (no arrivals in [t0, t1)) has no defined
        percentile — returns NaN rather than raising, so benchmark row
        writers can record "no traffic" honestly.
        """
        lats = [lat for t, lat in self.samples if t0 <= t < t1]
        if not lats:
            return float("nan")
        return perfmodel.percentile(lats, q)

    @property
    def all_served(self) -> bool:
        return self.completed == self.requests


class TileFleet:
    """Run N tile servers (and optionally a batch pool) on the cluster DES.

    Each server is a cluster worker with its own festivus mount and its own
    :class:`TileServer` (private LRU cache — the paper's per-Mapserver
    memcached analogue).  Requests become queue tasks routed to the
    ``serve`` pool, arriving at their trace timestamps; batch tasks run in
    a ``batch`` pool at t=0.  Both pools' I/O flows share the configured
    fabric zone(s), so serving latency degrades under a concurrent scan
    campaign *inside* the simulation.

    Two optional tiers complete the §V.D deployment shape:

    * ``edge_cache_bytes > 0`` puts an :class:`EdgeCache` in *front* of
      the fleet — requests resolve edge-hit -> server-cache-hit ->
      pyramid read (the two-level hit rate), and an edge hit never
      occupies a server.
    * ``autoscale=AutoscalePolicy(...)`` hands the serve pool to a
      :class:`~repro_torch.serve.autoscale.ServeAutoscaler` living inside the
      DES: SLO-breach joins (with warm-up) during spikes, idle-preferring
      drains when load subsides, `servers` being the starting size.
    """

    def __init__(self, store: ObjectStore, meta: MetadataStore,
                 root: str = "bucket", servers: int = 4,
                 tile_px: int = 256, cache_bytes: int = 64 * perfmodel.MiB,
                 serving_model: Optional[perfmodel.TileServingModel] = None,
                 vcpus: int = 16, zones: int = 1,
                 fabric: Optional[perfmodel.FabricModel] = perfmodel.FABRIC_MODEL,
                 block_bytes: int = 4 * perfmodel.MiB,
                 max_inflight: int = 16,
                 edge_cache_bytes: int = 0,
                 autoscale: Optional[AutoscalePolicy] = None,
                 ssd_bytes: int = 0,
                 placement=None,
                 fest_overrides: Optional[Dict[str, Any]] = None):
        if servers < 1:
            raise ValueError(f"need at least one server, got {servers}")
        if edge_cache_bytes < 0:
            raise ValueError(f"negative edge cache {edge_cache_bytes}")
        if ssd_bytes < 0:
            raise ValueError(f"negative ssd tier {ssd_bytes}")
        self.store = store
        self.meta = meta
        self.root = root
        self.servers = servers
        self.tile_px = tile_px
        self.cache_bytes = cache_bytes
        self.serving_model = (serving_model if serving_model is not None
                              else perfmodel.TILE_SERVING_MODEL)
        self.vcpus = vcpus
        self.zones = zones
        self.fabric = fabric
        self.block_bytes = block_bytes
        self.max_inflight = max_inflight
        #: > 0 puts an EdgeCache tier in front of the fleet
        self.edge_cache_bytes = edge_cache_bytes
        #: an AutoscalePolicy lets a ServeAutoscaler grow/drain the serve
        #: pool mid-run; `servers` is then the starting size
        self.autoscale = autoscale
        #: > 0 mounts a persistent local-SSD tier under every *serve*-pool
        #: festivus mount (two-level storage).  Pool-scoped by design:
        #: batch and ingest mounts stay single-level, so a scan or ingest
        #: wave can neither fill nor churn the serve tier.  The RAM block
        #: cache stays off (the tile cache remains the cache under test);
        #: the SSD level sits directly under it.
        self.ssd_bytes = ssd_bytes
        #: the persistent devices: (pool, worker index) -> SsdTier,
        #: carried across run() calls on this fleet — a re-run serve pool
        #: starts RAM-cold but device-warm, exactly the property a local
        #: SSD that outlives worker leases has
        self.ssd_tiers: Dict[Tuple[Optional[str], int], SsdTier] = {}
        #: fabric-aware placement handle (e.g. object_store.ZoneSpread)
        #: exposed to handlers as ``worker.placement``: the ingest wheel
        #: spreads freshly-written scene batches across fabric zones
        self.placement = placement
        #: FestivusConfig field overrides applied to every mount — the
        #: recovery knobs a chaos campaign arms (``retry_budget_s``,
        #: ``hedged_reads``, ``hedge_delay_floor_s``).  None = legacy
        #: config, bit-identical
        self.fest_overrides = fest_overrides

    def _config(self, batch_nodes: int,
                controller: Optional[ServeAutoscaler] = None,
                ingest_nodes: int = 0,
                mount_write_hook: Optional[Callable[[str], None]] = None,
                chaos: Optional[ChaosSchedule] = None,
                ) -> ClusterConfig:
        pools: Tuple[Tuple[str, int], ...] = ((SERVE_POOL, self.servers),)
        if batch_nodes:
            pools += ((BATCH_POOL, batch_nodes),)
        if ingest_nodes:
            pools += ((INGEST_POOL, ingest_nodes),)
        # speculation stays off in both shapes (duplicate tile serves would
        # skew cache stats); under autoscaling the lease is the recovery
        # path instead: a request orphaned by a drained server re-delivers
        # after policy.lease_s of virtual time.  That short lease applies
        # queue-wide, so a concurrent batch pool (whose scans can outlive
        # it many times over) gets heartbeat renewal — only genuinely
        # orphaned work is ever re-delivered, in either pool
        lease_s = controller.policy.lease_s if controller is not None else 3600.0
        heartbeat_s = (lease_s / 2.0
                       if controller is not None
                       and (batch_nodes or ingest_nodes) else None)
        fest = FestivusConfig(block_bytes=self.block_bytes,
                              readahead_blocks=0, cache_bytes=0,
                              max_inflight=self.max_inflight)
        if self.fest_overrides:
            fest = dataclasses.replace(fest, **self.fest_overrides)
        # pool-scoped two-level storage: only serve mounts get the SSD
        # tier (ingest/batch traffic write-arounds it by construction),
        # and the tiers themselves persist on the fleet across runs.
        # With ssd_bytes=0 nothing is passed at all — ClusterConfig
        # defaults — keeping the single-level path bit-identical.
        pool_fest = ssd_registry = None
        if self.ssd_bytes > 0:
            pool_fest = {SERVE_POOL: dataclasses.replace(
                fest, ssd_bytes=self.ssd_bytes)}
            ssd_registry = self.ssd_tiers
        return ClusterConfig(
            nodes=self.servers + batch_nodes + ingest_nodes, vcpus=self.vcpus,
            virtual_time=True, lease_s=lease_s, heartbeat_s=heartbeat_s,
            mount_write_hook=mount_write_hook,
            # short idle polls: a serving node parked on an empty queue
            # must not owe a request its own backoff (arrivals also wake)
            idle_poll_s=0.002, max_idle_backoff_s=0.5,
            # speculation off: duplicate tile serves would skew cache stats
            min_completions_for_speculation=10**9,
            fabric=self.fabric, zones=self.zones,
            worker_pools=pools, controller=controller,
            pool_festivus=pool_fest, ssd_tier_registry=ssd_registry,
            placement=self.placement, chaos=chaos,
            # the tile cache is the cache under test; festivus block cache
            # off so hits/misses are attributable to it alone
            festivus=fest)

    def _edge_filter(self, trace: Sequence[TileRequest], edge: EdgeCache,
                     purge_events: Optional[Sequence[Tuple[float, Tuple]]] = None,
                     swr_s: float = 0.0):
        """Pass the trace through the edge tier in arrival order.

        Returns ``(forwarded, followers, stale_served, revalidation_ids)``:
        the requests that missed the edge (they become fleet tasks, ids
        matching their forwarded order), for every edge-absorbed request
        the ``(arrival_t, nbytes, leader_id)`` triple — resolved into a
        latency later, against the leader's simulated completion instant
        — plus the stale-while-revalidate bookkeeping (below).  Tile
        sizes come from the manifests alone (no chunk I/O here: the edge
        caches responses, it never reads the pyramid).

        `purge_events` is the edge's write-invalidation feed: a
        time-sorted list of ``(t, (array, level, x, y))`` purges (every
        format variant of the tile is dropped) applied between requests
        as the arrival-order pass crosses each `t`.  Because the edge
        tier resolves *statically* before the fleet simulation, purges
        key off the known ingest schedule — an eager, TTL-zero purge at
        scene arrival rather than at the simulated write completion; a
        deliberately conservative modeling choice (documented in
        ARCHITECTURE.md §9) that can only under-count edge hits, never
        serve stale bytes.

        ``swr_s`` > 0 turns purges into stale-while-revalidate marks
        (the graceful-degradation rung for read availability during
        ingest churn): a purged-but-present entry answers requests for up
        to ``swr_s`` seconds past the purge — each such answer lands in
        ``stale_served`` as ``(arrival_t, nbytes)`` and the *first* one
        also forwards a background revalidation request (its task id goes
        in ``revalidation_ids``, so the caller can exclude it from
        client-visible latency).  Past the window the entry is dropped
        and the request forwards as a plain miss.  With ``swr_s == 0``
        (the default) the legacy purge path runs unchanged.
        """
        fs = Festivus(self.store, meta=self.meta)
        cs = ChunkStore(fs, self.root)
        arrays: Dict[str, ChunkedArray] = {}
        forwarded: List[TileRequest] = []
        followers: List[Tuple[float, int, str]] = []
        stale_served: List[Tuple[float, int]] = []
        revalidation_ids: set = set()
        stale_at: Dict[Tuple, float] = {}
        purges = sorted(purge_events) if purge_events else []
        fmts = tuple(perfmodel.TILE_FORMATS)
        pi = 0
        try:
            for req in trace:
                while pi < len(purges) and purges[pi][0] <= req.t:
                    for fmt in fmts:
                        k = tuple(purges[pi][1]) + (fmt,)
                        if swr_s > 0.0:
                            # keep the entry; remember the *earliest*
                            # unrevalidated purge instant for the key
                            stale_at.setdefault(k, purges[pi][0])
                        else:
                            edge.invalidate(k)
                    pi += 1
                arr = arrays.get(req.array)
                if arr is None:
                    arr = arrays[req.array] = cs.open(req.array)
                start, stop = tile_bounds(arr.level_shape(req.level),
                                          self.tile_px, req.x, req.y)
                raw = int(np.prod([b - a for a, b in zip(start, stop)])
                          * np.dtype(arr.spec.dtype).itemsize)
                # the edge caches *responses*: entry sizes are wire bytes
                # through the request's encode format, and the format is
                # part of the key (a PNG response cannot answer a JPEG
                # request) — with everything on "raw" this is the legacy
                # keying and sizing, bit-for-bit
                nbytes = self.serving_model.wire_bytes(raw, req.fmt)
                key = (req.array, req.level, req.x, req.y, req.fmt)
                purged_t = stale_at.get(key)
                if purged_t is not None:
                    leader = edge.get(key)
                    del stale_at[key]
                    if leader is not None and req.t <= purged_t + swr_s:
                        # serve the stale entry now, revalidate behind it:
                        # the new leader refills the entry off-path
                        stale_served.append((req.t, nbytes))
                        leader = f"req{len(forwarded):06d}"
                        revalidation_ids.add(leader)
                        edge.put(key, nbytes, leader)
                        forwarded.append(req)
                        continue
                    # window expired (or entry already evicted): hard purge
                    edge.invalidate(key)
                leader = edge.get(key)
                if leader is not None:
                    followers.append((req.t, nbytes, leader))
                else:
                    leader = f"req{len(forwarded):06d}"
                    edge.put(key, nbytes, leader)
                    forwarded.append(req)
        finally:
            fs.close()
        return forwarded, followers, stale_served, revalidation_ids

    def run(self, trace: Sequence[TileRequest],
            batch_tasks: Optional[Dict[str, Any]] = None,
            batch_handler: Optional[Callable[[Worker, Any], Any]] = None,
            batch_nodes: int = 0,
            batch_arrival_t: float = 0.0,
            ingest_tasks: Optional[Dict[str, Any]] = None,
            ingest_handler: Optional[Callable[[Worker, Any], Any]] = None,
            ingest_nodes: int = 0,
            degrade: Optional[DegradePolicy] = None,
            chaos: Optional[ChaosSchedule] = None) -> ServingReport:
        """Serve a request trace; optionally run a batch campaign alongside.

        `degrade` arms the graceful-degradation ladder (shed / coarse
        fallback / stale-while-revalidate — see :class:`DegradePolicy`);
        `chaos` injects a deterministic fault schedule into the fleet
        (see :mod:`repro_torch.launch.chaos`).  Under chaos, requests that
        exhaust their retries dead-letter instead of aborting the run —
        they are counted into ``ServingReport.dead`` and subtracted from
        ``availability``; the exactly-once audit (every request
        completed, shed, or dead — none lost) still holds.  Chaos runs
        that crash serve workers should use an `AutoscalePolicy` (its
        short lease is the re-delivery path; the fixed-fleet lease is
        3600 s of virtual time).

        `batch_arrival_t` delays the whole batch wave to that virtual
        instant (the Matsu-wheel shape: a reanalysis scan kicked off while
        the serving tier is live — align it with a spike window to collide
        the two on the fabric).

        `ingest_tasks` runs a continuous-ingest wheel in its own pool
        (see :mod:`repro_torch.ingest.wheel`): payloads marked with a truthy
        ``wheel_payload`` attribute dispatch to `ingest_handler`, arrive
        at their ``t`` attribute (scene-batch arrivals and wheel ticks
        over virtual time), and their writes contend on the shared fabric
        like any flow.  A :class:`TileInvalidationBus` is installed on
        every mount's write hook so chunk rewrites evict derived tiles
        from every server's cache mid-simulation, and the edge tier (if
        on) is purged eagerly at each payload's arrival instant.
        """
        if not trace:
            raise ValueError("empty request trace")
        if batch_tasks and (batch_handler is None or batch_nodes < 1):
            raise ValueError("batch_tasks needs batch_handler and "
                             "batch_nodes >= 1")
        if ingest_tasks and (ingest_handler is None or ingest_nodes < 1):
            raise ValueError("ingest_tasks needs ingest_handler and "
                             "ingest_nodes >= 1")
        bus = None
        if ingest_tasks:
            bus = TileInvalidationBus(self.store, self.meta, self.root,
                                      self.tile_px)
        edge = followers = None
        stale_list: List[Tuple[float, int]] = []
        reval_ids: set = set()
        serve_trace: Sequence[TileRequest] = trace
        if self.edge_cache_bytes:
            edge = EdgeCache(self.edge_cache_bytes)
            purges = (self._ingest_purge_events(bus, ingest_tasks)
                      if bus is not None else None)
            serve_trace, followers, stale_list, reval_ids = self._edge_filter(
                trace, edge, purge_events=purges,
                swr_s=(degrade.swr_s if degrade is not None else 0.0))
        reqs = {f"req{i:06d}": r for i, r in enumerate(serve_trace)}
        tasks: Dict[str, Any] = dict(reqs)
        arrivals = {tid: r.t for tid, r in reqs.items()}
        pools = {tid: SERVE_POOL for tid in reqs}
        if batch_tasks:
            for tid, payload in batch_tasks.items():
                btid = f"batch/{tid}"
                tasks[btid] = payload
                pools[btid] = BATCH_POOL
                if batch_arrival_t > 0.0:
                    arrivals[btid] = batch_arrival_t
        if ingest_tasks:
            for tid, payload in ingest_tasks.items():
                itid = f"ingest/{tid}"
                tasks[itid] = payload
                pools[itid] = INGEST_POOL
                t = float(getattr(payload, "t", 0.0))
                if t > 0.0:
                    arrivals[itid] = t

        tile_servers: Dict[int, TileServer] = {}

        def _shed_threshold() -> float:
            # autoscaled fleets express the brownout point per server so
            # it tracks the current fleet size; fixed fleets use the
            # policy's absolute depth.  0 disables shedding entirely.
            if (scaler is not None
                    and self.autoscale.brownout_queue_per_server > 0):
                return (self.autoscale.brownout_queue_per_server
                        * (scaler.last_servers or self.servers))
            return float(degrade.brownout_depth)

        def handler(worker: Worker, payload):
            if isinstance(payload, TileRequest):
                if degrade is not None:
                    threshold = _shed_threshold()
                    if threshold > 0 and worker.pending_depth() > threshold:
                        # brownout: answer HTTP-503-cheap and move on —
                        # the whole point is to keep the queue bounded
                        worker.charge_compute(degrade.shed_cost_s)
                        return {"hit": False, "nbytes": 0,
                                "worker": worker.name, "shed": True}
                srv = tile_servers.get(worker.index)
                if srv is None:
                    srv = tile_servers[worker.index] = TileServer(
                        worker.chunkstore(self.root), tile_px=self.tile_px,
                        cache_bytes=self.cache_bytes,
                        model=self.serving_model,
                        charge=worker.charge_compute)
                    if bus is not None:
                        bus.register_cache(srv.cache)
                if degrade is not None and degrade.coarse_fallback:
                    delay = worker.virtual_now() - payload.t
                    if delay > degrade.deadline_s:
                        arr = srv._array(payload.array)
                        if payload.level < arr.spec.pyramid_levels:
                            # deadline already blown in queue: serve the
                            # parent pyramid tile (quarter the pixels)
                            coarse = TileRequest(
                                t=payload.t, level=payload.level + 1,
                                x=payload.x // 2, y=payload.y // 2,
                                array=payload.array, fmt=payload.fmt,
                                region=payload.region)
                            resp = srv.serve(coarse)
                            return {"hit": resp.cache_hit,
                                    "nbytes": resp.nbytes,
                                    "worker": worker.name, "degraded": True}
                resp = srv.serve(payload)
                return {"hit": resp.cache_hit, "nbytes": resp.nbytes,
                        "worker": worker.name}
            if getattr(payload, "wheel_payload", False):
                return ingest_handler(worker, payload)
            return batch_handler(worker, payload)

        scaler = (ServeAutoscaler(self.autoscale,
                                  arrivals={tid: r.t
                                            for tid, r in reqs.items()})
                  if self.autoscale is not None else None)
        engine = ClusterEngine(
            self.store, meta=self.meta,
            config=self._config(batch_nodes, controller=scaler,
                                ingest_nodes=ingest_nodes,
                                mount_write_hook=(bus.on_write
                                                  if bus is not None
                                                  else None),
                                chaos=chaos))
        report = engine.run(tasks, handler, arrivals=arrivals, pools=pools)
        dead = set(report.dead_tasks)
        if not report.all_done:
            # under chaos, dead-lettered requests (retry budget spent, all
            # lease redeliveries burned) are an accounted outcome — but the
            # exactly-once audit still holds: completed + dead must cover
            # every task, none lost, none duplicated
            if chaos is None or (report.queue_stats["completed"] + len(dead)
                                 != len(tasks)):
                raise RuntimeError(
                    f"serving campaign incomplete: "
                    f"{report.queue_stats} dead={report.dead_tasks}")

        latencies: List[float] = []
        samples: List[Tuple[float, float]] = []
        hits = misses = bytes_served = 0
        shed_n = degraded_n = dead_requests = 0
        first_done: Dict[str, float] = {}  # serving node -> first completion
        for tid, req in reqs.items():
            if tid in reval_ids:
                continue  # background revalidation, not client-visible
            if tid in dead:
                dead_requests += 1
                continue
            done_t = report.completion_times[tid]
            res = report.results[tid]
            if res.get("shed"):
                shed_n += 1
                continue  # no latency sample: the client got a 503
            if res.get("degraded"):
                degraded_n += 1
            latencies.append(done_t - req.t)
            samples.append((req.t, done_t - req.t))
            hits += bool(res["hit"])
            misses += not res["hit"]
            bytes_served += res["nbytes"]
            first_done[res["worker"]] = min(
                done_t, first_done.get(res["worker"], float("inf")))
        # edge-absorbed requests: a follower of an in-flight leader rides
        # its response (coalesced wait), a follower of a filled entry pays
        # only the edge hit cost
        edge_pure = edge_coal = 0
        edge_hit_cost = self.serving_model.edge_hit_cost_s()
        for (t, nbytes, leader) in (followers or ()):
            resp_t = report.completion_times.get(leader)
            if resp_t is None:
                dead_requests += 1  # coalesced onto a dead leader
                continue
            if report.results[leader].get("shed"):
                shed_n += 1  # coalesced onto a shed response
                continue
            if t < resp_t:
                lat = (resp_t - t) + edge_hit_cost
                edge_coal += 1
            else:
                lat = edge_hit_cost
                edge_pure += 1
            latencies.append(lat)
            samples.append((t, lat))
            bytes_served += nbytes
        # stale-while-revalidate answers: served from the edge at arrival
        for (t, nbytes) in stale_list:
            latencies.append(edge_hit_cost)
            samples.append((t, edge_hit_cost))
            bytes_served += nbytes
        samples.sort(key=lambda s: s[0])
        evictions = sum(s.cache.stats.evictions for s in tile_servers.values())
        duration = max(r.t for r in trace)
        serve_workers = [w for w in report.per_worker if w.pool == SERVE_POOL]
        batch_workers = [w for w in report.per_worker if w.pool == BATCH_POOL]
        serve_worker_seconds = sum(
            (w.left_t if w.left_t is not None
             else max(report.makespan_s, w.joined_t)) - w.joined_t
            for w in serve_workers)
        ingest_stats = None
        if bus is not None:
            ingest_workers = [w for w in report.per_worker
                              if w.pool == INGEST_POOL]
            ingest_stats = {
                "tasks": sum(w.tasks_completed for w in ingest_workers),
                "bytes_written": sum(w.store_stats.bytes_written
                                     for w in ingest_workers),
                "bytes_read": sum(w.store_stats.bytes_read
                                  for w in ingest_workers),
                "chunk_writes": bus.chunk_writes,
                "tile_invalidations": bus.invalidations,
                "tiles_touched": len(bus.invalidated),
            }
            ingest_stats.update(self._freshness_probe(tile_servers, bus))
            bus.close()
        autoscale_report = None
        if scaler is not None:
            autoscale_report = scaler.report(self.servers)
            autoscale_report.warmup_ok = all(
                first_done.get(w.worker, float("inf"))
                >= w.joined_t + self.autoscale.warmup_s
                for w in serve_workers if w.joined_t > 0.0)
        return ServingReport(
            servers=self.servers, requests=len(trace),
            completed=len(latencies),
            hit_rate=hits / len(reqs), cache_hits=hits, cache_misses=misses,
            cache_evictions=evictions, bytes_served=bytes_served,
            p50_s=perfmodel.percentile(latencies, 50),
            p90_s=perfmodel.percentile(latencies, 90),
            p99_s=perfmodel.percentile(latencies, 99),
            mean_s=sum(latencies) / len(latencies), max_s=max(latencies),
            trace_duration_s=duration,
            offered_rps=len(trace) / duration if duration > 0 else 0.0,
            serve_bytes_read=sum(w.store_stats.bytes_read
                                 for w in serve_workers),
            batch_tasks=sum(w.tasks_completed for w in batch_workers),
            batch_bytes_read=sum(w.store_stats.bytes_read
                                 for w in batch_workers),
            cluster=report, samples=samples,
            forwarded=len(reqs),
            edge_hits=edge_pure, edge_coalesced=edge_coal,
            edge_evictions=edge.stats.evictions if edge is not None else 0,
            edge_hit_rate=(edge_pure + edge_coal) / len(trace),
            combined_hit_rate=1.0 - misses / len(trace),
            serve_worker_seconds=serve_worker_seconds,
            autoscale=autoscale_report, ingest=ingest_stats,
            shed=shed_n, degraded=degraded_n, stale_served=len(stale_list),
            dead=dead_requests,
            availability=(len(trace) - shed_n - dead_requests) / len(trace))

    def _ingest_purge_events(self, bus: TileInvalidationBus,
                             ingest_tasks: Dict[str, Any],
                             ) -> List[Tuple[float, Tuple]]:
        """Edge-tier purge schedule from the known ingest plan.

        For every scene-batch payload (anything exposing a spatial
        footprint: ``y0/x0/height/width/array/t``), emit a purge of the
        tiles its level-0 footprint maps to at *every* pyramid level at
        the batch's arrival instant — conservative on two axes (the wheel
        rebuilds ancestors a little later, and the footprint is rounded
        out to whole tiles), which can only forgo edge hits, never serve
        stale bytes.
        """
        events: List[Tuple[float, Tuple]] = []
        for payload in ingest_tasks.values():
            if not hasattr(payload, "height"):
                continue  # wheel ticks and other non-write payloads
            name = payload.array
            arr = bus._arrays.get(name)
            if arr is None:
                arr = bus._arrays[name] = bus._cs.open(name)
            shape0 = arr.spec.shape
            dh, dw = spatial_dims(shape0)
            h, w = shape0[dh], shape0[dw]
            sh = sw = 1
            for level in range(arr.spec.pyramid_levels + 1):
                r0, r1 = payload.y0 // sh, min(-(-(payload.y0 + payload.height) // sh), h)
                c0, c1 = payload.x0 // sw, min(-(-(payload.x0 + payload.width) // sw), w)
                for y in range(r0 // self.tile_px, -(-r1 // self.tile_px)):
                    for x in range(c0 // self.tile_px, -(-c1 // self.tile_px)):
                        events.append((payload.t, (name, level, x, y)))
                ph = 2 if h >= 2 else 1
                pw = 2 if w >= 2 else 1
                h, w = -(-h // ph), -(-w // pw)
                sh, sw = sh * ph, sw * pw
        return events

    def _freshness_probe(self, tile_servers: Dict[int, TileServer],
                         bus: TileInvalidationBus,
                         sample_limit: int = 256) -> Dict[str, int]:
        """Prove post-ingest cached tiles are fresh, byte-for-byte.

        Every tile key the bus ever invalidated that is (re-)cached on
        some server after the run must equal a from-scratch read of the
        final array state — if the invalidation path ever missed a
        rewrite, the stale pixels sit right here.  Capped at
        `sample_limit` re-reads; `tiles_checked` records actual coverage.
        """
        fs = Festivus(self.store, meta=self.meta)
        cs = ChunkStore(fs, self.root)
        arrays: Dict[str, ChunkedArray] = {}
        checked = fresh = stale = 0
        try:
            for key in sorted(bus.invalidated):
                if checked >= sample_limit:
                    break
                name, level, x, y = key
                cached = [srv.cache._data[key][1]
                          for srv in tile_servers.values()
                          if srv.cache.contains(key)]
                if not cached:
                    continue
                arr = arrays.get(name)
                if arr is None:
                    arr = arrays[name] = cs.open(name)
                start, stop = tile_bounds(arr.level_shape(level),
                                          self.tile_px, x, y)
                truth = arr.read(start, stop, level=level)
                checked += 1
                if all(np.array_equal(t, truth) for t in cached):
                    fresh += 1
                else:
                    stale += 1
        finally:
            fs.close()
        return {"tiles_checked": checked, "tiles_fresh": fresh,
                "tiles_stale": stale}
