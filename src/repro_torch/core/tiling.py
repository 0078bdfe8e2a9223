"""Global tiling / domain decomposition (paper §III.C).

Two tiling systems, exactly as the paper frames them:

* **Web Mercator** — level-L power-of-two quadtree (4**L tiles); trivial to
  tile, used for serving/display only (pixel areas are not equal; "declared
  unacceptable for official use").
* **UTM** — the analysis projection.  60 zones, each tiled by a
  parameterized grid: ``tile_px`` pixels per side, ``border_px`` overlap,
  ``resolution_m`` meters per pixel, origin at the zone's equator/central
  meridian intersection.  Southern tiles use negative y-indices from the
  equator (the paper's alternative convention).

The same machinery doubles as the framework's *domain decomposition*: tiles
are deterministic, independent work items assigned to workers / data-axis
coordinates by :class:`TileAssignment` (the mapping the paper implements
with Celery task lists).

Geodesy is intentionally spherical (R = 6 371 007 m, the authalic radius):
the framework properties — determinism, disjointness-with-border, coverage —
are what matter here, and tests assert those, not ellipsoidal accuracy.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Iterator, List, Sequence, Tuple

EARTH_RADIUS_M = 6_371_007.0
ZONE_WIDTH_DEG = 6.0
N_ZONES = 60
#: paper: "the distance from the equator to the pole is near 10000 km"
POLE_DISTANCE_M = math.pi * EARTH_RADIUS_M / 2.0
#: paper: "a UTM zone is 6 degrees across, that represents 668 km at the equator"
ZONE_WIDTH_EQUATOR_M = 2 * math.pi * EARTH_RADIUS_M * (ZONE_WIDTH_DEG / 360.0)


# ---------------------------------------------------------------------------
# Web Mercator
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MercatorTile:
    level: int
    x: int
    y: int

    def __post_init__(self):
        n = 1 << self.level
        if not (0 <= self.x < n and 0 <= self.y < n):
            raise ValueError(f"tile ({self.x},{self.y}) outside level {self.level}")

    def children(self) -> List["MercatorTile"]:
        return [MercatorTile(self.level + 1, 2 * self.x + dx, 2 * self.y + dy)
                for dy in (0, 1) for dx in (0, 1)]

    def parent(self) -> "MercatorTile":
        if self.level == 0:
            raise ValueError("root tile has no parent")
        return MercatorTile(self.level - 1, self.x // 2, self.y // 2)

    def bounds_lonlat(self) -> Tuple[float, float, float, float]:
        """(lon_w, lat_s, lon_e, lat_n) in degrees."""
        n = 1 << self.level

        def lon(x):
            return x / n * 360.0 - 180.0

        def lat(y):
            t = math.pi * (1 - 2 * y / n)
            return math.degrees(math.atan(math.sinh(t)))

        return lon(self.x), lat(self.y + 1), lon(self.x + 1), lat(self.y)

    def key(self) -> str:
        return f"wm/{self.level}/{self.x}/{self.y}"


def mercator_tile_of(lon: float, lat: float, level: int) -> MercatorTile:
    n = 1 << level
    x = int((lon + 180.0) / 360.0 * n)
    lat_r = math.radians(max(min(lat, 85.05112878), -85.05112878))
    y = int((1.0 - math.asinh(math.tan(lat_r)) / math.pi) / 2.0 * n)
    return MercatorTile(level, min(x, n - 1), min(y, n - 1))


def mercator_tiles(level: int) -> Iterator[MercatorTile]:
    """All 4**level tiles at a decomposition level (paper's 4^L pieces)."""
    n = 1 << level
    for y in range(n):
        for x in range(n):
            yield MercatorTile(level, x, y)


# ---------------------------------------------------------------------------
# UTM
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class UTMGridSpec:
    """The paper's tiling-system parameters (§III.C, verbatim set)."""

    tile_px: int = 4096
    border_px: int = 0
    resolution_m: float = 10.0

    @property
    def tile_span_m(self) -> float:
        return self.tile_px * self.resolution_m

    def tiles_across_zone(self) -> int:
        """East-west tile count; 17 for 10 m / 4096 px (paper's example)."""
        return max(1, math.ceil(ZONE_WIDTH_EQUATOR_M / self.tile_span_m))

    def tiles_to_pole(self) -> int:
        """North-south count; ~244 for 10 m, ~10 for 250 m (paper's figures)."""
        return max(1, math.ceil(POLE_DISTANCE_M / self.tile_span_m))


@dataclasses.dataclass(frozen=True)
class UTMTile:
    """Tile (zone, tx, ty); ty < 0 indexes south from the equator."""

    zone: int
    tx: int
    ty: int
    spec: UTMGridSpec = UTMGridSpec()

    def __post_init__(self):
        if not (1 <= self.zone <= N_ZONES):
            raise ValueError(f"zone {self.zone} outside 1..{N_ZONES}")
        if not (0 <= self.tx < self.spec.tiles_across_zone()):
            raise ValueError(f"tx {self.tx} outside zone grid")
        if not (-self.spec.tiles_to_pole() <= self.ty < self.spec.tiles_to_pole()):
            raise ValueError(f"ty {self.ty} outside zone grid")

    def bounds_m(self) -> Tuple[float, float, float, float]:
        """(easting_w, northing_s, easting_e, northing_n) in zone meters,
        easting measured from the zone's west edge, northing from equator."""
        s = self.spec.tile_span_m
        return (self.tx * s, self.ty * s, (self.tx + 1) * s, (self.ty + 1) * s)

    def bounds_with_border_m(self) -> Tuple[float, float, float, float]:
        b = self.spec.border_px * self.spec.resolution_m
        w, s, e, n = self.bounds_m()
        return (w - b, s - b, e + b, n + b)

    @property
    def pixels(self) -> Tuple[int, int]:
        p = self.spec.tile_px + 2 * self.spec.border_px
        return (p, p)

    def key(self) -> str:
        hemi = "S" if self.ty < 0 else "N"
        return f"utm/{self.zone}{hemi}/{self.tx}/{abs(self.ty)}/r{int(self.spec.resolution_m)}"


def zone_of_lon(lon: float) -> int:
    lon = ((lon + 180.0) % 360.0) - 180.0
    return min(N_ZONES, int((lon + 180.0) // ZONE_WIDTH_DEG) + 1)


def utm_tile_of(lon: float, lat: float, spec: UTMGridSpec = UTMGridSpec()) -> UTMTile:
    zone = zone_of_lon(lon)
    zone_west = -180.0 + (zone - 1) * ZONE_WIDTH_DEG
    easting = math.radians(lon - zone_west) * EARTH_RADIUS_M * math.cos(math.radians(lat))
    northing = math.radians(lat) * EARTH_RADIUS_M
    s = spec.tile_span_m
    tx = max(0, min(spec.tiles_across_zone() - 1, int(easting // s)))
    ty = int(math.floor(northing / s))
    ty = max(-spec.tiles_to_pole(), min(spec.tiles_to_pole() - 1, ty))
    return UTMTile(zone, tx, ty, spec)


def zone_tiles(zone: int, spec: UTMGridSpec = UTMGridSpec(),
               lat_range: Tuple[float, float] = (-90.0, 90.0)) -> Iterator[UTMTile]:
    """All tiles of a zone whose northing range intersects lat_range."""
    s = spec.tile_span_m
    ty_lo = int(math.floor(math.radians(lat_range[0]) * EARTH_RADIUS_M / s))
    ty_hi = int(math.ceil(math.radians(lat_range[1]) * EARTH_RADIUS_M / s))
    ty_lo = max(ty_lo, -spec.tiles_to_pole())
    ty_hi = min(ty_hi, spec.tiles_to_pole())
    for ty in range(ty_lo, ty_hi):
        for tx in range(spec.tiles_across_zone()):
            yield UTMTile(zone, tx, ty, spec)


def global_tiles(spec: UTMGridSpec = UTMGridSpec(),
                 lat_range: Tuple[float, float] = (-60.0, 75.0)) -> Iterator[UTMTile]:
    """The paper's global decomposition (land-relevant latitudes by default;
    the 250 m composite used ~43k square tiles)."""
    for zone in range(1, N_ZONES + 1):
        yield from zone_tiles(zone, spec, lat_range)


# ---------------------------------------------------------------------------
# Work assignment (tiles -> workers / data-axis coordinates)
# ---------------------------------------------------------------------------
class TileAssignment:
    """Deterministic tile -> shard mapping.

    Two modes:

    * ``contiguous`` — equal contiguous runs in row-major tile order
      (locality: neighbouring tiles share input scenes, so a worker's
      festivus block cache gets reuse);
    * ``hashed`` — uniform pseudo-random (load balance when per-tile cost is
      skewed, e.g. ocean vs land tiles).

    The same mapping assigns training-data shards to `data`-axis mesh
    coordinates, making host input pipelines disjoint by construction.
    """

    def __init__(self, keys: Sequence[str], num_shards: int,
                 mode: str = "contiguous"):
        if num_shards <= 0:
            raise ValueError("num_shards must be positive")
        if mode not in ("contiguous", "hashed"):
            raise ValueError(f"unknown mode {mode}")
        self.keys = list(keys)
        self.num_shards = num_shards
        self.mode = mode

    def shard_of(self, key: str) -> int:
        if self.mode == "hashed":
            h = hashlib.blake2s(key.encode(), digest_size=8).digest()
            return int.from_bytes(h, "little") % self.num_shards
        idx = self.keys.index(key)
        return self._contig_shard(idx)

    def _contig_shard(self, idx: int) -> int:
        n = len(self.keys)
        base, extra = divmod(n, self.num_shards)
        # first `extra` shards get base+1 items
        boundary = extra * (base + 1)
        if idx < boundary:
            return idx // (base + 1)
        return extra + (idx - boundary) // base if base else self.num_shards - 1

    def shard(self, shard_id: int) -> List[str]:
        if not (0 <= shard_id < self.num_shards):
            raise ValueError(f"shard {shard_id} outside 0..{self.num_shards - 1}")
        if self.mode == "hashed":
            return [k for k in self.keys if self.shard_of(k) == shard_id]
        return [k for i, k in enumerate(self.keys)
                if self._contig_shard(i) == shard_id]

    def all_shards(self) -> List[List[str]]:
        return [self.shard(i) for i in range(self.num_shards)]
