"""Inter-region calibration table: latency / bandwidth / egress per pair.

The paper's 230 GB/s result reads a single USA multi-region bucket from a
single-region fleet (§IV.B); the wide-area regime — Grossman's data clouds,
Sector/Sphere — is governed by three numbers per region *pair*, which this
module pins down in one table so the multi-region benchmarks are
reproducible without magic constants in the writers:

* **round-trip latency** — public inter-continental RTT figures at the
  paper's timeframe (GCP/AWS region-to-region measurements, rounded to the
  5 ms the model cares about).  A geo-routed request pays half of this
  each way between client continent and serving region; a cross-region
  *read* pays the full RTT once as first-byte tail on top of its
  link-contended transfer.
* **link bandwidth** — the provisioned WAN capacity a fleet in one region
  can sustain against another region's storage, shared max-min across all
  concurrently-reading cross-region flows (the same water-filling
  discipline as the intra-zone fabric, with a *fixed* capacity instead of
  the Table III reader-count curve).  Trans-Atlantic fatter than
  trans-Pacific, both far below the intra-zone fabric.
* **egress $/GB** — derived from the paper's own Table I WAN figure
  (``CostModel.wan_gbps_s`` = $1.0e-2 per Gbps-second, i.e. $0.01/Gb =
  $0.08/GB), scaled per pair by the public inter-continental egress
  multipliers (oceania-bound traffic bills ~1.9x the base WAN rate).

Every row is symmetric (the table stores each unordered pair once);
:func:`inter_region_link` resolves either direction.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

#: the region (continent) identifiers the serving traces tag requests with
REGIONS: Tuple[str, ...] = ("usa", "europe", "asia", "oceania")

#: Table I WAN rate, $ per GB transferred between regions (see module
#: docstring for the derivation: $1.0e-2 per Gbps-second = $0.08/GB)
WAN_EGRESS_USD_PER_GB = 1.0e-2 * 8.0

GB = 1.0e9


@dataclasses.dataclass(frozen=True)
class RegionLink:
    """One inter-region link: the three numbers the DES needs.

    ``latency_s`` is the round-trip time; ``bandwidth_bytes_per_s`` the
    provisioned WAN capacity water-filled across concurrent cross-region
    flows; ``egress_usd_per_gb`` the per-GB bill every cross-region read
    (and replication copy) pays.
    """

    a: str
    b: str
    latency_s: float
    bandwidth_bytes_per_s: float
    egress_usd_per_gb: float

    def __post_init__(self):
        if self.a == self.b:
            raise ValueError(f"link from a region to itself: {self}")
        if self.latency_s <= 0 or self.bandwidth_bytes_per_s <= 0:
            raise ValueError(f"non-positive latency/bandwidth: {self}")
        if self.egress_usd_per_gb < 0:
            raise ValueError(f"negative egress price: {self}")

    @property
    def key(self) -> Tuple[str, str]:
        """Canonical (sorted) pair — the fabric link-domain key."""
        return tuple(sorted((self.a, self.b)))  # type: ignore[return-value]

    def one_way_s(self) -> float:
        return self.latency_s / 2.0

    def egress_usd(self, nbytes: int) -> float:
        return (nbytes / GB) * self.egress_usd_per_gb


#: the calibration rows: (pair, RTT seconds, bytes/s, $/GB).  Latencies are
#: rounded public inter-continental RTTs; bandwidths are the provisioned
#: per-fleet WAN capacities the benchmark assumes (trans-Atlantic 12.5 GB/s
#: = 100 Gb/s, trans-Pacific 6.25 GB/s, the long way around less).
_LINK_ROWS = (
    ("usa", "europe", 0.090, 12.5 * GB, WAN_EGRESS_USD_PER_GB),
    ("usa", "asia", 0.150, 6.25 * GB, WAN_EGRESS_USD_PER_GB),
    ("usa", "oceania", 0.160, 5.0 * GB, 1.9 * WAN_EGRESS_USD_PER_GB),
    ("europe", "asia", 0.200, 3.125 * GB, WAN_EGRESS_USD_PER_GB),
    ("europe", "oceania", 0.280, 2.5 * GB, 1.9 * WAN_EGRESS_USD_PER_GB),
    ("asia", "oceania", 0.120, 5.0 * GB, 1.9 * WAN_EGRESS_USD_PER_GB),
)

REGION_LINKS: Dict[Tuple[str, str], RegionLink] = {
    tuple(sorted((a, b))): RegionLink(a, b, lat, bw, usd)
    for a, b, lat, bw, usd in _LINK_ROWS
}


def link_key(a: str, b: str) -> Tuple[str, str]:
    """Canonical unordered-pair key for the (a, b) link."""
    if a == b:
        raise ValueError(f"no link from region {a!r} to itself")
    return tuple(sorted((a, b)))  # type: ignore[return-value]


def inter_region_link(a: str, b: str) -> RegionLink:
    """The calibrated link between regions `a` and `b` (either order)."""
    try:
        return REGION_LINKS[link_key(a, b)]
    except KeyError:
        raise KeyError(f"no calibrated link between {a!r} and {b!r} "
                       f"(regions: {REGIONS})") from None


def client_rtt_s(client_region: str, serving_region: str) -> float:
    """Round-trip a client in `client_region` pays to reach a fleet in
    `serving_region` (0.0 when served in-region — the geo-routing win)."""
    if client_region == serving_region:
        return 0.0
    return inter_region_link(client_region, serving_region).latency_s


def nearest_region(region: str, candidates) -> str:
    """The candidate region with the lowest RTT from `region` (itself if
    present) — how a reader picks which replica to pull from.  Ties break
    by region name, so the choice is deterministic."""
    cands = sorted(set(candidates))
    if not cands:
        raise ValueError("no candidate regions")
    if region in cands:
        return region
    return min(cands, key=lambda c: (client_rtt_s(region, c), c))


def region_table() -> dict:
    """The calibration table as a JSON-ready dict — what the benchmark
    writer embeds in its record so every row is reproducible from the
    record alone."""
    return {
        "regions": list(REGIONS),
        "wan_egress_usd_per_gb": WAN_EGRESS_USD_PER_GB,
        "links": [
            {"a": l.a, "b": l.b, "rtt_s": l.latency_s,
             "bandwidth_bytes_per_s": l.bandwidth_bytes_per_s,
             "egress_usd_per_gb": l.egress_usd_per_gb}
            for _, l in sorted(REGION_LINKS.items())
        ],
    }
