"""Paper-calibrated performance model for cloud object storage.

Every constant here is traceable to a measurement in Warren et al.,
"Data-Intensive Supercomputing in the Cloud" (cs.DC 2017):

* Fig. 3  — single-stream TCP: ~40 us small-message latency, 8.6 Gb/s peak
            single thread, 16 Gb/s aggregate on a 16-vCPU node.
* Table I — fundamental $/s costs (storage, flops, network, labor).
* Table III — aggregate festivus bandwidth vs node count (1 -> 512 nodes);
            per-node ~1 GB/s up to 16 nodes, fabric contention beyond.
* Table IV — single-node random-read bandwidth vs block size, festivus vs
            gcsfuse.  Fitting t(B) = t0 + B/peak to the festivus rows gives
            t0 ~ 2.7 ms per request (object-store GET first-byte latency with
            cached metadata + persistent connections) and peak ~ 1.8 GB/s.
            The gcsfuse rows fit t0 ~ 80 ms: every random read pays a
            metadata HEAD + connection churn + readahead thrash — this is
            precisely the overhead festivus's shared metadata KV store and
            async block engine remove.
* §IV.A  — LINPACK: 1.21 TF on 2x n1-highcpu-64 at $0.51/node/hr.

The model is used ONLY by the benchmark/virtual-time paths; functional code
(data pipeline, checkpointing) runs the same festivus implementation at
native speed against real in-memory / on-disk backends.

Unlike the JAX package's module, this copy carries no TPU constants and
no ``mfu``.  Its accelerator roofline (:func:`roofline_terms`, used by
``launch/dryrun.py``) is the H100's, from the ``H100_*`` figures below:
NVIDIA's data sheet for the H100 SXM5 80 GB (HBM3, 700 W) and its node
(8 GPUs on NVLink 4, one 400 Gb/s NIC a GPU between nodes).  They are
specifications, not measurements.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, Dict, List, Optional, Tuple

KiB = 1024
MiB = 1024 * 1024
GiB = 1024 * 1024 * 1024
GB = 1.0e9  # decimal GB, as used in the paper's tables


@dataclasses.dataclass(frozen=True)
class NetworkModel:
    """Single-node network path model (paper Fig. 3 + Table IV fits)."""

    #: small-message wire latency, seconds (Fig. 3 dashed curve, ~40 us)
    wire_latency_s: float = 40e-6
    #: peak single-stream bandwidth, bytes/s (Fig. 3: 8.6 Gb/s)
    single_stream_bps: float = 8.6e9 / 8
    #: per-vCPU NIC allocation, bits/s (GCE egress model: 2 Gb/s per vCPU)
    nic_bps_per_vcpu: float = 2e9
    #: NIC cap, bits/s (paper: "total bandwidth reaches 16 Gigabits/second")
    nic_bps_cap: float = 16e9

    def node_nic_bytes_per_s(self, vcpus: int) -> float:
        return min(self.nic_bps_per_vcpu * vcpus, self.nic_bps_cap) / 8.0


#: one metadata-KV round-trip (stat / dirent / manifest op against the shared
#: Redis-role store): the Fig. 3 small-message wire latency.  The cluster DES
#: charges this per KV op to the worker clock that issued it — the paper's
#: "metadata server is shared by all instances" cost, which festivus pays in
#: microseconds where gcsfuse pays an object-store HEAD (~80 ms, Table IV).
METADATA_OP_LATENCY_S = 40e-6


@dataclasses.dataclass(frozen=True)
class ObjectStoreModel:
    """Random-range-GET service-time model, t(B) = t0 + B/peak.

    Two parameter sets: the festivus path (persistent connections + shared
    metadata KV -> millisecond first-byte) and a gcsfuse-like baseline
    (per-read open/HEAD/validate -> ~80 ms fixed overhead).  Both fitted by
    least squares to Table IV (see tests/test_perfmodel.py for residuals).
    """

    #: fixed per-request overhead, seconds
    request_overhead_s: float = 2.7e-3
    #: streaming bandwidth once flowing, bytes/s
    stream_bytes_per_s: float = 1.81e9
    #: requests a single node can keep in flight before queueing
    max_inflight_per_node: int = 64

    def service_time_s(self, nbytes: int) -> float:
        return self.request_overhead_s + nbytes / self.stream_bytes_per_s

    def single_request_bandwidth(self, nbytes: int) -> float:
        """Bandwidth of back-to-back random reads of `nbytes` (bytes/s)."""
        return nbytes / self.service_time_s(nbytes)


#: festivus path (Table IV left column)
FESTIVUS_STORE_MODEL = ObjectStoreModel(
    request_overhead_s=2.7e-3, stream_bytes_per_s=1.81e9
)

#: gcsfuse-like baseline (Table IV right column): pays metadata + connection
#: churn on every random read.
GCSFUSE_STORE_MODEL = ObjectStoreModel(
    request_overhead_s=80.0e-3, stream_bytes_per_s=1.98e9, max_inflight_per_node=1
)


@dataclasses.dataclass(frozen=True)
class LocalSsdModel:
    """Per-worker local-SSD tier service-time model, t(B) = t0 + B/peak.

    The second storage level of the two-level design (Xuan et al.,
    PAPERS.md): a node-attached NVMe device between the RAM block cache
    and the remote bucket.  Parameters follow the GCE local-SSD class of
    device the paper's cluster exposes (Table I prices it at
    :attr:`CostModel.local_ssd_gb_s`): tens-of-microseconds first-byte
    latency and per-device streaming bandwidth in the GB/s range —
    roughly 20x cheaper first-byte and comparable streaming rate versus
    the object store's millisecond request overhead.

    Reads bill on the serving path (an SSD hit replaces a remote GET and
    its fabric flow).  Writes model the admission/fill cost; the Festivus
    tier admits write-behind — fills ride the device write queue off the
    request path — so write time is *reported* (``ssd_fill_write_s``)
    rather than added to the admitting request's latency.
    """

    #: first-byte latency of a random device read, seconds
    read_latency_s: float = 80e-6
    #: sustained device read bandwidth, bytes/s
    read_bytes_per_s: float = 1.56e9
    #: first-byte latency of a device write (queued, then flushed), seconds
    write_latency_s: float = 30e-6
    #: sustained device write bandwidth, bytes/s
    write_bytes_per_s: float = 1.09e9

    def read_time_s(self, nbytes: int) -> float:
        return self.read_latency_s + nbytes / self.read_bytes_per_s

    def write_time_s(self, nbytes: int) -> float:
        return self.write_latency_s + nbytes / self.write_bytes_per_s


#: default local-SSD tier device (GCE local-SSD class)
LOCAL_SSD_MODEL = LocalSsdModel()


#: Table III 16-vCPU measured aggregate curve, (nodes, bytes/s) — the
#: calibration anchors for the zone-capacity interpolation below.
_TABLE_III_CURVE = ((1, 1.0 * GB), (4, 4.1 * GB), (16, 17.4 * GB),
                    (64, 36.3 * GB), (128, 70.5 * GB), (512, 231.3 * GB))


@dataclasses.dataclass(frozen=True)
class FabricModel:
    """Zone-fabric contention model (Table III fit).

    Two views of the same measurement:

    * :meth:`aggregate_bytes_per_s` — the closed-form fit used by the
      analytic projections (linear to `contention_onset_nodes`, then the
      power law ``agg(N) = a * N**b`` that matches the 64/128/512-node
      rows to ~3%).
    * :meth:`zone_capacity_bytes_per_s` — the capacity the *simulated*
      fabric grants ``readers`` concurrently-reading mounts: log-log
      interpolation through the measured rows themselves (including the
      1-node row, which sits below the analytic line), power-law
      extrapolated beyond 512.  The DES water-fills this capacity across
      the in-flight readers, so per-node bandwidth degrades inside the
      simulation rather than being min()-ed on afterwards.
    """

    per_node_bytes_per_s: float = 1.0875 * GB  # 17.4 GB/s over 16 nodes
    contention_onset_nodes: int = 16
    fabric_coeff: float = 0.930 * GB
    fabric_exponent: float = 0.886

    def aggregate_bytes_per_s(self, nodes: int) -> float:
        linear = nodes * self.per_node_bytes_per_s
        if nodes <= self.contention_onset_nodes:
            return linear
        return min(linear, self.fabric_coeff * nodes**self.fabric_exponent)

    def zone_capacity_bytes_per_s(self, readers: int) -> float:
        if readers <= 0:
            return 0.0
        curve = _TABLE_III_CURVE
        if readers <= curve[0][0]:
            return readers * curve[0][1]
        last_n, last_bw = curve[-1]
        if readers >= last_n:
            return last_bw * (readers / last_n) ** self.fabric_exponent
        for (n0, bw0), (n1, bw1) in zip(curve, curve[1:]):
            if n0 <= readers <= n1:
                frac = (math.log(readers) - math.log(n0)) \
                    / (math.log(n1) - math.log(n0))
                return math.exp(math.log(bw0)
                                + frac * (math.log(bw1) - math.log(bw0)))
        raise AssertionError("unreachable")


FABRIC_MODEL = FabricModel()


def water_fill(demands, capacity: float):
    """Max-min fair allocation of `capacity` across flows with `demands`.

    Returns a list of rates, one per demand: every flow gets its full
    demand if the sum fits, otherwise the capacity is shared fairly —
    small flows are satisfied first, the rest split what remains evenly
    (the classic water-filling progression).

    The fair share is computed *once*, when the water level freezes (the
    first flow, in ascending-demand order, whose demand exceeds
    ``remaining / left``): every unsatisfied flow is granted that same
    float.  Mathematically this equals the per-flow ``remaining / left``
    progression, but bit-exactly so — which matters upstream: equal
    demands get *identical* rates, so a synchronized wave of identical
    flows finishes at one simulated instant instead of smearing across
    ulp-separated timestamps and triggering a reallocation cascade.
    """
    demands = list(demands)
    if not demands:
        return []
    if any(d < 0 for d in demands):
        raise ValueError(f"negative demand in {demands}")
    if sum(demands) <= capacity:
        return demands
    alloc = [0.0] * len(demands)
    remaining = capacity
    left = len(demands)
    share = None
    for i in sorted(range(len(demands)), key=demands.__getitem__):
        if share is None:
            level = remaining / left
            if demands[i] <= level:
                alloc[i] = demands[i]
                remaining -= demands[i]
                left -= 1
                continue
            share = level  # the water level: demands only grow from here
        alloc[i] = share
    return alloc


class SharedFabric:
    """The zone fabric as a shared, *simulated* resource.

    Each concurrently-reading mount registers a flow (its uncontended
    bandwidth demand, i.e. min of its stream parallelism and node cap);
    the per-zone capacity — which itself depends on how many readers that
    zone currently has — is water-filled across them.  The cluster DES
    re-queries this whenever the reader set changes, which is exactly what
    makes the 512-node curve sub-linear *inside* the simulation
    (Table III) instead of via a post-hoc cap.

    Water-filling is **incremental**: membership changes only mark the
    affected zone dirty, and :meth:`reflow` re-water-fills dirty zones
    alone, reporting exactly the flows whose granted rate changed — the
    contract that lets the DES re-predict I/O completions for those flows
    only instead of re-pushing every in-flight prediction.  A per-zone
    epoch counts that zone's reallocation generations.  :meth:`allocations`
    (a full rate dict) is kept for callers and tests that want the
    from-scratch view; it is served from the same cache.

    **Link domains.**  Beyond the integer zones, :meth:`add_link`
    registers named *fixed-capacity* domains — the inter-region WAN links
    of the multi-region topology.  A link domain water-fills exactly like
    a zone (same incremental dirty-set discipline, same changed-rate
    contract) but its capacity is the provisioned link bandwidth rather
    than the Table III reader-count curve: a WAN pipe does not get faster
    when more readers pile on.  Cross-region reads route their flows to
    the link domain of the (reader region, data region) pair, so WAN
    contention emerges from the same water-filling the intra-zone fabric
    uses — no global recomputation, no second allocator.
    """

    def __init__(self, model: Optional[FabricModel] = None, zones: int = 1):
        if zones < 1:
            raise ValueError(f"zones must be >= 1, got {zones}")
        self.model = model if model is not None else FABRIC_MODEL
        self.zones = zones
        #: flow key -> (domain, demand bytes/s); domain is an int zone or a
        #: registered link key
        self._flows: Dict[Any, Tuple[Any, float]] = {}
        #: domain -> {flow key -> demand}, insertion-ordered per domain (the
        #: order water_fill sees, so incremental == from-scratch exactly)
        self._zone_flows: Dict[Any, Dict[Any, float]] = {}
        #: cached granted rate per flow (valid for non-dirty domains)
        self._rates: Dict[Any, float] = {}
        self._dirty_zones: set = set()
        self._zone_epochs: Dict[Any, int] = {}
        #: link key -> fixed capacity bytes/s (domains water-filled against
        #: a provisioned cap instead of the Table III curve)
        self._link_caps: Dict[Any, float] = {}
        #: domain -> capacity multiplier in (0, 1] (fault injection: a zone
        #: outage or WAN brownout temporarily rescales the domain).  Absent
        #: domains are never multiplied at all, so a fabric that has never
        #: seen a fault computes capacities bit-identically to one built
        #: before this field existed.
        self._cap_scale: Dict[Any, float] = {}

    def add_link(self, key, capacity_bytes_per_s: float) -> None:
        """Register fixed-capacity domain `key` (an inter-region link).

        Flows added with this key as their zone water-fill against
        `capacity_bytes_per_s` instead of the reader-count curve.
        Idempotent for an identical capacity; re-registering a link with a
        different capacity is an error (it would silently re-price
        in-flight transfers)."""
        if isinstance(key, int):
            raise TypeError(f"link keys must not be ints (zone ids): {key!r}")
        cap = float(capacity_bytes_per_s)
        if cap <= 0:
            raise ValueError(f"link {key!r} capacity must be > 0, got {cap}")
        prev = self._link_caps.get(key)
        if prev is not None and prev != cap:
            raise ValueError(f"link {key!r} already registered at {prev} B/s")
        self._link_caps[key] = cap

    def set_capacity_scale(self, zone, scale: float) -> None:
        """Rescale domain capacity by `scale` in (0, 1] — the zone-outage /
        link-brownout injection point.  Marks the domain dirty so the next
        :meth:`reflow` re-water-fills its flows against the degraded
        capacity through the normal incremental path.  ``scale == 1.0``
        clears the entry entirely (full restoration leaves no trace, so a
        healed fabric is indistinguishable from a never-faulted one).
        Zero is rejected: a dead domain would strand its in-flight flows
        at rate 0 with no completion prediction; model an outage as a deep
        brownout (e.g. 0.01) instead."""
        if not 0.0 < scale <= 1.0:
            raise ValueError(f"capacity scale must be in (0, 1], got {scale}")
        z = self._domain(zone)
        if scale == 1.0:
            self._cap_scale.pop(z, None)
        else:
            self._cap_scale[z] = scale
        self._dirty_zones.add(z)

    def capacity_scale(self, zone) -> float:
        """Current capacity multiplier for `zone` (1.0 when unfaulted)."""
        return self._cap_scale.get(self._domain(zone), 1.0)

    def _domain(self, zone) -> Any:
        if isinstance(zone, int):
            return zone % self.zones
        if zone not in self._link_caps:
            raise KeyError(f"unregistered link domain {zone!r}")
        return zone

    def add_flow(self, key, zone, demand_bytes_per_s: float) -> None:
        if key in self._flows:
            raise ValueError(f"duplicate fabric flow {key!r}")
        z = self._domain(zone)
        self._flows[key] = (z, float(demand_bytes_per_s))
        self._zone_flows.setdefault(z, {})[key] = float(demand_bytes_per_s)
        self._dirty_zones.add(z)

    def remove_flow(self, key) -> None:
        z, _ = self._flows.pop(key)
        del self._zone_flows[z][key]
        self._rates.pop(key, None)
        self._dirty_zones.add(z)

    def readers(self, zone=None) -> int:
        if zone is None:
            return len(self._flows)
        return len(self._zone_flows.get(zone, ()))

    def zone_epoch(self, zone) -> int:
        """How many times `zone` has been re-water-filled (diagnostic)."""
        z = zone % self.zones if isinstance(zone, int) else zone
        return self._zone_epochs.get(z, 0)

    def _reflow_zone(self, z, changed: Dict[Any, float]) -> None:
        flows = self._zone_flows.get(z, {})
        self._zone_epochs[z] = self._zone_epochs.get(z, 0) + 1
        if not flows:
            return
        cap = self._link_caps.get(z)
        if cap is None:
            cap = self.model.zone_capacity_bytes_per_s(len(flows))
        scale = self._cap_scale.get(z)
        if scale is not None:  # fault-injected outage/brownout in effect
            cap *= scale
        granted = water_fill(list(flows.values()), cap)
        for key, rate in zip(flows, granted):
            if self._rates.get(key) != rate:
                self._rates[key] = rate
                changed[key] = rate

    def reflow(self) -> Dict[Any, float]:
        """Re-water-fill the domains whose membership changed since the
        last call; returns ``{flow key: new rate}`` for exactly the flows
        whose granted rate actually changed (a satisfied small flow that
        keeps its full demand through a membership change is *not*
        reported).  Zones reflow before link domains, each group in
        deterministic order — with no links registered the iteration is
        exactly the pre-link ``sorted(int zones)``, preserving
        single-region event order bit-for-bit."""
        changed: Dict[Any, float] = {}
        order = sorted(self._dirty_zones,
                       key=lambda d: (1, str(d)) if not isinstance(d, int)
                       else (0, d))
        for z in order:
            self._reflow_zone(z, changed)
        self._dirty_zones.clear()
        return changed

    def allocations(self) -> Dict[Any, float]:
        """Water-filled rate (bytes/s) for every registered flow."""
        self.reflow()
        return dict(self._rates)


@dataclasses.dataclass(frozen=True)
class TileServingModel:
    """Mapserver-role per-request CPU costs (the paper's §V.D web tier).

    The paper serves map tiles by progressively decoding the JPX
    codestream ("decode ... at the resolution requested"); here the
    chunkstore pyramid plays the codestream and these constants bill the
    virtual CPU a server spends per request on top of the modeled object
    I/O (which the cluster DES already water-fills against the fabric):

    * ``decode_s_per_byte`` — progressive wavelet/entropy decode at
      ~500 MB/s per core (an optimized JPEG 2000 resolution-level decode;
      the raw-codec analogue here is cheaper, the bill is the model's).
    * ``request_overhead_s`` — HTTP parse + tile assembly + response
      write, ~0.8 ms.
    * ``cache_hit_s`` — serving straight from the in-memory tile cache.
    * ``edge_hit_s`` — a hit at the CDN/edge tier *in front of* the fleet:
      the request never reaches a server (no queueing, no worker, no HTTP
      parse on a mapserver), it pays only the edge lookup + response
      write — cheaper than even an unqueued server cache hit.
    """

    decode_s_per_byte: float = 1.0 / 500e6
    request_overhead_s: float = 0.8e-3
    cache_hit_s: float = 60e-6
    edge_hit_s: float = 30e-6

    def miss_cost_s(self, nbytes: int) -> float:
        return self.request_overhead_s + nbytes * self.decode_s_per_byte

    def hit_cost_s(self) -> float:
        return self.cache_hit_s

    def edge_hit_cost_s(self) -> float:
        return self.edge_hit_s

    def encode_cost_s(self, nbytes: int, fmt: str = "raw") -> float:
        """CPU bill for encoding `nbytes` raw tile bytes to `fmt` (0.0 for
        raw: the default format changes nothing, bit-for-bit)."""
        return tile_format(fmt).encode_s_per_byte * nbytes

    def wire_bytes(self, nbytes: int, fmt: str = "raw") -> int:
        """Bytes actually sent (and edge-cached) for `nbytes` raw tile
        bytes encoded as `fmt` — the honest response size."""
        return tile_format(fmt).wire_bytes(nbytes)


@dataclasses.dataclass(frozen=True)
class TileFormat:
    """One wire encoding for served tiles: compression ratio + encode cost.

    ``bytes_per_raw_byte`` is the response-size ratio on natural imagery
    (PNG lossless ~2.6x on composite reflectance tiles; JPEG q~80 ~15x);
    ``encode_s_per_byte`` bills the encoder per *raw* byte (libpng-class
    ~150 MB/s, libjpeg-turbo-class ~220 MB/s).  The "raw" format is the
    identity: ratio 1.0, zero cost — the pre-encode-model behaviour.
    """

    name: str
    bytes_per_raw_byte: float
    encode_s_per_byte: float

    def __post_init__(self):
        if not 0.0 < self.bytes_per_raw_byte <= 1.0:
            raise ValueError(f"bytes_per_raw_byte must be in (0, 1]: {self}")
        if self.encode_s_per_byte < 0:
            raise ValueError(f"negative encode cost: {self}")

    def wire_bytes(self, nbytes: int) -> int:
        return int(nbytes * self.bytes_per_raw_byte)


#: the formats a tile request may name (TileRequest.fmt)
TILE_FORMATS = {
    "raw": TileFormat("raw", 1.0, 0.0),
    "png": TileFormat("png", 0.38, 1.0 / 150e6),
    "jpeg": TileFormat("jpeg", 0.065, 1.0 / 220e6),
}


def tile_format(fmt: str) -> TileFormat:
    try:
        return TILE_FORMATS[fmt]
    except KeyError:
        raise ValueError(f"unknown tile format {fmt!r} "
                         f"(known: {sorted(TILE_FORMATS)})") from None


TILE_SERVING_MODEL = TileServingModel()


@dataclasses.dataclass(frozen=True)
class IngestModel:
    """Scene-ingest and wheel-reanalysis CPU costs (the write tier).

    The Matsu-wheel shape: new Landsat/Sentinel scenes keep arriving, an
    ingest task decodes/QAs each scene and writes it into the composite's
    chunk grid (the object PUTs are modeled I/O, water-filled against the
    fabric like any flow — these constants bill only the CPU on top), and
    a recurring wheel pass re-scans each ingested batch:

    * ``decode_s_per_byte`` — L1 radiometric correction + cloud/QA mask
      at ~200 MB/s per core (scene decode is heavier than tile decode).
    * ``scene_overhead_s`` — per-scene fixed work: geo-registration
      lookup, manifest update, provenance record.
    * ``scan_s_per_byte`` — wheel band math (NDVI-class per-pixel index)
      over already-decoded pixels, ~800 MB/s per core.
    """

    decode_s_per_byte: float = 1.0 / 200e6
    scene_overhead_s: float = 2e-3
    scan_s_per_byte: float = 1.0 / 800e6

    def ingest_cost_s(self, nbytes: int, scenes: int = 1) -> float:
        return scenes * self.scene_overhead_s + nbytes * self.decode_s_per_byte

    def scan_cost_s(self, nbytes: int) -> float:
        return nbytes * self.scan_s_per_byte


INGEST_MODEL = IngestModel()

#: virtual seconds between a serve-pool join being requested and the new
#: server taking traffic: process start + festivus mount + first manifest
#: sync.  Deliberately on the benchmark traces' compressed virtual
#: timescale (a real GCE VM boots in ~tens of seconds against minutes-long
#: spikes; the traces compress a spike to ~0.25 virtual seconds, so the
#: warm-up compresses with it — what matters is that capacity added by the
#: autoscaler is *not* free or instant, and every joiner's first completion
#: provably waits out this window).
SERVE_WARMUP_S = 0.05

#: §IV.A's measured node rate ("$0.51 per node hour", n1-highcpu-64): the
#: $-proxy the serving benchmark multiplies worker-seconds by.  A proxy —
#: serve nodes are smaller than LINPACK nodes — but it is the paper's own
#: number, and it prices fixed-vs-autoscaled fleets identically.
NODE_COST_PER_HR_USD = 0.51


def worker_seconds_cost(worker_seconds: float) -> float:
    """$-proxy for a fleet's total node uptime (see NODE_COST_PER_HR_USD)."""
    return worker_seconds * NODE_COST_PER_HR_USD / 3600.0


def percentile(values, q: float) -> float:
    """Linear-interpolated percentile (numpy's default method), for
    virtual-time latency distributions.  `q` in [0, 100]."""
    return percentile_sorted(sorted(values), q)


def percentile_sorted(vals, q: float) -> float:
    """:func:`percentile` over an already-ascending sequence — the O(1)
    variant for callers that maintain a sorted window incrementally (the
    autoscaler's per-tick path) instead of re-sorting per query."""
    if not vals:
        raise ValueError("percentile of empty sequence")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"q={q} outside [0, 100]")
    pos = (len(vals) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    return vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Table I: fundamental computing costs, $/s per giga-unit (2016)."""

    cloud_storage_gb_s: float = 1.0e-8
    persistent_disk_gb_s: float = 1.5e-8
    local_ssd_gb_s: float = 6.5e-8
    linpack_gflops_s: float = 1.6e-7
    node_memory_gb_s: float = 2.5e-7
    local_network_gbps_s: float = 3.8e-5
    wan_gbps_s: float = 1.0e-2
    human_labor_s: float = 2.8e-2
    internet_egress_gbps_s: float = 1.0e-1

    def storage_cost(self, nbytes: int, seconds: float) -> float:
        return (nbytes / GB) * seconds * self.cloud_storage_gb_s

    def flops_cost(self, flops: float) -> float:
        return (flops / 1e9) * self.linpack_gflops_s

    def teraflop_hour_cost(self) -> float:
        """$/TF-hour implied by Table I (cf. §IV.A's measured $0.84)."""
        return self.linpack_gflops_s * 1e3 * 3600.0


COST_MODEL = CostModel()

def paper_table_iv_rows():
    """(blocksize_bytes, festivus_MB_s, gcsfuse_MB_s) verbatim from Table IV."""
    return [
        (32768, 12.5, 0.4),
        (65536, 22.6, 0.8),
        (131072, 47.3, 1.6),
        (262144, 93.0, 2.8),
        (524288, 156.8, 7.3),
        (1048576, 271.0, 13.7),
        (2097152, 472.0, 24.8),
        (4194304, 852.3, 46.7),
        (8388608, 1046.4, 109.5),
        (16777216, 1248.0, 200.3),
        (33554432, 1593.3, 339.7),
    ]


def paper_table_iii_rows():
    """(vcpus, nodes, aggregate_GB_s) verbatim from Table III."""
    return [
        (1, 1, 0.43),
        (4, 1, 0.85),
        (16, 1, 1.0),
        (32, 1, 1.44),
        (16, 4, 4.1),
        (16, 16, 17.4),
        (16, 64, 36.3),
        (16, 128, 70.5),
        (16, 512, 231.3),
    ]


class WorkerClock:
    """Worker-local monotonic virtual clock (one per simulated cluster node).

    The cluster engine advances a node's clock by the modeled duration of
    each task (service time water-filled over in-flight streams, capped by
    the node NIC/CPU law); the makespan of a simulated fleet is then the
    max over its workers' clocks.  Thread-safe so the real-time engine mode
    can share the same worker objects.
    """

    def __init__(self, start: float = 0.0):
        self._t = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"clock must be monotonic, got dt={dt}")
        with self._lock:
            self._t += dt
            return self._t

    def advance_to(self, t: float) -> float:
        with self._lock:
            self._t = max(self._t, t)
            return self._t

    def __call__(self) -> float:
        return self.now()


#: single-node festivus efficiency law, fitted to Table III's 1/4/16/32-vCPU
#: rows: b(v) = 0.43 GB/s x v^0.349 — the FUSE+TLS+checksum CPU cost that
#: keeps a node below its nominal NIC rate (the paper's 32-vCPU row reaches
#: "over 70% of its network capacity"; smaller nodes proportionally less).
FESTIVUS_NODE_LAW_COEFF = 0.43 * GB
FESTIVUS_NODE_LAW_EXP = 0.349


def node_cap_bytes_per_s(vcpus: int) -> float:
    """Per-node sustained-bandwidth ceiling (bytes/s): min of the NIC
    allocation and the fitted FUSE+TLS+checksum CPU-efficiency law."""
    return min(NetworkModel().node_nic_bytes_per_s(vcpus),
               FESTIVUS_NODE_LAW_COEFF * vcpus**FESTIVUS_NODE_LAW_EXP)


def single_node_bandwidth(vcpus: int, model: ObjectStoreModel, *, block_bytes: int,
                          inflight: int) -> float:
    """Modeled single-node aggregate read bandwidth (bytes/s).

    min of: `inflight` concurrent range-GET streams, the NIC, and the
    fitted per-node CPU-efficiency law (see FESTIVUS_NODE_LAW_*).
    """
    net = NetworkModel()
    per_stream = model.single_request_bandwidth(block_bytes)
    cpu_law = FESTIVUS_NODE_LAW_COEFF * vcpus**FESTIVUS_NODE_LAW_EXP
    return min(per_stream * max(1, inflight),
               net.node_nic_bytes_per_s(vcpus), cpu_law)


def cluster_bandwidth(nodes: int, vcpus: int, model: ObjectStoreModel, *,
                      block_bytes: int, inflight: int) -> float:
    """Modeled aggregate bandwidth for `nodes` nodes (bytes/s), Table III."""
    per_node = single_node_bandwidth(vcpus, model, block_bytes=block_bytes,
                                     inflight=inflight)
    return min(nodes * per_node, FABRIC_MODEL.aggregate_bytes_per_s(nodes))


def fit_service_time_params(rows):
    """Least-squares fit of t(B) = t0 + B/peak to (blocksize, MB/s) rows.

    Returns (t0_seconds, peak_bytes_per_s).  Used by tests to confirm the
    constants above against Table IV.
    """
    xs = [float(b) for b, _ in rows]
    ts = [b / (mb * 1e6) for b, mb in rows]
    n = len(xs)
    mx = sum(xs) / n
    mt = sum(ts) / n
    sxx = sum((x - mx) ** 2 for x in xs)
    sxt = sum((x - mx) * (t - mt) for x, t in zip(xs, ts))
    slope = sxt / sxx
    t0 = mt - slope * mx
    return t0, 1.0 / slope



# ---------------------------------------------------------------------------
# the H100 roofline (data sheet figures: NVIDIA H100 80GB HBM3, 700 W)
# ---------------------------------------------------------------------------
#: dense bf16 operations/s on the tensor cores
H100_PEAK_BF16_OPS_PER_S = 989e12
#: f32 operations/s outside the tensor cores
H100_PEAK_F32_OPS_PER_S = 67e12
#: HBM3 bytes/s
H100_HBM_BYTES_PER_S = 3.35e12
#: HBM capacity ("80 GB"); a run on the card reads the card's own
#: (``torch.cuda.get_device_properties(0).total_memory``)
H100_HBM_BYTES = 80 * GB
#: GPUs of one node, all to all on NVLink 4
H100_GPUS_PER_NODE = 8
#: NVLink 4 bytes/s each way a GPU (900 GB/s both ways)
H100_NVLINK_BYTES_PER_S = 450e9
#: one 400 Gb/s NIC a GPU between nodes
H100_NIC_BYTES_PER_S = 400e9 / 8


def link_bytes_per_s(ranks) -> float:
    """The slowest link a collective over ``ranks`` (global ranks, 8 to a
    node) crosses: NVLink within a node, a GPU's NIC across nodes."""
    nodes = {r // H100_GPUS_PER_NODE for r in ranks}
    return H100_NVLINK_BYTES_PER_S if len(nodes) <= 1 else H100_NIC_BYTES_PER_S


def roofline_terms(flops: float, hbm_bytes: float, collective_s: float,
                   chips: int):
    """The three roofline terms of one step, in seconds (max dominates):
    global ``flops`` at the bf16 tensor-core peak and global ``hbm_bytes``
    at the HBM rate, both spread over ``chips``; ``collective_s`` is one
    device's wire time, each collective priced at its link
    (:func:`link_bytes_per_s`)."""
    terms = {"compute_s": flops / (chips * H100_PEAK_BF16_OPS_PER_S),
             "memory_s": hbm_bytes / (chips * H100_HBM_BYTES_PER_S),
             "collective_s": collective_s}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k])
    terms["step_s"] = max(terms["compute_s"], terms["memory_s"],
                          terms["collective_s"])
    return terms
