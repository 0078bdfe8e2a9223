"""Geo-distributed serving: per-region fleets, replica routing, WAN links.

The paper's §V.D tier serves one region; the wide-area regime (Grossman's
data clouds, Sector/Sphere) is *global* traffic against *placed* data.
This module closes that loop inside one cluster-DES simulation:

* **Topology** — one fabric zone per region (pools pinned via
  :attr:`ClusterConfig.pool_zones`), joined by the calibrated
  inter-region links of :mod:`repro_torch.configs.regions` registered as
  fixed-capacity fabric domains (:attr:`ClusterConfig.fabric_links`).
* **Routing** — ``"geo"`` sends each request to its client region's
  fleet (nearest fleet by RTT when the client continent hosts none);
  ``"single"`` is the baseline: one fleet in the primary region, every
  remote client paying the full internet RTT both ways.
* **Replicas** — a :class:`~repro_torch.core.object_store.ReplicaMap` decides,
  per tile, which region a serving miss reads from.  A cross-region read
  routes its drained I/O over the WAN link via
  :meth:`~repro_torch.launch.cluster.Worker.route_io`: it water-fills against
  the link's provisioned capacity, pays the link RTT as first-byte tail,
  and bills Table I egress into the engine's accounting.  demand_k
  promotions additionally bill the replica copy itself.
* **Edges & autoscalers** — each regional fleet is fronted by its own
  :class:`~repro_torch.serve.tileserver.EdgeCache` (distinct per-continent
  working sets) and, optionally, steered by its own
  :class:`~repro_torch.serve.autoscale.ServeAutoscaler` targeting that
  region's pool — all regions' loops ticking inside the same DES.

Latency is measured at the *client*: fleet-side completion plus the
client<->fleet round trip, so geo-routing's win (zero client RTT) and
pin-primary's cost (WAN RTT per remote miss) both show up in the same
p99 the benchmark sweeps.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.regions import (
    REGIONS,
    client_rtt_s,
    inter_region_link,
    nearest_region,
)
from repro_torch.core import perfmodel
from repro_torch.core.chunkstore import ChunkedArray, ChunkStore
from repro_torch.core.festivus import Festivus, FestivusConfig
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.object_store import ObjectStore, ReplicaMap
from repro_torch.launch.cluster import (
    ClusterConfig,
    ClusterEngine,
    ClusterReport,
    ElasticEvent,
    FleetController,
    FleetView,
    Worker,
)
from repro_torch.serve.autoscale import AutoscalePolicy, AutoscaleReport, ServeAutoscaler
from repro_torch.serve.tileserver import EdgeCache, TileRequest, TileServer, tile_bounds


def serve_pool(region: str) -> str:
    """The worker-pool name of a region's serve fleet."""
    return f"serve:{region}"


class RegionalAutoscalers(FleetController):
    """One ServeAutoscaler per region, ticked together inside one DES.

    Each scaler watches only its own pool (``serve:<region>``) and its
    own region's arrivals; their emitted joins/drains all flow through
    the same engine elasticity machinery, so the per-region loops stay
    exactly-once without a second control plane.
    """

    def __init__(self, scalers: Dict[str, ServeAutoscaler]):
        if not scalers:
            raise ValueError("need at least one regional scaler")
        self.scalers = dict(scalers)
        self.interval_s = min(s.interval_s for s in self.scalers.values())

    def tick(self, now: float, view: FleetView) -> List[ElasticEvent]:
        out: List[ElasticEvent] = []
        for region in sorted(self.scalers):
            out.extend(self.scalers[region].tick(now, view) or ())
        return out


@dataclasses.dataclass
class GeoServingReport:
    """Gathered outcome of one geo-serving run (virtual time throughout)."""

    routing: str
    placement: str
    regions: Tuple[str, ...]
    primary: str
    servers_total: int
    servers_by_region: Dict[str, int]
    requests: int
    completed: int
    #: client-measured latency (fleet completion + client<->fleet RTT)
    p50_s: float
    p90_s: float
    p99_s: float
    mean_s: float
    max_s: float
    #: client region -> {requests, p50_s, p99_s, mean_s, serving_region}
    per_region: Dict[str, Dict[str, Any]]
    #: cross-region reads (server misses served from a remote replica)
    remote_reads: int
    #: WAN bytes/$ those reads drained (engine-billed Table I egress)
    egress_bytes: int
    read_egress_usd: float
    #: replica copies: full_mirror's upfront fan-out + demand_k promotions
    replication_bytes: int
    replication_usd: float
    promotions: int
    #: serve-node uptime and the egress-inclusive §IV.A bill
    serve_worker_seconds: float
    node_cost_usd: float
    cost_usd: float
    hit_rate: float
    edge_hit_rate: float
    combined_hit_rate: float
    cluster: ClusterReport
    #: (client arrival t, client latency, client region), arrival order
    samples: List[Tuple[float, float, str]] = dataclasses.field(
        default_factory=list)
    #: per-region autoscaler outcomes (None when fleets ran fixed-size)
    autoscale: Optional[Dict[str, AutoscaleReport]] = None

    @property
    def all_served(self) -> bool:
        return self.completed == self.requests

    def region_percentile(self, region: str, q: float) -> float:
        lats = [lat for _, lat, r in self.samples if r == region]
        if not lats:
            return float("nan")
        return perfmodel.percentile(lats, q)


class GeoTileFleet:
    """Per-region tile fleets over replicated chunkstore data, in one DES.

    ``servers_by_region`` names the fleet regions and their sizes (the
    primary region must host a fleet — it holds the authoritative data).
    ``routing="single"`` with ``{primary: N}`` is the baseline shape;
    ``routing="geo"`` with fleets across continents is the treatment.
    All fleets share one engine: one event loop, one fabric (a zone per
    region + the calibrated WAN links), one completion record — so the
    placement-policy comparison is same-simulation, not cross-run.
    """

    def __init__(self, store: ObjectStore, meta: MetadataStore,
                 root: str = "bucket", *,
                 servers_by_region: Dict[str, int],
                 regions: Sequence[str] = REGIONS,
                 primary: str = "usa",
                 routing: str = "geo",
                 placement: str = "pin_primary",
                 k: int = 2, promote_after: int = 3,
                 tile_px: int = 256, cache_bytes: int = 64 * perfmodel.MiB,
                 serving_model: Optional[perfmodel.TileServingModel] = None,
                 vcpus: int = 16,
                 fabric: Optional[perfmodel.FabricModel] = perfmodel.FABRIC_MODEL,
                 block_bytes: int = 4 * perfmodel.MiB,
                 max_inflight: int = 16,
                 edge_cache_bytes: int = 0,
                 autoscale: Optional[AutoscalePolicy] = None):
        if routing not in ("geo", "single"):
            raise ValueError(f"routing must be 'geo' or 'single', got "
                             f"{routing!r}")
        if placement not in ReplicaMap.POLICIES:
            raise ValueError(f"unknown placement {placement!r} "
                             f"(known: {ReplicaMap.POLICIES})")
        self.regions = tuple(regions)
        if primary not in self.regions:
            raise ValueError(f"primary {primary!r} not in regions "
                             f"{self.regions}")
        if not servers_by_region:
            raise ValueError("servers_by_region is empty")
        for r, n in servers_by_region.items():
            if r not in self.regions:
                raise ValueError(f"fleet region {r!r} not in {self.regions}")
            if n < 1:
                raise ValueError(f"region {r!r} needs >= 1 server, got {n}")
        if primary not in servers_by_region:
            raise ValueError(f"the primary region {primary!r} must host a "
                             f"fleet (it holds the authoritative data)")
        if routing == "single" and list(servers_by_region) != [primary]:
            raise ValueError("routing='single' takes exactly one fleet, in "
                             "the primary region")
        self.store = store
        self.meta = meta
        self.root = root
        self.primary = primary
        self.routing = routing
        self.placement = placement
        #: fleet regions in self.regions order (stable pools/zones layout)
        self.fleet_regions = tuple(r for r in self.regions
                                   if r in servers_by_region)
        self.servers_by_region = {r: servers_by_region[r]
                                  for r in self.fleet_regions}
        self.k = min(k, len(self.fleet_regions))
        self.promote_after = promote_after
        self.tile_px = tile_px
        self.cache_bytes = cache_bytes
        self.serving_model = (serving_model if serving_model is not None
                              else perfmodel.TILE_SERVING_MODEL)
        self.vcpus = vcpus
        self.fabric = fabric
        self.block_bytes = block_bytes
        self.max_inflight = max_inflight
        self.edge_cache_bytes = edge_cache_bytes
        self.autoscale = autoscale

    # -- topology --------------------------------------------------------------
    def _serving_region(self, client_region: str) -> str:
        if self.routing == "single":
            return self.primary
        return nearest_region(client_region, self.fleet_regions)

    def _links(self) -> Dict[Any, float]:
        links: Dict[Any, float] = {}
        for i, a in enumerate(self.regions):
            for b in self.regions[i + 1:]:
                link = inter_region_link(a, b)
                links[link.key] = link.bandwidth_bytes_per_s
        return links

    def _config(self, controller: Optional[FleetController]) -> ClusterConfig:
        zone_of = {r: i for i, r in enumerate(self.regions)}
        pools = tuple((serve_pool(r), self.servers_by_region[r])
                      for r in self.fleet_regions)
        lease_s = (self.autoscale.lease_s if self.autoscale is not None
                   else 3600.0)
        return ClusterConfig(
            nodes=sum(self.servers_by_region.values()), vcpus=self.vcpus,
            virtual_time=True, lease_s=lease_s,
            idle_poll_s=0.002, max_idle_backoff_s=0.5,
            # speculation off: duplicate tile serves would skew cache stats
            min_completions_for_speculation=10**9,
            fabric=self.fabric, zones=len(self.regions),
            pool_zones={serve_pool(r): zone_of[r]
                        for r in self.fleet_regions},
            fabric_links=self._links(),
            worker_pools=pools, controller=controller,
            festivus=FestivusConfig(block_bytes=self.block_bytes,
                                    readahead_blocks=0, cache_bytes=0,
                                    max_inflight=self.max_inflight))

    # -- the request path ------------------------------------------------------
    def _route_trace(self, trace: Sequence[TileRequest]):
        """client trace -> per-fleet-region (fleet_t, one_way_s, req) lists,
        each sorted by fleet-side arrival (the order that region's edge
        and queue actually see)."""
        routed: Dict[str, List[Tuple[float, float, TileRequest]]] = {
            r: [] for r in self.fleet_regions}
        for req in trace:
            if req.region not in self.regions:
                raise ValueError(f"request region {req.region!r} not in "
                                 f"{self.regions} (tag traces with "
                                 f"geo_trace / region=)")
            s = self._serving_region(req.region)
            ow = client_rtt_s(req.region, s) / 2.0
            routed[s].append((req.t + ow, ow, req))
        for entries in routed.values():
            entries.sort(key=lambda e: e[0])
        return routed

    def _edge_filter(self, routed):
        """Per-region edge pass, in fleet-side arrival order.

        Returns ``(forwarded, followers)``: per region, the entries that
        missed that region's edge (they become fleet tasks, ids matching
        their forwarded order), and the edge-absorbed ``(fleet_t,
        one_way_s, nbytes, leader_id, req)`` tuples resolved into
        latencies later against the leader's completion.  Tile sizes come
        from the manifests alone — the edge caches responses, it never
        reads the pyramid.
        """
        forwarded = {r: list(entries) for r, entries in routed.items()}
        followers: Dict[str, List[Tuple[float, float, int, str, TileRequest]]] \
            = {r: [] for r in routed}
        if not self.edge_cache_bytes:
            return forwarded, followers
        fs = Festivus(self.store, meta=self.meta)
        cs = ChunkStore(fs, self.root)
        arrays: Dict[str, ChunkedArray] = {}
        try:
            for region in self.fleet_regions:
                edge = EdgeCache(self.edge_cache_bytes)
                fwd: List[Tuple[float, float, TileRequest]] = []
                for fleet_t, ow, req in routed[region]:
                    arr = arrays.get(req.array)
                    if arr is None:
                        arr = arrays[req.array] = cs.open(req.array)
                    start, stop = tile_bounds(arr.level_shape(req.level),
                                              self.tile_px, req.x, req.y)
                    raw = int(np.prod([b - a for a, b in zip(start, stop)])
                              * np.dtype(arr.spec.dtype).itemsize)
                    nbytes = self.serving_model.wire_bytes(raw, req.fmt)
                    key = (req.array, req.level, req.x, req.y, req.fmt)
                    leader = edge.get(key)
                    if leader is not None:
                        followers[region].append(
                            (fleet_t, ow, nbytes, leader, req))
                    else:
                        leader = f"g:{region}:{len(fwd):06d}"
                        edge.put(key, nbytes, leader)
                        fwd.append((fleet_t, ow, req))
                forwarded[region] = fwd
        finally:
            fs.close()
        return forwarded, followers

    def _mirror_cost(self) -> Tuple[int, float]:
        """Upfront full-mirror replication: every object under the root
        copied from the primary to every other fleet region, billed at
        that pair's link egress rate."""
        total = sum(self.store.head(k).size
                    for k in self.store.list(f"{self.root}/"))
        nbytes = 0
        usd = 0.0
        for r in self.fleet_regions:
            if r == self.primary:
                continue
            link = inter_region_link(self.primary, r)
            nbytes += total
            usd += link.egress_usd(total)
        return nbytes, usd

    # -- run -------------------------------------------------------------------
    def run(self, trace: Sequence[TileRequest]) -> GeoServingReport:
        if not trace:
            raise ValueError("empty request trace")
        routed = self._route_trace(trace)
        forwarded, followers = self._edge_filter(routed)

        tasks: Dict[str, Any] = {}
        arrivals: Dict[str, float] = {}
        pools: Dict[str, str] = {}
        region_arrivals: Dict[str, Dict[str, float]] = {}
        for region in self.fleet_regions:
            ra: Dict[str, float] = {}
            for i, (fleet_t, _, req) in enumerate(forwarded[region]):
                tid = f"g:{region}:{i:06d}"
                tasks[tid] = req
                arrivals[tid] = fleet_t
                pools[tid] = serve_pool(region)
                ra[tid] = fleet_t
            region_arrivals[region] = ra

        rmap = ReplicaMap(self.fleet_regions, self.primary,
                          policy=self.placement, k=self.k,
                          promote_after=self.promote_after)
        tile_servers: Dict[int, TileServer] = {}

        def handler(worker: Worker, req: TileRequest):
            region = worker.pool.split(":", 1)[1]
            srv = tile_servers.get(worker.index)
            if srv is None:
                srv = tile_servers[worker.index] = TileServer(
                    worker.chunkstore(self.root), tile_px=self.tile_px,
                    cache_bytes=self.cache_bytes, model=self.serving_model,
                    charge=worker.charge_compute)
            out: Dict[str, Any] = {"worker": worker.name}
            ckey = (req.array, req.level, req.x, req.y)
            if not srv.cache.contains(ckey):
                # this request will read the pyramid: pick the replica
                src, promoted = rmap.locate_and_promote(
                    f"{req.array}/{req.level}/{req.x}/{req.y}", region)
                if src != region:
                    link = inter_region_link(region, src)
                    worker.route_io(link.key, extra_tail_s=link.latency_s,
                                    egress_usd_per_gb=link.egress_usd_per_gb)
                    out["remote"] = True
                    out["src"] = src
                if promoted:
                    out["promoted"] = True
            resp = srv.serve(req)
            out["hit"] = resp.cache_hit
            out["nbytes"] = resp.nbytes
            if out.get("promoted"):
                out["copied"] = resp.data.nbytes
            return out

        scalers: Optional[Dict[str, ServeAutoscaler]] = None
        controller: Optional[FleetController] = None
        if self.autoscale is not None:
            scalers = {
                r: ServeAutoscaler(
                    dataclasses.replace(self.autoscale, pool=serve_pool(r)),
                    arrivals=region_arrivals[r])
                for r in self.fleet_regions}
            controller = RegionalAutoscalers(scalers)

        engine = ClusterEngine(self.store, meta=self.meta,
                               config=self._config(controller))
        report = engine.run(tasks, handler, arrivals=arrivals, pools=pools)
        if not report.all_done:
            raise RuntimeError(f"geo serving campaign incomplete: "
                               f"{report.queue_stats} "
                               f"dead={report.dead_tasks}")

        # -- gather ------------------------------------------------------------
        samples: List[Tuple[float, float, str]] = []
        latencies: List[float] = []
        hits = misses = remote_reads = promotions = 0
        repl_bytes = 0
        repl_usd = 0.0
        edge_absorbed = 0
        edge_hit_cost = self.serving_model.edge_hit_cost_s()
        for region in self.fleet_regions:
            for i, (fleet_t, ow, req) in enumerate(forwarded[region]):
                tid = f"g:{region}:{i:06d}"
                done = report.completion_times[tid]
                lat = (done - fleet_t) + 2.0 * ow
                latencies.append(lat)
                samples.append((req.t, lat, req.region))
                res = report.results[tid]
                hits += bool(res["hit"])
                misses += not res["hit"]
                if res.get("remote"):
                    remote_reads += 1
                if res.get("promoted"):
                    promotions += 1
                    copied = res.get("copied", 0)
                    repl_bytes += copied
                    link = inter_region_link(region, res["src"])
                    repl_usd += link.egress_usd(copied)
            for fleet_t, ow, nbytes, leader, req in followers[region]:
                resp_t = report.completion_times[leader]
                if fleet_t < resp_t:
                    lat = (resp_t - fleet_t) + edge_hit_cost
                else:
                    lat = edge_hit_cost
                lat += 2.0 * ow
                latencies.append(lat)
                samples.append((req.t, lat, req.region))
                edge_absorbed += 1
        if self.placement == "full_mirror":
            mb, mu = self._mirror_cost()
            repl_bytes += mb
            repl_usd += mu
        samples.sort(key=lambda s: s[0])

        per_region: Dict[str, Dict[str, Any]] = {}
        by_client: Dict[str, List[float]] = {}
        for _, lat, creg in samples:
            by_client.setdefault(creg, []).append(lat)
        for creg in sorted(by_client):
            lats = by_client[creg]
            per_region[creg] = {
                "requests": len(lats),
                "serving_region": self._serving_region(creg),
                "p50_s": perfmodel.percentile(lats, 50),
                "p99_s": perfmodel.percentile(lats, 99),
                "mean_s": sum(lats) / len(lats),
            }

        serve_workers = [w for w in report.per_worker
                         if w.pool and w.pool.startswith("serve:")]
        serve_worker_seconds = sum(
            (w.left_t if w.left_t is not None
             else max(report.makespan_s, w.joined_t)) - w.joined_t
            for w in serve_workers)
        node_cost_usd = perfmodel.worker_seconds_cost(serve_worker_seconds)
        nreq = len(trace)
        nfwd = sum(len(f) for f in forwarded.values())
        autoscale_reports = None
        if scalers is not None:
            autoscale_reports = {
                r: scalers[r].report(self.servers_by_region[r])
                for r in self.fleet_regions}
        return GeoServingReport(
            routing=self.routing, placement=self.placement,
            regions=self.regions, primary=self.primary,
            servers_total=sum(self.servers_by_region.values()),
            servers_by_region=dict(self.servers_by_region),
            requests=nreq, completed=len(latencies),
            p50_s=perfmodel.percentile(latencies, 50),
            p90_s=perfmodel.percentile(latencies, 90),
            p99_s=perfmodel.percentile(latencies, 99),
            mean_s=sum(latencies) / len(latencies),
            max_s=max(latencies),
            per_region=per_region,
            remote_reads=remote_reads,
            egress_bytes=report.egress_bytes,
            read_egress_usd=report.egress_usd,
            replication_bytes=repl_bytes, replication_usd=repl_usd,
            promotions=promotions,
            serve_worker_seconds=serve_worker_seconds,
            node_cost_usd=node_cost_usd,
            cost_usd=node_cost_usd + report.egress_usd + repl_usd,
            hit_rate=hits / nfwd if nfwd else 0.0,
            edge_hit_rate=edge_absorbed / nreq,
            combined_hit_rate=1.0 - misses / nreq,
            cluster=report, samples=samples,
            autoscale=autoscale_reports)
