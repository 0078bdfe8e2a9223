"""Simulated scatter/gather cluster engine (the paper's fleet, §IV/§V).

The paper's headline result is *aggregate* bandwidth: 512 GCE nodes each
mounting one bucket through festivus and pulling tile work from a shared
Celery queue together read 231 GB/s (Table III).  This module composes the
repo's existing layers — :class:`TaskQueue` (leases, heartbeats, straggler
speculation), :class:`Festivus` (the per-node mount), :class:`ChunkStore`
(tile arrays) — into that deployment shape:

* **Scatter** — a dict of tile tasks is submitted to the shared worker-pull
  queue (the paper's elasticity: workers join, claim, and leave freely).
* **Workers** — each simulated node owns a *private* festivus mount (its own
  block cache, async engine, and stats) over the *shared* object store and
  the *shared* metadata KV, exactly the paper's "metadata server is shared
  by all instances of the file system".
* **Gather** — queue results plus per-worker ``StoreStats`` /
  ``FestivusStats`` / virtual clocks are reduced into a
  :class:`ClusterReport` carrying the aggregate-bandwidth figure.

Two execution modes share one worker contract:

* ``virtual_time=False`` (default) — N real threads against the store at
  native speed; wall-clock makespan.  This is what the application
  campaigns (calibration, composite, segmentation) run on.
* ``virtual_time=True`` — a deterministic discrete-event simulation.  Each
  worker owns a :class:`perfmodel.WorkerClock`; a task's I/O becomes a
  *flow* — its bytes drain at a rate that is water-filled twice: over the
  mount's in-flight streams and per-node NIC/CPU law
  (:func:`perfmodel.node_cap_bytes_per_s`) to get the node's uncontended
  demand, then across *all concurrently-reading mounts* against the zone
  fabric's capacity (:class:`perfmodel.SharedFabric`, the Table III
  contention curve).  Whenever the reader set changes — a task starts or
  finishes its I/O, a node joins or is pre-empted — the affected zone is
  re-water-filled *incrementally* and exactly the flows whose granted rate
  changed get fresh I/O-completion predictions, so per-node bandwidth
  degrades *inside* the simulation exactly as the paper measured, with no
  post-hoc cap and no O(flows) work per reader-set change.
  Metadata-KV ops (stat/sync_metadata against the shared Redis-role store)
  and virtual compute (:meth:`Worker.charge_compute`) are charged to the
  worker clock after the I/O phase.  Handler side effects apply eagerly
  (real data always flows; only time is virtual), so tasks must be
  idempotent and write disjoint outputs — the paper's tile model.

Request-shaped tasks (virtual-time only): :meth:`ClusterEngine.run`
accepts per-task ``arrivals`` (a task becomes claimable at its virtual
arrival instant, and an arrival wakes idle workers immediately — the
request-socket model) and ``pools`` (tasks routed to named worker pools,
:attr:`ClusterConfig.worker_pools`), with per-task
:attr:`ClusterReport.completion_times` in the gather.  This is what lets
an interactive serving tier (:mod:`repro.serve`) and a batch campaign
share one queue and one fabric without stealing each other's workers.

Elastic fleets (virtual-time only): an :class:`ElasticSchedule` adds or
pre-empts workers mid-campaign.  A pre-empted worker vanishes without
failing its task — the realistic cloud exit — and the task is handed off
through the existing :class:`TaskQueue` machinery (lease expiry, or
straggler speculation by a surviving worker); completion stays
exactly-once and outputs stay byte-identical because tile tasks are
idempotent.

The schedule can also be extended *mid-run, from inside the simulation*:
a :class:`FleetController` (:attr:`ClusterConfig.controller`) is ticked
every ``interval_s`` of virtual time with a :class:`FleetView` snapshot
(queue depth per pool, completion times, active/warming worker counts)
and returns further :class:`ElasticEvent`\\s — pool-targeted joins with a
warm-up window before the new worker takes traffic, and drains that
prefer idle victims.  This is how :mod:`repro.serve.autoscale` closes the
SLO loop: the scaling decision is itself a participant in the event loop.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import perfmodel
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.festivus import Festivus, FestivusConfig, FestivusStats, SsdTier
from repro_torch.core.metadata import MetadataStore
from repro_torch.core.object_store import (ObjectStore, StoreStats,
                                     TransientStoreError)
from repro_torch.core.taskqueue import TaskQueue
from repro_torch.launch.chaos import ChaosRuntime, ChaosSchedule, StoreStormInjector


class MountStore(ObjectStore):
    """A worker's private view of the shared store.

    Every operation is counted into a per-worker :class:`StoreStats`; in
    virtual-time mode the calibrated service time of each request accrues
    here and the engine drains it into the worker's clock at task
    boundaries (after water-filling over concurrent streams).

    Fault surface: transient failures — whether raised by the backing
    store (e.g. a `FlakyObjectStore` shim) or injected here by a chaos
    throttle-storm oracle (:class:`repro.launch.chaos.StoreStormInjector`,
    consulted against the virtual clock *before* the op runs, so a
    rejected request accrues no service time) — are counted per op name
    into ``fault_counts`` and surfaced as ``WorkerReport.store_faults``.
    """

    def __init__(self, inner: ObjectStore,
                 model: Optional[perfmodel.ObjectStoreModel] = None,
                 chaos: Optional[StoreStormInjector] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.inner = inner
        self.model = model
        self.chaos = chaos
        self.clock = clock
        self.stats = StoreStats()
        #: op name -> transient failures observed at this mount (storm
        #: rejections + inner-store raises); empty on a fault-free run
        self.fault_counts: Dict[str, int] = {}
        #: modeled service time of the most recent accounted op — the
        #: sample Festivus's hedged-read p99 window observes
        self.last_op_service_s: Optional[float] = None
        self._lock = threading.Lock()
        self._pending_service_s = 0.0
        self._pending_bytes = 0

    def _account(self, nbytes: int) -> None:
        if self.model is not None:
            s = self.model.service_time_s(nbytes)
            self._pending_service_s += s
            self._pending_bytes += nbytes
            self.last_op_service_s = s

    def _fault(self, op: str) -> None:
        with self._lock:
            self.fault_counts[op] = self.fault_counts.get(op, 0) + 1

    def _gate(self, op: str) -> None:
        """Chaos throttle-storm gate: inside a storm window, reject the op
        before it reaches the store (no bytes move, no service time)."""
        if self.chaos is not None and self.clock is not None:
            now = self.clock()
            if self.chaos.roll(now):
                self._fault(op)
                raise TransientStoreError(
                    f"throttle storm: {op} rejected at t={now:.6f}")

    def put(self, key, data):
        self._gate("put")
        try:
            meta = self.inner.put(key, data)
        except TransientStoreError:
            self._fault("put")
            raise
        with self._lock:
            self.stats.puts += 1
            self.stats.bytes_written += meta.size
            self._account(meta.size)
        return meta

    def get_range(self, key, offset, length):
        self._gate("get_range")
        try:
            data = self.inner.get_range(key, offset, length)
        except TransientStoreError:
            self._fault("get_range")
            raise
        with self._lock:
            self.stats.gets += 1
            self.stats.bytes_read += len(data)
            self._account(len(data))
        return data

    def get_range_view(self, key, offset, length):
        # the zero-copy fast path festivus block fetches take; accounted
        # identically to get_range (same request count, bytes, and modeled
        # service time — only the memcpy is gone)
        self._gate("get_range")
        try:
            data = self.inner.get_range_view(key, offset, length)
        except TransientStoreError:
            self._fault("get_range")
            raise
        with self._lock:
            self.stats.gets += 1
            self.stats.bytes_read += len(data)
            self._account(len(data))
        return data

    def head(self, key):
        self._gate("head")
        try:
            meta = self.inner.head(key)
        except TransientStoreError:
            self._fault("head")
            raise
        with self._lock:
            self.stats.heads += 1
        return meta

    def list(self, prefix=""):
        out = self.inner.list(prefix)
        with self._lock:
            self.stats.lists += 1
        return out

    def delete(self, key):
        self._gate("delete")
        try:
            self.inner.delete(key)
        except TransientStoreError:
            self._fault("delete")
            raise
        with self._lock:
            self.stats.deletes += 1

    def drain_pending(self):
        """Take (service_seconds, bytes) accrued since the last drain."""
        with self._lock:
            out = (self._pending_service_s, self._pending_bytes)
            self._pending_service_s, self._pending_bytes = 0.0, 0
            return out


class MountMeta:
    """A worker's view of the shared metadata KV (the paper's Redis).

    Forwards every op to the shared :class:`MetadataStore` (all mounts see
    one namespace) while counting ops per worker; in virtual-time mode each
    op also accrues one KV round-trip
    (:data:`perfmodel.METADATA_OP_LATENCY_S` by default) that the engine
    drains into the worker's clock at task boundaries — the stat/manifest
    cost festivus pays in microseconds where gcsfuse pays ~80 ms HEADs.
    """

    _COUNTED = ("get", "set", "setnx", "incr", "delete", "exists", "keys",
                "hset", "hmset", "hget", "hgetall", "hdel", "hlen", "cas")

    def __init__(self, inner: MetadataStore, latency_s: float = 0.0,
                 stall_windows: Tuple[Tuple[float, float, float], ...] = (),
                 clock: Optional[Callable[[], float]] = None):
        self.inner = inner
        self.latency_s = latency_s
        #: chaos KV stalls: (start, end, extra_latency_s) virtual-time
        #: windows during which every op pays the extra round-trip (a hot
        #: shard / compaction pause).  Empty on a fault-free mount — the
        #: per-op cost of the feature is then one falsy check.
        self._stalls = tuple(stall_windows)
        self._clock = clock
        self.ops = 0
        self._pending_s = 0.0
        self._lock = threading.Lock()
        for name in self._COUNTED:
            setattr(self, name, self._wrap(getattr(inner, name)))

    def _wrap(self, method):
        def op(*args, **kwargs):
            with self._lock:
                self.ops += 1
                self._pending_s += self.latency_s
                if self._stalls:
                    now = self._clock()
                    for start, end, extra in self._stalls:
                        if start <= now < end:
                            self._pending_s += extra
                            break
            return method(*args, **kwargs)
        return op

    def __getattr__(self, name):  # anything un-counted passes through
        return getattr(self.inner, name)

    def drain_pending(self) -> float:
        """Take the KV latency accrued since the last drain (seconds)."""
        with self._lock:
            out, self._pending_s = self._pending_s, 0.0
            return out


@dataclasses.dataclass(frozen=True)
class ElasticEvent:
    """One fleet-size change: at virtual time `t`, `delta` workers join
    (positive) or are pre-empted (negative).

    `pool` targets the change at one worker pool (joiners are created *in*
    that pool; leaves pick victims only from it); None keeps the legacy
    behaviour (joiners land in the default shared pool, leaves pre-empt the
    highest-index active workers fleet-wide).  `warmup_s` (joins only)
    holds a new worker out of dispatch until ``t + warmup_s`` — the VM
    boot / mount / first-manifest-sync window an autoscaler must pay
    before added capacity takes traffic.  `prefer_idle` (leaves only) lets
    a *planned* scale-in pick idle victims first — the scheduler's choice,
    not a safety property: a busy victim still vanishes abruptly and its
    task still recovers through lease expiry / speculation.
    """

    t: float
    delta: int
    pool: Optional[str] = None
    warmup_s: float = 0.0
    prefer_idle: bool = False

    def __post_init__(self):
        # validated here, not only in ElasticSchedule: controller-returned
        # events reach the heap without passing through a schedule, and a
        # delta of 0 would classify as a leave whose [0:] victim slice
        # drains the whole fleet
        if self.delta == 0:
            raise ValueError(f"no-op elastic event: {self}")
        if self.warmup_s < 0:
            raise ValueError(f"negative warmup_s in {self}")
        if self.warmup_s and self.delta < 0:
            raise ValueError(f"warmup_s is meaningless on a leave: {self}")


@dataclasses.dataclass(frozen=True)
class ElasticSchedule:
    """A join/leave timetable for an elastic (pre-emptible) fleet.

    Leaves pre-empt the highest-index active workers *abruptly*: a departing
    worker abandons its in-flight task without failing it, so recovery rides
    the TaskQueue lease-expiry / straggler-speculation path — the paper's
    pre-emptible-VM reality.  Joins add brand-new workers (fresh mounts,
    fresh clocks) that start claiming immediately.
    """

    events: Tuple[ElasticEvent, ...]

    def __post_init__(self):
        for ev in self.events:
            if ev.t < 0:
                raise ValueError(f"elastic event before t=0: {ev}")
            if ev.delta == 0:
                raise ValueError(f"no-op elastic event: {ev}")

    @staticmethod
    def churn(nodes: int, fraction: float, leave_t: float,
              rejoin_t: float) -> "ElasticSchedule":
        """`fraction` of an `nodes`-node fleet leaves at `leave_t` and is
        replaced at `rejoin_t` (the benchmark's 25%-churn scenario)."""
        n = int(nodes * fraction)
        if n < 1:
            raise ValueError(
                f"churn fraction {fraction} pre-empts no worker out of "
                f"{nodes}; use fraction >= 1/nodes or no schedule at all")
        if rejoin_t <= leave_t:
            raise ValueError(f"rejoin {rejoin_t} must follow leave {leave_t}")
        return ElasticSchedule((ElasticEvent(leave_t, -n),
                                ElasticEvent(rejoin_t, +n)))


@dataclasses.dataclass(frozen=True)
class FleetView:
    """What a :class:`FleetController` sees at a tick: a read-only snapshot
    of the running campaign, all in virtual time.

    `pending_by_pool` is the queue backlog (submitted or re-queued, not yet
    claimed); `active_by_pool` counts workers ready to take traffic;
    `warming_by_pool` counts joiners still inside their warm-up window
    (capacity already paid for but not yet serving — a controller that
    ignores these will over-scale during its own warm-ups).
    """

    now: float
    pending_by_pool: Dict[Optional[str], int]
    #: task_id -> first-completion virtual timestamp.  A live reference to
    #: the engine's own accounting (no per-tick copy): read it during the
    #: tick, don't hold it across ticks expecting a snapshot.
    completion_times: Dict[str, float]
    #: the same completions as an append-only (completed_at, task_id) log,
    #: time-ordered because simulation time is monotonic — bisect it for
    #: "completed in the last window" queries instead of scanning the dict
    completion_log: List[Tuple[float, str]]
    active_by_pool: Dict[Optional[str], int]
    warming_by_pool: Dict[Optional[str], int]


class FleetController:
    """Scaling-decision loop living *inside* the DES (virtual-time only).

    The engine calls :meth:`tick` every `interval_s` of simulated time
    while the campaign runs; returned :class:`ElasticEvent`s are applied
    through the same join/leave machinery as a precomputed
    :class:`ElasticSchedule` — which is what makes controller-driven
    scaling exactly-once and byte-identical: a drained worker's in-flight
    task recovers via lease expiry / speculation, and completion stays
    idempotent in the queue.  This is the same architectural step fabric
    contention took earlier: the decision maker is a participant in the
    event loop, not a post-hoc analysis.
    """

    #: virtual seconds between ticks
    interval_s: float = 0.05

    def tick(self, now: float,
             view: FleetView) -> Optional[List[ElasticEvent]]:
        raise NotImplementedError


class _Flow:
    """One task's in-flight I/O phase: bytes draining at a fabric-granted
    rate, followed by a fixed tail (metadata round-trips + compute).

    ``bytes_left`` is lazily accounted: it is exact as of ``updated_at``
    and drains at ``rate`` since then, so a reallocation that does not
    change this flow's rate touches nothing — the flow's outstanding
    ``_IO_DONE`` prediction stays valid.  ``epoch`` is the engine-unique
    token stamped on that prediction (a fresh token per push, so a stale
    prediction can never collide with a later flow on the same worker);
    ``has_pred`` says whether a live prediction is in the heap (the
    lazy-deletion accounting behind heap compaction)."""

    __slots__ = ("task", "result", "error", "bytes_left", "demand",
                 "tail_s", "rate", "epoch", "updated_at", "has_pred",
                 "claim_epoch")

    def __init__(self, task, result, error, bytes_left: float,
                 demand: float, tail_s: float, now: float,
                 claim_epoch: int = 0):
        self.task = task
        self.result = result
        self.error = error
        self.bytes_left = bytes_left
        self.demand = demand
        self.tail_s = tail_s
        self.rate = 0.0
        self.epoch = 0
        self.updated_at = now
        self.has_pred = False
        #: the worker's _dispatch_epoch at claim time, carried into the
        #: task's _FINISH so a crash-restart (which bumps the epoch) kills
        #: the dead incarnation's completion instead of letting it land
        self.claim_epoch = claim_epoch


class Worker:
    """One simulated node: festivus mount + clock + counters.

    This object is the context handed to task handlers; a handler does its
    I/O through ``worker.fs`` / ``worker.chunkstore(root)`` so the engine
    can attribute bandwidth and time to the node that did the work.
    """

    def __init__(self, index: int, store: MountStore, fs: Festivus,
                 clock: perfmodel.WorkerClock, zone: int = 0,
                 meta: Optional[MountMeta] = None,
                 pool: Optional[str] = None):
        self.index = index
        self.name = f"node{index}"
        self.store = store
        self.fs = fs
        #: the node's busy time: advanced to each task's (virtual or wall)
        #: completion, never by idle polling — reported as virtual_time_s
        self.clock = clock
        #: fabric-zone membership; contention is water-filled per zone
        self.zone = zone
        #: per-worker view of the shared metadata KV (op counts + latency)
        self.meta = meta
        #: task-routing pool (ClusterConfig.worker_pools); None = shared
        self.pool = pool
        #: fabric-aware placement handle (ClusterConfig.placement); a
        #: handler writing fresh data consults it and routes its flows to
        #: the placed zone via :meth:`route_io`
        self.placement = None
        #: False once pre-empted by an ElasticSchedule leave event
        self.active = True
        #: virtual instants bounding this node's uptime: when it joined
        #: (0.0 for the initial fleet), when it may first claim (join +
        #: warm-up), and when it was pre-empted/drained (None = never) —
        #: the worker-seconds a $-proxy bills
        self.joined_t = 0.0
        self.ready_t = 0.0
        self.left_t: Optional[float] = None
        self.tasks_completed = 0
        self.tasks_failed = 0
        self.duplicate_completions = 0
        self._idle_backoff = 0.0
        #: bumped when an arrival wakes this worker, so the superseded
        #: backoff-poll chain event is dropped instead of forking a second
        #: poll chain (same stale-event pattern as _Flow.epoch)
        self._dispatch_epoch = 0
        #: True while counted in the engine's warming-by-pool view counter
        self._view_warming = False
        self._pending_compute_s = 0.0
        #: (link domain, extra tail s, $/GB) the current task's I/O rides
        self._pending_route: Optional[Tuple[Any, float, float]] = None
        #: the task id currently being executed (heartbeat chain target)
        self._current: Optional[str] = None
        #: True while a claimed task's FINISH is outstanding
        self._inflight = False
        #: back-reference to the owning engine (set by _make_worker) —
        #: what virtual_now()/pending_depth() read; None under unit tests
        #: that build a bare Worker
        self._engine = None
        self._chunkstores: Dict[str, ChunkStore] = {}

    def virtual_now(self) -> float:
        """Current simulation time (0.0 outside an engine / the DES) —
        what a deadline-aware handler compares against its arrival t."""
        eng = self._engine
        return eng._now if eng is not None else 0.0

    def pending_depth(self) -> int:
        """Queue backlog (submitted or re-queued, unclaimed) for this
        worker's pool right now — the signal a load-shedding handler
        compares against its brownout threshold.  0 outside a run."""
        eng = self._engine
        queue = getattr(eng, "_active_queue", None) if eng is not None else None
        if queue is None:
            return 0
        return queue.pending_by_pool().get(self.pool, 0)

    def chunkstore(self, root: str = "arrays") -> ChunkStore:
        cs = self._chunkstores.get(root)
        if cs is None:
            cs = self._chunkstores[root] = ChunkStore(self.fs, root)
        return cs

    def charge_compute(self, seconds: float) -> None:
        """Bill virtual per-task compute time (no-op in real-time mode)."""
        self._pending_compute_s += float(seconds)

    def route_io(self, domain, extra_tail_s: float = 0.0,
                 egress_usd_per_gb: float = 0.0) -> None:
        """Route this task's I/O over fabric link `domain` (a key
        registered via :attr:`ClusterConfig.fabric_links`) instead of the
        worker's home zone — the cross-region read path.  The transfer
        then water-fills against the link's fixed capacity, pays
        `extra_tail_s` once (the link RTT as first-byte tail), and bills
        `egress_usd_per_gb` on its drained bytes into the report's egress
        accounting.  Scoped to the current task; a task that drains no
        bytes (cache hit) pays nothing."""
        self._pending_route = (domain, float(extra_tail_s),
                               float(egress_usd_per_gb))

    def _drain_route(self) -> Optional[Tuple[Any, float, float]]:
        r, self._pending_route = self._pending_route, None
        return r

    def _drain_compute(self) -> float:
        s, self._pending_compute_s = self._pending_compute_s, 0.0
        return s


@dataclasses.dataclass
class ClusterConfig:
    #: simulated node count (thread count in real-time mode)
    nodes: int = 4
    #: vCPUs per node; sets the virtual-time NIC/CPU bandwidth cap
    vcpus: int = 16
    #: False: real threads + wall clock.  True: deterministic DES.
    virtual_time: bool = False
    store_model: perfmodel.ObjectStoreModel = perfmodel.FESTIVUS_STORE_MODEL
    #: per-mount festivus settings (None -> library defaults).  In virtual
    #: time, readahead is forced off: the DES models its effect analytically
    #: and async prefetch threads would break determinism.
    festivus: Optional[FestivusConfig] = None
    lease_s: float = 300.0
    #: virtual mode: renew a running task's lease this often (None = never;
    #: lets lease-expiry tests exercise re-dispatch)
    heartbeat_s: Optional[float] = None
    #: virtual seconds an idle worker waits before re-polling the queue
    idle_poll_s: float = 0.05
    #: idle polls back off exponentially up to this (bounds event count)
    max_idle_backoff_s: float = 3.2
    #: fixed virtual compute billed per task on top of handler charges
    compute_s_per_task: float = 0.0
    max_retries: int = 3
    speculation_factor: float = 3.0
    min_completions_for_speculation: int = 5
    #: real-time mode: idle sleep and bail-out budget
    poll_s: float = 0.001
    max_idle_polls: int = 2000
    #: virtual mode: zone-fabric contention model water-filled across all
    #: concurrently-reading mounts (None -> uncontended ideal fabric)
    fabric: Optional[perfmodel.FabricModel] = perfmodel.FABRIC_MODEL
    #: number of fabric zones; workers are assigned round-robin and each
    #: zone's capacity is shared only by its own readers
    zones: int = 1
    #: pool name -> fabric zone: pin every worker of a pool into one zone
    #: (a per-region pool living in its region's fabric) instead of the
    #: round-robin `index % zones` interleave.  Pools absent from the map
    #: — and all workers when None — keep the legacy assignment.
    pool_zones: Optional[Dict[str, int]] = None
    #: named fixed-capacity fabric domains (inter-region WAN links):
    #: {link key: capacity bytes/s}, registered on the SharedFabric so
    #: handlers can route cross-region reads via Worker.route_io
    fabric_links: Optional[Dict[Any, float]] = None
    #: virtual seconds charged per metadata-KV op (stat/dirent/manifest
    #: against the shared store) to the issuing worker's clock
    meta_op_latency_s: float = perfmodel.METADATA_OP_LATENCY_S
    #: virtual mode: join/leave timetable for an elastic fleet
    elastic: Optional[ElasticSchedule] = None
    #: virtual mode: a FleetController ticked every controller.interval_s
    #: of simulated time; its returned ElasticEvents extend the elastic
    #: schedule *mid-run, from inside the simulation* (SLO autoscaling)
    controller: Optional[FleetController] = None
    #: ordered (pool_name, count) worker partition, e.g. (("serve", 4),
    #: ("batch", 16)); counts must sum to `nodes`.  Workers claim only
    #: tasks routed to their pool (run()'s `pools` argument) — the mixed
    #: batch+interactive shape where both tiers still share one fabric.
    #: None = every worker in the default shared pool.
    worker_pools: Optional[Tuple[Tuple[str, int], ...]] = None
    #: virtual mode: ingest timed arrivals from a pre-sorted stream merged
    #: against the event heap (zero heap ops per request) and wake exactly
    #: one idle worker per submitted request off a per-pool idle min-heap,
    #: instead of one _ARRIVE heap event per request plus an O(idle)
    #: wake-all fan-out.  Claim outcomes are bit-identical (the lowest-
    #: index idle worker wins under both schemes — pinned by tests);
    #: False keeps the per-event path for twin comparisons.
    arrival_batching: bool = True
    #: called with the object path after any worker mount completes a PUT or
    #: DELETE (installed on every Festivus mount, including elastic joiners).
    #: This is the write-invalidation fan-out: a serve fleet hangs its tile
    #: cache invalidation bus here so chunk rewrites from an ingest pool
    #: evict derived tiles everywhere.
    mount_write_hook: Optional[Callable[[str], None]] = None
    #: pool name -> per-mount festivus override (two-level storage's
    #: pool-scoped admission policy): e.g. the serve pool mounts a local
    #: SSD tier (``ssd_bytes > 0``) while the ingest pool keeps the
    #: default single-level mount, so an ingest wave can neither fill nor
    #: churn the serve tier.  Pools absent from the map — and all workers
    #: when None — use :attr:`festivus`.  The same virtual-time
    #: adjustments (readahead off, inline fetch) apply to every entry.
    pool_festivus: Optional[Dict[Optional[str], FestivusConfig]] = None
    #: (pool, worker index) -> persistent :class:`SsdTier` handle.  When
    #: set, a worker whose resolved festivus config enables the tier
    #: attaches the registry's tier for its slot (creating it on first
    #: attach) instead of a mount-lifetime one — the local device that
    #: survives leases, remounts, and engine rebuilds.  The caller owns
    #: the registry (a plain dict) and carries it between campaigns.
    ssd_tier_registry: Optional[Dict[Tuple[Optional[str], int], SsdTier]] = None
    #: fabric-aware placement handle (e.g.
    #: :class:`repro.core.object_store.ZoneSpread`) exposed to handlers as
    #: ``worker.placement``: an ingest handler places freshly-written data
    #: across zones and routes its flows (Worker.route_io) to the placed
    #: zone instead of piling everything onto the worker's home zone.
    placement: Optional[Any] = None
    #: virtual mode: deterministic fault-injection script
    #: (:class:`repro.launch.chaos.ChaosSchedule`).  An *empty* schedule
    #: is the disabled twin: the chaos layer is registered but pushes no
    #: events, consults no oracle, and the run is bit-identical to
    #: ``chaos=None``.  With faults scheduled, recovery rides the
    #: machinery that already exists — lease expiry + speculation for
    #: crashes/hangs, incremental fabric reflow for outages, Festivus's
    #: budgeted retries/hedged reads for storms — and every fault fired
    #: is counted into :attr:`ClusterReport.chaos`.
    chaos: Optional[ChaosSchedule] = None


@dataclasses.dataclass
class WorkerReport:
    worker: str
    tasks_completed: int
    tasks_failed: int
    duplicate_completions: int
    virtual_time_s: float
    store_stats: StoreStats
    festivus_stats: FestivusStats
    #: ops this worker issued against the shared metadata KV
    meta_ops: int = 0
    #: fabric-zone membership
    zone: int = 0
    #: False if the worker was pre-empted mid-campaign (elastic leave)
    active: bool = True
    #: task-routing pool this worker claimed from (None = default shared)
    pool: Optional[str] = None
    #: uptime bounds (virtual): joined at `joined_t` (0.0 for the initial
    #: fleet), pre-empted/drained at `left_t` (None = up at campaign end).
    #: Uptime = (left_t or makespan) - joined_t — the $-proxy integrand.
    joined_t: float = 0.0
    left_t: Optional[float] = None
    #: op name -> transient store failures observed at this worker's mount
    #: (chaos storm rejections + FlakyObjectStore-style inner raises);
    #: empty on a fault-free run
    store_faults: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ClusterReport:
    """The gather side: fleet-wide reduction of a campaign run."""

    nodes: int
    tasks: int
    #: virtual makespan (DES) or wall seconds (threads)
    makespan_s: float
    bytes_read: int
    bytes_written: int
    store_stats: StoreStats
    festivus_stats: FestivusStats
    queue_stats: Dict[str, int]
    dead_tasks: List[str]
    results: Dict[str, Any]
    per_worker: List[WorkerReport]
    #: total metadata-KV ops issued by the fleet
    meta_ops: int = 0
    #: elastic-fleet accounting: workers added / pre-empted mid-campaign
    joined: int = 0
    left: int = 0
    #: task_id -> completion timestamp (virtual time under the DES; wall
    #: offsets in thread mode).  With run()'s `arrivals` this is what a
    #: serving tier turns into per-request latency.
    completion_times: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: cross-region reads' WAN egress: bytes routed over inter-region
    #: links (Worker.route_io) and their Table I dollar bill — folded
    #: into a serving sweep's egress-inclusive cost_usd
    egress_bytes: int = 0
    egress_usd: float = 0.0
    #: DES cost accounting (virtual-time runs only): wall_s (real seconds
    #: the event loop took), events (events processed), events_per_s,
    #: io_pushes (_IO_DONE predictions pushed), reflows (fabric
    #: water-filling passes), heap_peak (max event-heap length),
    #: stale_peak (max superseded predictions resident in the heap) and
    #: heap_compactions — the "how much did simulating this cost" figures
    #: the scaling benchmark reports per sweep point.
    simulator: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: fault-injection summary (runs with ClusterConfig.chaos set):
    #: scheduled event count, seed, and per-kind fired counts.  Empty when
    #: no chaos layer was registered.
    chaos: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def all_done(self) -> bool:
        return not self.dead_tasks and self.queue_stats["completed"] == self.tasks

    @property
    def read_bandwidth_bytes_per_s(self) -> float:
        return self.bytes_read / self.makespan_s if self.makespan_s > 0 else 0.0

    @property
    def aggregate_bytes_per_s(self) -> float:
        total = self.bytes_read + self.bytes_written
        return total / self.makespan_s if self.makespan_s > 0 else 0.0


#: task handler contract: (worker context, payload) -> result
Handler = Callable[[Worker, Any], Any]

(_DISPATCH, _FINISH, _HEARTBEAT, _IO_DONE, _JOIN, _LEAVE, _ARRIVE,
 _CONTROL, _CHAOS) = range(9)


class ClusterEngine:
    """Scatter a task dict over N simulated nodes; gather results + stats.

    One-shot: :meth:`run` closes the worker mounts when the campaign ends
    (bounding thread count at 512 simulated nodes); build a new engine per
    campaign.
    """

    def __init__(self, store: ObjectStore, meta: Optional[MetadataStore] = None,
                 config: Optional[ClusterConfig] = None):
        self.inner = store
        self.config = config or ClusterConfig()
        if self.config.elastic is not None and not self.config.virtual_time:
            raise ValueError("elastic fleets require virtual_time=True "
                             "(real-thread mode has no event loop to drive "
                             "join/leave)")
        if self.config.controller is not None and not self.config.virtual_time:
            raise ValueError("a FleetController requires virtual_time=True "
                             "(its ticks are simulation events)")
        if self.config.chaos is not None and not self.config.virtual_time:
            raise ValueError("chaos fault injection requires "
                             "virtual_time=True (faults are scheduled in "
                             "virtual time through the event loop)")
        #: engine-side chaos runtime: heap events + per-worker storm/stall
        #: windows + fired counts.  None when no chaos layer is registered.
        self._chaos = (ChaosRuntime.build(self.config.chaos)
                       if self.config.chaos is not None else None)
        #: the shared metadata KV — pass the caller's so its mounts see
        #: everything the fleet writes (and vice versa)
        self.meta = meta if meta is not None else MetadataStore()
        fest_cfg = self.config.festivus or FestivusConfig()

        def _adjust(cfg: FestivusConfig) -> FestivusConfig:
            if not self.config.virtual_time:
                return cfg
            # readahead pool threads would accrue service time asynchronously
            # across task boundaries, making the DES nondeterministic; its
            # latency-hiding effect is already modeled by water-filling the
            # drained service time over the mount's in-flight streams.
            # inline_fetch: the DES runs one handler at a time, so a
            # thread-pool round-trip per block fetch is pure overhead —
            # blocks are fetched synchronously (as zero-copy views) and the
            # whole simulation stays on one thread
            return dataclasses.replace(cfg, readahead_blocks=0,
                                       inline_fetch=True)

        self._fest_cfg = _adjust(fest_cfg)
        #: per-pool festivus overrides (pool-scoped SSD admission), with
        #: the same virtual-time adjustments as the shared default
        self._pool_fest_cfg = {
            pool: _adjust(cfg)
            for pool, cfg in (self.config.pool_festivus or {}).items()}
        self._store_model = (self.config.store_model
                             if self.config.virtual_time else None)
        self._meta_latency = (self.config.meta_op_latency_s
                              if self.config.virtual_time else 0.0)
        if self.config.worker_pools is not None:
            total = sum(n for _, n in self.config.worker_pools)
            if total != self.config.nodes:
                raise ValueError(
                    f"worker_pools counts sum to {total}, expected "
                    f"nodes={self.config.nodes}")
        self.workers: List[Worker] = []
        for i in range(self.config.nodes):
            self.workers.append(self._make_worker(i))
        self._now = 0.0
        self._inflight = max(1, min(fest_cfg.max_inflight,
                                    self.config.store_model.max_inflight_per_node))
        self._node_cap = perfmodel.node_cap_bytes_per_s(self.config.vcpus)
        self._joined = 0
        self._left = 0
        #: cross-region egress accounting (Worker.route_io drains)
        self._egress_bytes = 0
        self._egress_usd = 0.0
        #: DES cost diagnostics, filled by _run_virtual (empty under threads)
        self._sim: Dict[str, Any] = {}

    def _pool_of(self, index: int) -> Optional[str]:
        """Pool membership by worker index (elastic joiners beyond the
        configured partition land in the default shared pool)."""
        if self.config.worker_pools is None:
            return None
        hi = 0
        for name, count in self.config.worker_pools:
            hi += count
            if index < hi:
                return name
        return None

    def _make_worker(self, index: int,
                     pool_override: Optional[str] = None) -> Worker:
        """One node: private mount + metered KV view + clock (also the
        elastic-join path, so joiners get exactly the same plumbing).
        `pool_override` puts an elastic joiner into a named pool (an
        autoscaler growing the serve pool); None keeps positional
        assignment (joiners beyond the partition land in the default
        shared pool)."""
        pool = (pool_override if pool_override is not None
                else self._pool_of(index))
        chaos_inj = None
        stall_windows: Tuple = ()
        clock_fn: Optional[Callable[[], float]] = None
        if self._chaos is not None:
            # per-worker fault plumbing resolved once at mount creation:
            # a worker no storm/stall ever targets gets None/() and pays
            # nothing per op (the disabled-twin guarantee)
            chaos_inj = self._chaos.storm_injector(index)
            stall_windows = self._chaos.kv_stall_windows(index)
            clock_fn = lambda: self._now  # noqa: E731 — engine clock handle
        mount = MountStore(self.inner, model=self._store_model,
                           chaos=chaos_inj, clock=clock_fn)
        mmeta = MountMeta(self.meta, latency_s=self._meta_latency,
                          stall_windows=stall_windows, clock=clock_fn)
        fcfg = self._pool_fest_cfg.get(pool, self._fest_cfg)
        ssd_tier = None
        if self.config.ssd_tier_registry is not None and fcfg.ssd_bytes > 0:
            # the persistent local device for this slot: created on first
            # attach, re-attached (warm) by every later mount of the slot
            ssd_tier = self.config.ssd_tier_registry.get((pool, index))
            if ssd_tier is None:
                ssd_tier = SsdTier(fcfg.ssd_bytes)
                self.config.ssd_tier_registry[(pool, index)] = ssd_tier
        fs = Festivus(mount, meta=mmeta, config=fcfg, ssd_tier=ssd_tier)
        if self.config.mount_write_hook is not None:
            fs.write_hooks.append(self.config.mount_write_hook)
        zone = index % self.config.zones
        if self.config.pool_zones is not None and pool in self.config.pool_zones:
            zone = self.config.pool_zones[pool] % self.config.zones
        worker = Worker(index, mount, fs, perfmodel.WorkerClock(),
                        zone=zone, meta=mmeta, pool=pool)
        worker.placement = self.config.placement
        worker._engine = self
        return worker

    # -- public API -----------------------------------------------------------
    def run(self, tasks: Dict[str, Any], handler: Handler,
            arrivals: Optional[Dict[str, float]] = None,
            pools: Optional[Dict[str, str]] = None) -> ClusterReport:
        """Scatter `tasks`, gather a :class:`ClusterReport`.

        `arrivals` (virtual-time only) maps task ids to the virtual instant
        they become claimable — the request-shaped contract: a tile request
        arriving at t competes for workers and fabric from t on, and its
        latency is ``completion_times[id] - arrivals[id]`` (queueing
        included).  Tasks absent from `arrivals` are available at t=0.
        `pools` maps task ids to a worker-pool name (see
        :attr:`ClusterConfig.worker_pools`); absent ids go to the default
        shared pool.
        """
        arrivals = arrivals or {}
        pools = pools or {}
        if arrivals and not self.config.virtual_time:
            raise ValueError("timed arrivals require virtual_time=True "
                             "(real-thread mode has no event loop to hold "
                             "back a request)")
        for tid in list(arrivals) + list(pools):
            if tid not in tasks:
                raise ValueError(f"unknown task id {tid!r} in arrivals/pools")
        # every task must land in a pool some worker actually claims from,
        # else it sits unclaimable and the campaign never drains (a typo'd
        # pool name, or worker_pools partitioning away the default pool
        # while un-pooled tasks exist)
        worker_pools = {w.pool for w in self.workers}
        for tid in tasks:
            if pools.get(tid) not in worker_pools:
                raise ValueError(
                    f"task {tid!r} routed to pool {pools.get(tid)!r} but no "
                    f"worker claims from it (worker pools: "
                    f"{sorted(p if p is not None else '<default>' for p in worker_pools)})")
        queue = self._make_queue()
        #: the live queue, exposed so a handler can read its own pool's
        #: backlog (Worker.pending_depth — the load-shedding signal)
        self._active_queue = queue
        #: per-pool unfinished-task counts, maintained at completion — what
        #: lets a pool-targeted elastic leave refuse to strand live work
        self._unfinished_by_pool = {}
        for tid in tasks:
            p = pools.get(tid)
            self._unfinished_by_pool[p] = self._unfinished_by_pool.get(p, 0) + 1
        #: completion accounting maintained inline at _FINISH (virtual
        #: mode), so a controller tick reads it for free instead of
        #: rebuilding a dict over every DONE task per tick
        self._completions: Dict[str, float] = {}
        self._completion_log: List[Tuple[float, str]] = []
        deferred = []
        for task_id, payload in tasks.items():
            t = arrivals.get(task_id, 0.0)
            if t > 0.0:
                deferred.append((t, task_id, payload, pools.get(task_id)))
            else:
                queue.submit(task_id, payload,
                             max_retries=self.config.max_retries,
                             pool=pools.get(task_id))
        try:
            if self.config.virtual_time:
                t0 = time.perf_counter()
                makespan = self._run_virtual(queue, handler, deferred,
                                             ntasks=len(tasks))
                wall = time.perf_counter() - t0
                self._sim["wall_s"] = wall
                self._sim["events_per_s"] = (self._sim["events"] / wall
                                             if wall > 0 else 0.0)
            else:
                makespan = self._run_threads(queue, handler)
        finally:
            self.close()
        return self._report(queue, len(tasks), makespan)

    def close(self) -> None:
        for w in self.workers:
            w.fs.close()

    # -- shared plumbing ------------------------------------------------------
    def _make_queue(self) -> TaskQueue:
        clock = (lambda: self._now) if self.config.virtual_time else time.monotonic
        return TaskQueue(
            meta=self.meta, default_lease_s=self.config.lease_s,
            speculation_factor=self.config.speculation_factor,
            min_completions_for_speculation=self.config.min_completions_for_speculation,
            clock=clock)

    def _drain_task(self, worker: Worker) -> Tuple[float, int, float]:
        """Drain a task's accrued I/O, bytes, and fixed tail (KV + compute).

        Returns ``(io_s, nbytes, tail_s)``: `io_s` is the *uncontended*
        I/O duration — service time water-filled over the mount's in-flight
        streams, floored by the per-node NIC/CPU law — from which the flow's
        bandwidth demand is derived; `tail_s` is metadata-KV round-trips
        plus virtual compute, charged after the I/O phase.
        """
        service_s, nbytes = worker.store.drain_pending()
        io_s = 0.0
        if service_s:
            io_s = service_s / self._inflight
            if nbytes:
                io_s = max(io_s, nbytes / self._node_cap)
        # SSD-tier hits ride no fabric flow: their device read time bills
        # straight into the tail (exactly 0.0 with no tier mounted);
        # likewise retry backoff (exactly 0.0 when nothing retried)
        tail_s = (worker.meta.drain_pending() + worker._drain_compute()
                  + worker.fs.drain_ssd_pending()
                  + worker.fs.drain_retry_pending()
                  + self.config.compute_s_per_task)
        return io_s, nbytes, tail_s

    # -- real-time mode: N threads, wall clock --------------------------------
    def _run_threads(self, queue: TaskQueue, handler: Handler) -> float:
        t0 = time.monotonic()

        def loop(worker: Worker):
            idle = 0
            while idle < self.config.max_idle_polls:
                task = queue.claim(worker.name, lease_s=self.config.lease_s,
                                   pool=worker.pool)
                if task is None:
                    if queue.done():
                        return
                    idle += 1
                    time.sleep(self.config.poll_s)
                    continue
                idle = 0
                t_task = time.monotonic()
                error = result = None
                try:
                    result = handler(worker, task.payload)
                except Exception as e:  # noqa: BLE001 — a worker never dies
                    error = f"{type(e).__name__}: {e}"
                worker.clock.advance(time.monotonic() - t_task)
                if error is not None:
                    queue.fail(task.task_id, worker.name, error)
                    worker.tasks_failed += 1
                    continue
                if queue.complete(task.task_id, worker.name, result):
                    worker.tasks_completed += 1
                else:
                    worker.duplicate_completions += 1

        threads = [threading.Thread(target=loop, args=(w,), daemon=True)
                   for w in self.workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.monotonic() - t0

    def _promote_ready(self) -> None:
        """Move joiners whose warm-up elapsed from the warming to the
        active counter (lazily, off a ready-time heap): controller ticks
        read maintained per-pool counts instead of scanning the fleet."""
        heap = self._warming_heap
        while heap and heap[0][0] <= self._now:
            _, widx = heapq.heappop(heap)
            w = self.workers[widx]
            if w.active and w._view_warming:
                w._view_warming = False
                self._pool_warming[w.pool] -= 1
                self._pool_active[w.pool] = \
                    self._pool_active.get(w.pool, 0) + 1

    def _fleet_view(self, queue: TaskQueue) -> FleetView:
        """Snapshot the campaign for a FleetController tick (O(pools), not
        O(workers): the active/warming counts are event-maintained)."""
        self._promote_ready()
        return FleetView(
            now=self._now, pending_by_pool=queue.pending_by_pool(),
            completion_times=self._completions,
            completion_log=self._completion_log,
            active_by_pool={p: n for p, n in self._pool_active.items()
                            if n > 0},
            warming_by_pool={p: n for p, n in self._pool_warming.items()
                             if n > 0})

    # -- virtual-time mode: deterministic discrete-event simulation -----------
    def _run_virtual(self, queue: TaskQueue, handler: Handler,
                     deferred: Optional[List[Tuple]] = None,
                     ntasks: int = 0) -> float:
        """Global event loop: dispatch, fabric-contended I/O flows, elastic
        join/leave, timed request arrivals.

        The hot path is indexed so event cost stays O(log n), not
        O(workers) or O(flows):

        * The fabric is reallocated lazily *and incrementally*: membership
          changes mark only the affected zone dirty, one water-filling
          pass runs when simulated time is about to advance (a 512-node
          wave starting at the same instant costs one reallocation, not
          512), and :meth:`perfmodel.SharedFabric.reflow` reports exactly
          the flows whose granted rate changed — only those get their
          ``_IO_DONE`` prediction invalidated and re-pushed.  A flow's
          ``bytes_left`` is accounted lazily (exact as of its own
          ``updated_at``), so untouched flows are literally untouched.
        * Prediction tokens (``_Flow.epoch``) are engine-unique, so a
          superseded prediction can never collide with a later flow on the
          same worker.  Superseded predictions are counted and, past a
          bound, compacted out of the heap — heap size stays O(live flows
          + timers) no matter how churn-heavy the run.
        * Arrival wake-ups consult a per-pool idle-worker index instead of
          scanning the fleet; queue drain checks (``queue.done()``) are
          counter-based in :class:`TaskQueue`.
        * With :attr:`ClusterConfig.arrival_batching` (the default), timed
          arrivals never enter the heap at all: they are pre-sorted once
          into a stream carrying the same (t, seq) keys the per-event path
          would have stamped on its ``_ARRIVE`` entries, and the loop
          merges stream-vs-heap on that key — so ingestion order is
          bit-identical to the per-event path at zero heap ops per
          request.  Each submitted request wakes exactly one idle worker
          (the lowest-index one, popped from a per-pool idle min-heap
          with lazy deletion) instead of epoch-bumping every idle worker;
          the claim winner is the same worker under both schemes because
          same-instant wake-all dispatches pop in worker-index order.
        """
        heap: List = []
        seq = 0
        #: worker index -> in-flight _Flow (the fabric's current readers)
        flows: Dict[int, _Flow] = {}
        fabric = (perfmodel.SharedFabric(self.config.fabric,
                                         zones=self.config.zones)
                  if self.config.fabric is not None else None)
        if fabric is not None and self.config.fabric_links:
            for link, cap in self.config.fabric_links.items():
                fabric.add_link(link, cap)
        dirty = False
        pred_seq = 0     # engine-unique _IO_DONE tokens (never reused)
        stale_io = 0     # superseded predictions still resident in the heap
        io_pushes = 0
        reflows = 0
        heap_peak = 0
        stale_peak = 0
        compactions = 0
        #: per-pool index of idle workers (active, past warm-up, polling an
        #: empty queue) — what an arrival wake-up touches instead of
        #: scanning self.workers
        self._idle_by_pool: Dict[Optional[str], set] = {}
        #: per-pool min-heap of possibly-idle worker indices (lazy
        #: deletion: the set above is the truth; stale entries are skipped
        #: on pop) — lets a batched arrival wake the lowest-index idle
        #: worker in O(log idle) instead of sorting the whole idle set
        self._idle_heap: Dict[Optional[str], List[int]] = {}
        #: per-pool active/warming counters for FleetView (plus the
        #: ready-time heap that promotes warming -> active lazily)
        self._pool_active: Dict[Optional[str], int] = {}
        self._pool_warming: Dict[Optional[str], int] = {}
        self._warming_heap: List[Tuple[float, int]] = []
        for w in self.workers:
            self._pool_active[w.pool] = self._pool_active.get(w.pool, 0) + 1

        def push(t: float, kind: int, widx: int, data=None):
            nonlocal seq, heap_peak
            seq += 1
            heapq.heappush(heap, (t, seq, kind, widx, data))
            if len(heap) > heap_peak:
                heap_peak = len(heap)

        def reallocate():
            """Incremental water-filling: reflow only the dirty zones and
            re-predict I/O completion only for flows whose rate changed."""
            nonlocal dirty, pred_seq, stale_io, io_pushes, reflows, stale_peak
            reflows += 1
            for widx, rate in fabric.reflow().items():
                fl = flows[widx]
                dt = self._now - fl.updated_at
                if dt > 0:
                    fl.bytes_left = max(0.0, fl.bytes_left - fl.rate * dt)
                fl.updated_at = self._now
                fl.rate = rate
                if fl.has_pred:
                    stale_io += 1  # the outstanding prediction just died
                    if stale_io > stale_peak:
                        stale_peak = stale_io
                pred_seq += 1
                fl.epoch = pred_seq
                if rate > 0:
                    push(self._now + fl.bytes_left / rate, _IO_DONE,
                         widx, fl.epoch)
                    io_pushes += 1
                    fl.has_pred = True
                else:
                    fl.has_pred = False
            dirty = False

        def compact():
            """Drop superseded _IO_DONE entries once they outnumber the
            live event population (lazy deletion with a bound: the fix for
            the stale-prediction heap leak)."""
            nonlocal stale_io, compactions

            def live(e):
                if e[2] != _IO_DONE:
                    return True
                fl = flows.get(e[3])
                return fl is not None and fl.epoch == e[4]

            heap[:] = [e for e in heap if live(e)]
            heapq.heapify(heap)
            stale_io = 0
            compactions += 1

        for ev in (self.config.elastic.events if self.config.elastic else ()):
            push(ev.t, _JOIN if ev.delta > 0 else _LEAVE, -1, ev)
        # instant faults (crash / hang / ssd / capacity set+restore) enter
        # the heap; storms and KV stalls are static mount-level windows
        # that cost nothing here.  An empty schedule pushes nothing and
        # consumes no seq — the disabled twin stays bit-identical.
        if self._chaos is not None:
            for t, tag in self._chaos.heap_events:
                push(t, _CHAOS, -1, tag)
        controller = self.config.controller
        if controller is not None:
            push(controller.interval_s, _CONTROL, -1)
        #: requests not yet arrived: workers must not retire while these are
        #: pending even though the queue looks drained
        pending_arrivals = len(deferred or ())
        #: batched ingestion: arrivals live in a sorted stream, not the
        #: heap.  Each consumes a seq *as if* it had been pushed (so every
        #: later heap entry gets the same seq as on the per-event path)
        #: and the stream is stable-sorted on the exact (t, seq) key the
        #: heap would have ordered it by — merge order is bit-identical.
        arrival_stream: List[Tuple[float, int, Tuple]] = []
        if self.config.arrival_batching:
            for t, task_id, payload, pool in (deferred or ()):
                seq += 1
                arrival_stream.append((t, seq, (task_id, payload, pool)))
            arrival_stream.sort(key=lambda e: (e[0], e[1]))
        else:
            for t, task_id, payload, pool in (deferred or ()):
                push(t, _ARRIVE, -1, (task_id, payload, pool))
        arr_ix = 0
        n_arr = len(arrival_stream)
        for w in self.workers:
            push(0.0, _DISPATCH, w.index)
        busy = 0
        makespan = 0.0
        events = 0
        #: runaway guard scaled to the campaign (a million-request trace
        #: legitimately needs tens of millions of events; the guard exists
        #: to catch infinite poll loops, not honest scale)
        event_limit = max(2_000_000,
                          30 * ntasks + 400 * len(self.workers))
        while heap or dirty or arr_ix < n_arr:
            if arr_ix < n_arr:
                a_t, a_seq, _ = arrival_stream[arr_ix]
                take_arrival = (not heap
                                or (a_t, a_seq) < (heap[0][0], heap[0][1]))
                next_t = a_t if take_arrival else heap[0][0]
            else:
                take_arrival = False
                next_t = heap[0][0] if heap else None
            if dirty and (next_t is None or next_t > self._now):
                reallocate()
                continue
            if stale_io > 64 and stale_io > len(flows) + len(self.workers):
                compact()
            events += 1
            if events > event_limit:
                raise RuntimeError(
                    "cluster DES runaway — check task/handler wiring (an "
                    "abandoned task with a huge lease and speculation "
                    "disabled polls forever)")

            if take_arrival:
                t, _, (task_id, payload, pool) = arrival_stream[arr_ix]
                arr_ix += 1
                self._now = max(self._now, t)
                queue.submit(task_id, payload,
                             max_retries=self.config.max_retries, pool=pool)
                pending_arrivals -= 1
                # wake exactly one idle worker — the lowest-index one, the
                # same worker that wins the claim race under the per-event
                # wake-all (same-instant dispatches pop in index order).
                # Removing it from the idle set here is what dedupes
                # wake-ups across a same-instant batch: the next arrival
                # wakes the *next* idle worker, never this one twice.
                idle = self._idle_by_pool.get(pool)
                if idle:
                    iheap = self._idle_heap[pool]
                    while iheap:
                        w_idx = heapq.heappop(iheap)
                        if w_idx in idle:  # lazy deletion: skip stale
                            idle.discard(w_idx)
                            w = self.workers[w_idx]
                            w._idle_backoff = 0.0
                            w._dispatch_epoch += 1  # supersede backoff poll
                            push(self._now, _DISPATCH, w_idx,
                                 w._dispatch_epoch)
                            break
                continue

            t, _, kind, widx, data = heapq.heappop(heap)
            self._now = max(self._now, t)

            if kind == _ARRIVE:
                task_id, payload, pool = data
                queue.submit(task_id, payload,
                             max_retries=self.config.max_retries, pool=pool)
                pending_arrivals -= 1
                # wake idle workers of this pool (the request-socket model:
                # a server parked on an empty queue reacts immediately, not
                # after its exponential idle backoff elapses).  The idle
                # index holds only active, post-warm-up workers — a warming
                # joiner is not in it yet (its first dispatch fires at
                # ready_t), so autoscaler-added capacity still cannot take
                # traffic before its warm-up ends.  sorted(): worker-index
                # order, as the fleet scan this replaces produced.
                idle = self._idle_by_pool.get(pool)
                if idle:
                    for w_idx in sorted(idle):
                        w = self.workers[w_idx]
                        w._idle_backoff = 0.0
                        w._dispatch_epoch += 1  # supersede the backoff poll
                        push(self._now, _DISPATCH, w_idx, w._dispatch_epoch)
                continue

            if kind == _CONTROL:
                # ordered cheapest-first: pending_arrivals/busy are plain
                # counters (and queue.done() is itself counter-based now)
                if pending_arrivals == 0 and busy == 0 and queue.done():
                    continue  # campaign drained: let the tick chain die
                for ev in (controller.tick(self._now,
                                           self._fleet_view(queue)) or ()):
                    push(max(ev.t, self._now),
                         _JOIN if ev.delta > 0 else _LEAVE, -1, ev)
                push(self._now + controller.interval_s, _CONTROL, -1)
                continue

            if kind == _JOIN:
                ev = data
                for _ in range(ev.delta):
                    w = self._make_worker(len(self.workers),
                                          pool_override=ev.pool)
                    w.joined_t = self._now
                    w.ready_t = self._now + ev.warmup_s
                    self.workers.append(w)
                    self._joined += 1
                    if self._now < w.ready_t:
                        w._view_warming = True
                        self._pool_warming[w.pool] = \
                            self._pool_warming.get(w.pool, 0) + 1
                        heapq.heappush(self._warming_heap,
                                       (w.ready_t, w.index))
                    else:
                        self._pool_active[w.pool] = \
                            self._pool_active.get(w.pool, 0) + 1
                    push(w.ready_t, _DISPATCH, w.index)
                continue

            if kind == _LEAVE:
                ev = data
                self._promote_ready()  # settle warming/active at this instant
                candidates = [w for w in self.workers if w.active
                              and (ev.pool is None or w.pool == ev.pool)]
                if ev.prefer_idle:
                    # planned drain: idle victims first (list tail is taken),
                    # busy ones only if the drain outnumbers the idle —
                    # recovery of a busy victim's task still rides the
                    # lease-expiry / speculation safety net
                    candidates = ([w for w in candidates if w._inflight]
                                  + [w for w in candidates if not w._inflight])
                victims = candidates[ev.delta:]  # delta < 0: the list tail
                # a pool-*targeted* drain must not strand that pool's live
                # tasks with no claimant (a controller bug would otherwise
                # surface as an opaque event-loop runaway); fleet-wide
                # leaves keep the legacy contract (drain all, rejoin later)
                if (ev.pool is not None and candidates
                        and len(victims) == len(candidates)):
                    # _unfinished_by_pool is decremented on completion
                    # only, so discount DEAD tasks here (lazily — this
                    # branch is a rare drain-to-zero, not the hot path):
                    # a dead-lettered task needs no worker, and a leave
                    # on its account would abort a valid simulation
                    unfinished = (self._unfinished_by_pool.get(ev.pool, 0)
                                  - sum(1 for t in queue.dead_tasks()
                                        if t.pool == ev.pool))
                    if unfinished > 0:
                        raise RuntimeError(
                            f"elastic leave {ev} would remove every active "
                            f"'{ev.pool}' worker while {unfinished} of its "
                            f"tasks are unfinished — keep min_servers >= 1")
                for w in victims:
                    w.active = False
                    w.left_t = self._now
                    self._left += 1
                    if w._view_warming:
                        w._view_warming = False
                        self._pool_warming[w.pool] -= 1
                    else:
                        self._pool_active[w.pool] -= 1
                    idle = self._idle_by_pool.get(w.pool)
                    if idle:
                        idle.discard(w.index)
                    fl = flows.pop(w.index, None)
                    if fl is not None:
                        fabric.remove_flow(w.index)
                        dirty = True
                        if fl.has_pred:
                            stale_io += 1  # its prediction is now orphaned
                            if stale_io > stale_peak:
                                stale_peak = stale_io
                    if w._inflight:
                        # vanish without fail(): the claimed task stays
                        # RUNNING until its lease expires or a surviving
                        # worker speculates it — the pre-emption contract
                        busy -= 1
                        w._inflight = False
                        w._current = None
                continue

            if kind == _CHAOS:
                rt = self._chaos
                tag = data[0]
                if tag == "capacity":
                    # zone outage / link brownout window edge: rescale the
                    # domain's capacity through the incremental reflow
                    # path (restore events re-scale to 1.0)
                    _, domain, scale = data
                    if fabric is not None:
                        fabric.set_capacity_scale(domain, scale)
                        dirty = True
                        if scale != 1.0:  # count window opens, not closes
                            rt.count("zone_outage" if isinstance(domain, int)
                                     else "link_brownout")
                elif tag == "crash":
                    ev = data[1]
                    if ev.worker < len(self.workers):
                        w = self.workers[ev.worker]
                        if w.active:
                            rt.count("crash")
                            # the process dies: its claim vanishes without
                            # fail() (same contract as pre-emption — lease
                            # expiry / speculation recovers the task), its
                            # flow leaves the fabric, and a restart is the
                            # only thing scheduled
                            fl = flows.pop(w.index, None)
                            if fl is not None:
                                fabric.remove_flow(w.index)
                                dirty = True
                                if fl.has_pred:
                                    stale_io += 1
                                    if stale_io > stale_peak:
                                        stale_peak = stale_io
                            if w._inflight:
                                busy -= 1
                                w._inflight = False
                                w._current = None
                            idle = self._idle_by_pool.get(w.pool)
                            if idle:
                                idle.discard(w.index)
                            rt.hung_until.pop(ev.worker, None)  # fresh process
                            if self._now >= w.ready_t:
                                # epoch bump kills the dead incarnation's
                                # in-heap FINISH/poll events; the restart
                                # dispatch starts a fresh chain.  A crash
                                # during warm-up schedules nothing — the
                                # join's first dispatch at ready_t stands.
                                w._dispatch_epoch += 1
                                w._idle_backoff = 0.0
                                push(self._now + ev.restart_s, _DISPATCH,
                                     w.index, w._dispatch_epoch)
                elif tag == "hang":
                    ev = data[1]
                    if (ev.worker < len(self.workers)
                            and self.workers[ev.worker].active):
                        rt.count("hang")
                        until = self._now + ev.duration_s
                        rt.hung_until[ev.worker] = max(
                            rt.hung_until.get(ev.worker, 0.0), until)
                elif tag == "ssd":
                    ev = data[1]
                    if ev.worker < len(self.workers):
                        w = self.workers[ev.worker]
                        if w.fs.drop_ssd_tier():
                            rt.count("ssd_failure")
                        reg = self.config.ssd_tier_registry
                        if reg is not None:
                            # the device is gone for good: a later remount
                            # of this slot gets a cold replacement, not
                            # the dead device's contents
                            reg.pop((w.pool, w.index), None)
                continue

            worker = self.workers[widx]

            if kind == _HEARTBEAT:
                # the chain re-arms itself while the worker is still on the
                # same task; it goes quiet on completion or pre-emption.
                # A hung worker's beats are *suppressed* (the chain stays
                # armed but the lease stops renewing — exactly how a stall
                # looks from the queue's side, letting the lease expire
                # under the zombie while it still "holds" the task).
                if worker.active and worker._current == data:
                    hung = (self._chaos.hung_until.get(widx)
                            if self._chaos is not None else None)
                    if hung is None or self._now >= hung:
                        queue.heartbeat(data, worker.name)
                    push(self._now + self.config.heartbeat_s, _HEARTBEAT,
                         widx, data)
                continue

            if kind == _IO_DONE:
                fl = flows.get(widx)
                if fl is None or fl.epoch != data:
                    stale_io -= 1  # a superseded prediction left the heap
                    continue
                flows.pop(widx)
                fabric.remove_flow(widx)
                dirty = True  # departing reader frees bandwidth for the rest
                push(self._now + fl.tail_s, _FINISH, widx,
                     (fl.task, fl.result, fl.error, fl.claim_epoch))
                continue

            if kind == _FINISH:
                if not worker.active or not worker._inflight:
                    continue  # pre-empted after this was scheduled
                task, result, error, cep = data
                if cep != worker._dispatch_epoch:
                    continue  # claim predates a crash-restart: the dead
                    # incarnation's completion must not land (the task
                    # re-runs via lease expiry / speculation)
                if self._chaos is not None:
                    hung = self._chaos.hung_until.get(widx)
                    if hung is not None and self._now < hung:
                        # the zombie path: completion is *deferred*, not
                        # dropped — it fires at hang end and goes through
                        # first-wins arbitration, so a speculative copy
                        # that finished meanwhile turns this into a
                        # duplicate_completion, never a double count
                        push(hung, _FINISH, widx, data)
                        continue
                busy -= 1
                worker._inflight = False
                worker._current = None
                if error is not None:
                    queue.fail(task.task_id, worker.name, error)
                    worker.tasks_failed += 1
                elif queue.complete(task.task_id, worker.name, result):
                    worker.tasks_completed += 1
                    self._unfinished_by_pool[task.pool] -= 1
                    self._completions[task.task_id] = self._now
                    self._completion_log.append((self._now, task.task_id))
                else:
                    worker.duplicate_completions += 1
                worker.clock.advance_to(self._now)  # busy until this finish
                makespan = max(makespan, self._now)
                worker._idle_backoff = 0.0
                push(self._now, _DISPATCH, worker.index)
                continue

            # _DISPATCH: try to claim; retire when the campaign is over
            if not worker.active:
                continue
            if data is not None and data != worker._dispatch_epoch:
                continue  # poll superseded by an arrival wake-up
            if self._chaos is not None:
                hung = self._chaos.hung_until.get(widx)
                if hung is not None and self._now < hung:
                    push(hung, _DISPATCH, widx, data)  # stalled: poll later
                    continue
            task = queue.claim(worker.name, lease_s=self.config.lease_s,
                               pool=worker.pool)
            if task is None:
                idle = self._idle_by_pool.setdefault(worker.pool, set())
                if queue.done() and busy == 0 and pending_arrivals == 0:
                    idle.discard(widx)
                    continue  # retire this worker (no reschedule)
                if widx not in idle:
                    idle.add(widx)  # an arrival can short-circuit the backoff
                    heapq.heappush(
                        self._idle_heap.setdefault(worker.pool, []), widx)
                worker._idle_backoff = min(
                    max(worker._idle_backoff * 2, self.config.idle_poll_s),
                    self.config.max_idle_backoff_s)
                push(self._now + worker._idle_backoff, _DISPATCH, worker.index,
                     worker._dispatch_epoch)
                continue
            idle = self._idle_by_pool.get(worker.pool)
            if idle:
                idle.discard(widx)
            worker._idle_backoff = 0.0
            worker._current = task.task_id
            worker._inflight = True
            claim_epoch = worker._dispatch_epoch
            busy += 1
            result = error = None
            try:
                result = handler(worker, task.payload)
            except Exception as e:  # noqa: BLE001 — a worker never dies
                error = f"{type(e).__name__}: {e}"
            io_s, nbytes, tail_s = self._drain_task(worker)
            route = worker._drain_route()
            domain = worker.zone
            if route is not None and nbytes > 0:
                # cross-region read: the transfer contends on the named
                # WAN link instead of the home zone, pays the link RTT
                # once as first-byte tail, and bills egress on its bytes.
                # A routed task that drained no bytes (cache hit) pays
                # nothing — route dropped above.
                domain, extra_tail_s, usd_per_gb = route
                tail_s += extra_tail_s
                self._egress_bytes += nbytes
                self._egress_usd += usd_per_gb * (nbytes / 1e9)
            if self.config.heartbeat_s:
                push(self._now + self.config.heartbeat_s, _HEARTBEAT,
                     widx, task.task_id)
            if fabric is not None and nbytes > 0 and io_s > 0:
                fl = _Flow(task, result, error, bytes_left=float(nbytes),
                           demand=nbytes / io_s, tail_s=tail_s,
                           now=self._now, claim_epoch=claim_epoch)
                flows[widx] = fl
                fabric.add_flow(widx, domain, fl.demand)
                dirty = True
            else:
                push(self._now + io_s + tail_s, _FINISH, widx,
                     (task, result, error, claim_epoch))
        self._sim = {
            "events": events, "io_pushes": io_pushes, "reflows": reflows,
            "heap_peak": heap_peak, "stale_peak": stale_peak,
            "heap_compactions": compactions,
        }
        return makespan

    # -- gather ----------------------------------------------------------------
    def _report(self, queue: TaskQueue, ntasks: int,
                makespan: float) -> ClusterReport:
        per_worker = [
            WorkerReport(worker=w.name,
                         tasks_completed=w.tasks_completed,
                         tasks_failed=w.tasks_failed,
                         duplicate_completions=w.duplicate_completions,
                         virtual_time_s=w.clock.now(),
                         store_stats=w.store.stats.snapshot(),
                         festivus_stats=dataclasses.replace(w.fs.stats),
                         meta_ops=w.meta.ops if w.meta is not None else 0,
                         zone=w.zone, active=w.active, pool=w.pool,
                         joined_t=w.joined_t, left_t=w.left_t,
                         store_faults=dict(w.store.fault_counts))
            for w in self.workers
        ]
        store_stats = StoreStats.merge(r.store_stats for r in per_worker)
        festivus_stats = FestivusStats.merge(r.festivus_stats for r in per_worker)
        return ClusterReport(
            nodes=self.config.nodes, tasks=ntasks, makespan_s=makespan,
            bytes_read=store_stats.bytes_read,
            bytes_written=store_stats.bytes_written,
            store_stats=store_stats, festivus_stats=festivus_stats,
            queue_stats=dict(queue.stats),
            dead_tasks=[t.task_id for t in queue.dead_tasks()],
            results=queue.results(), per_worker=per_worker,
            meta_ops=sum(r.meta_ops for r in per_worker),
            joined=self._joined, left=self._left,
            egress_bytes=self._egress_bytes, egress_usd=self._egress_usd,
            completion_times=queue.completion_times(),
            simulator=dict(self._sim),
            chaos=(self._chaos.snapshot() if self._chaos is not None
                   else {}))


def scatter_gather(store: ObjectStore, tasks: Dict[str, Any], handler: Handler,
                   *, meta: Optional[MetadataStore] = None,
                   config: Optional[ClusterConfig] = None) -> ClusterReport:
    """One-shot convenience: build an engine, run the campaign, report."""
    return ClusterEngine(store, meta=meta, config=config).run(tasks, handler)


def campaign_config(num_workers: Optional[int] = None,
                    engine_config: Optional[ClusterConfig] = None,
                    default_nodes: int = 4) -> ClusterConfig:
    """Resolve the shared campaign-API contract: callers pass either a node
    count or a full :class:`ClusterConfig` (passing both inconsistently
    raises) — used by every §V campaign entry point."""
    if engine_config is None:
        return ClusterConfig(nodes=num_workers if num_workers else default_nodes)
    if num_workers is not None and num_workers != engine_config.nodes:
        raise ValueError(
            f"num_workers={num_workers} conflicts with "
            f"engine_config.nodes={engine_config.nodes}; pass only one")
    return engine_config
