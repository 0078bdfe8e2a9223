"""Deterministic fault injection for the virtual-time cluster engine.

The paper's premise is that commodity cloud parts — pre-emptible VMs, an
object store that throttles, a shared WAN fabric — compose into an
HPC-class system *because* the software above them absorbs their failure
modes.  This module generates those failure modes on demand, scheduled in
**virtual time** through the existing discrete-event engine, so a fault
campaign is as reproducible as a happy-path one: same schedule + same
seed => bit-identical `ClusterReport`.

Fault taxonomy (one `FaultEvent.kind` each):

``crash``
    The worker process dies mid-task and restarts after ``restart_s``.
    Its claim vanishes without a ``fail`` — recovery is the queue's lease
    expiry + straggler speculation, exactly the pre-emption path the
    engine already models for elastic scale-in, except the node comes
    back.
``hang``
    The worker stalls for ``duration_s``: heartbeats stop (the lease can
    expire under it) and any in-flight completion is deferred until the
    hang ends — the classic zombie, whose late ``complete`` must lose
    first-wins arbitration if a speculative copy finished meanwhile.
``zone_outage`` / ``link_brownout``
    ``SharedFabric.set_capacity_scale(domain, scale)`` for the window —
    flows through the domain re-converge at the scaled capacity via the
    incremental reflow path, and restore when the window closes.  Scale
    must be in (0, 1]: model a hard outage as a deep brownout (e.g.
    0.01) so in-flight transfers keep a finite completion prediction.
``throttle_storm``
    Seeded, time-windowed `TransientStoreError` bursts injected at the
    worker's store mount (per-mount and windowed, unlike the wall-clock
    Bernoulli `FlakyObjectStore` test shim).  Recovery is Festivus's
    budgeted retry loop / hedged reads, whose backoff bills virtual time.
``ssd_failure``
    The worker's local-SSD cache device dies: the tier is detached from
    its mount and the shared registry, so reads fall through to the
    store.  No recovery needed — the tier is a cache.
``kv_stall``
    The metadata KV serves every op with ``extra_latency_s`` added
    during the window (a hot-shard / compaction stall).

Everything here is plain data + pure functions; the engine owns the
event loop.  `ChaosRuntime` is the engine-side runtime state: heap
events to push at start-up, per-worker storm/stall windows handed to
mounts at construction, hang bookkeeping, and fault counters that land
in ``ClusterReport.chaos``.
"""

from __future__ import annotations

import dataclasses
import random
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FAULT_KINDS",
    "FaultEvent",
    "ChaosSchedule",
    "ChaosRuntime",
    "StoreStormInjector",
]

FAULT_KINDS = (
    "crash",
    "hang",
    "zone_outage",
    "link_brownout",
    "throttle_storm",
    "ssd_failure",
    "kv_stall",
)

#: kinds that target one worker (``worker`` required, ``domain`` unused)
_WORKER_KINDS = ("crash", "hang", "throttle_storm", "ssd_failure")
#: kinds that target a fabric domain (``domain`` required)
_DOMAIN_KINDS = ("zone_outage", "link_brownout")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``t`` is virtual seconds from run start.

    Field use by kind:

    - ``crash``: worker, restart_s
    - ``hang``: worker, duration_s
    - ``zone_outage`` / ``link_brownout``: domain (int zone or link
      name), duration_s, scale in (0, 1]
    - ``throttle_storm``: worker (or None for fleet-wide), duration_s,
      fail_rate in [0, 1]
    - ``ssd_failure``: worker
    - ``kv_stall``: worker (or None for fleet-wide), duration_s,
      extra_latency_s
    """

    t: float
    kind: str
    worker: Optional[int] = None
    domain: Any = None
    duration_s: float = 0.0
    restart_s: float = 1.0
    scale: float = 0.01
    fail_rate: float = 0.5
    extra_latency_s: float = 0.0

    def __post_init__(self):
        if self.t < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}")
        if self.kind in _DOMAIN_KINDS:
            if self.domain is None:
                raise ValueError(f"{self.kind} requires a fabric domain")
            if not 0.0 < self.scale <= 1.0:
                raise ValueError(
                    f"capacity scale must be in (0, 1], got {self.scale} "
                    "(model a hard outage as a deep brownout, e.g. 0.01)")
        elif self.kind in ("crash", "hang", "ssd_failure"):
            if self.worker is None:
                raise ValueError(f"{self.kind} requires a worker index")
        if self.kind in ("hang", "zone_outage", "link_brownout",
                         "throttle_storm", "kv_stall"):
            if self.duration_s <= 0.0:
                raise ValueError(
                    f"{self.kind} requires duration_s > 0, "
                    f"got {self.duration_s}")
        if self.kind == "crash" and self.restart_s < 0.0:
            raise ValueError(
                f"restart_s must be >= 0, got {self.restart_s}")
        if self.kind == "throttle_storm" and not 0.0 <= self.fail_rate <= 1.0:
            raise ValueError(
                f"fail_rate must be in [0, 1], got {self.fail_rate}")
        if self.kind == "kv_stall" and self.extra_latency_s <= 0.0:
            raise ValueError(
                f"kv_stall requires extra_latency_s > 0, "
                f"got {self.extra_latency_s}")


@dataclass(frozen=True)
class ChaosSchedule:
    """A deterministic fault script: events sorted by time, plus the seed
    that drives every stochastic choice inside storm windows.  An empty
    schedule is legal — registering it must leave the engine bit-identical
    to running with no chaos at all (the "disabled twin" guarantee)."""

    events: Tuple[FaultEvent, ...] = ()
    seed: int = 0

    def __init__(self, events: Sequence[FaultEvent] = (), seed: int = 0):
        object.__setattr__(self, "events",
                           tuple(sorted(events, key=lambda e: e.t)))
        object.__setattr__(self, "seed", int(seed))

    def __bool__(self) -> bool:
        return bool(self.events)

    def for_worker(self, index: int, kinds: Tuple[str, ...]):
        """Events of the given kinds targeting worker ``index`` (or
        fleet-wide, ``worker=None``, for kinds that allow it)."""
        return [e for e in self.events
                if e.kind in kinds and e.worker in (index, None)]

    @staticmethod
    def storm(*, t: float, duration_s: float, fail_rate: float = 0.5,
              workers: Optional[Sequence[int]] = None,
              seed: int = 0) -> "ChaosSchedule":
        """Convenience: one fleet-wide (or per-worker-list) throttle storm."""
        targets: List[Optional[int]] = (
            list(workers) if workers is not None else [None])
        return ChaosSchedule(
            [FaultEvent(t=t, kind="throttle_storm", worker=w,
                        duration_s=duration_s, fail_rate=fail_rate)
             for w in targets], seed=seed)


class StoreStormInjector:
    """Per-mount throttle-storm oracle.

    Owned by one worker's `MountStore`; consulted before every store op.
    Inside a storm window each op fails with ``fail_rate`` probability,
    drawn from a private RNG seeded by ``(schedule seed, worker index)``
    with an arithmetic mix — never Python `hash()`, which is
    process-randomized.  Determinism: the mount calls `roll()` in op
    order, and under the DES op order is a pure function of the event
    schedule, so the same seed reproduces the same failure pattern.
    """

    __slots__ = ("windows", "_rng", "_active_rate")

    def __init__(self, windows: Sequence[Tuple[float, float, float]],
                 seed: int, worker_index: int):
        #: (start, end, fail_rate) triples, in schedule order
        self.windows = tuple(windows)
        self._rng = random.Random(seed * 1000003 + worker_index)
        self._active_rate: Optional[float] = None

    def roll(self, now: float) -> bool:
        """True => this op fails with a `TransientStoreError`."""
        rate = None
        for start, end, fail_rate in self.windows:
            if start <= now < end:
                rate = fail_rate
                break
        if rate is None:
            return False
        return self._rng.random() < rate


@dataclass
class ChaosRuntime:
    """Engine-side chaos state, built once per `ClusterEngine` from a
    `ChaosSchedule`.  The engine pushes ``heap_events`` into its event
    heap at start-up and dispatches them through the ``_CHAOS`` kind;
    storms and KV stalls are *static windows* configured at mount
    creation instead (no heap traffic), so their cost is zero when no
    window covers the current time."""

    schedule: ChaosSchedule
    #: (t, tag_tuple) pairs for the engine heap, in schedule order.
    heap_events: List[Tuple[float, Tuple]] = field(default_factory=list)
    #: worker index -> virtual time its current hang ends (absent = not hung)
    hung_until: Dict[int, float] = field(default_factory=dict)
    #: fault kind -> number of times it fired (lands in report.chaos)
    counts: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def build(cls, schedule: ChaosSchedule) -> "ChaosRuntime":
        rt = cls(schedule=schedule)
        for ev in schedule.events:
            if ev.kind == "crash":
                rt.heap_events.append((ev.t, ("crash", ev)))
            elif ev.kind == "hang":
                rt.heap_events.append((ev.t, ("hang", ev)))
            elif ev.kind == "ssd_failure":
                rt.heap_events.append((ev.t, ("ssd", ev)))
            elif ev.kind in _DOMAIN_KINDS:
                # A set/restore pair: the restore always re-scales to 1.0
                # (clears the entry), so overlapping windows on one
                # domain end with the *last* close, which is the
                # documented semantics for stacked brownouts.
                rt.heap_events.append(
                    (ev.t, ("capacity", ev.domain, ev.scale)))
                rt.heap_events.append(
                    (ev.t + ev.duration_s, ("capacity", ev.domain, 1.0)))
            else:
                # throttle_storm / kv_stall: static windows, no heap
                # events — counted as fired when armed (the window opens
                # unconditionally on the mounts it targets)
                rt.count(ev.kind)
        return rt

    def count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1

    def storm_injector(self, worker_index: int
                       ) -> Optional[StoreStormInjector]:
        """Build the mount-level storm oracle for one worker, or None if
        no storm window ever targets it (the common, zero-cost case)."""
        storms = self.schedule.for_worker(worker_index, ("throttle_storm",))
        if not storms:
            return None
        windows = [(e.t, e.t + e.duration_s, e.fail_rate) for e in storms]
        return StoreStormInjector(windows, self.schedule.seed, worker_index)

    def kv_stall_windows(self, worker_index: int
                         ) -> Tuple[Tuple[float, float, float], ...]:
        """(start, end, extra_latency_s) windows for one worker's KV
        mount; empty tuple (zero-cost) when no stall targets it."""
        stalls = self.schedule.for_worker(worker_index, ("kv_stall",))
        return tuple((e.t, e.t + e.duration_s, e.extra_latency_s)
                     for e in stalls)

    def snapshot(self) -> Dict[str, Any]:
        """Summary dict for ``ClusterReport.chaos``."""
        return {
            "scheduled": len(self.schedule.events),
            "seed": self.schedule.seed,
            "fired": dict(sorted(self.counts.items())),
        }
