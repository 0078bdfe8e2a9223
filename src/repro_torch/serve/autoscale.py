"""SLO-driven serve-pool autoscaler (paper §V.D: survive spikes by adding
capacity, not by over-provisioning).

The Mapserver tier's elastic-cloud advantage over a fixed HPC installation
is that a traffic spike is answered with *joins*, and the quiet hours are
not billed at peak size.  :class:`ServeAutoscaler` closes that loop inside
the cluster DES: it is a :class:`~repro_torch.launch.cluster.FleetController`,
ticked by the engine every ``interval_s`` of *virtual* time, and its scale
decisions are :class:`~repro_torch.launch.cluster.ElasticEvent`\\s applied
through the same join/leave machinery as any elastic schedule — so scaling
stays exactly-once (a drained worker's in-flight request recovers through
lease expiry / speculation) and adds no second source of truth.

Signals, per tick:

* **windowed p99 latency** — completion − arrival over requests that
  completed in the last ``window_s`` (the trailing SLO view; lags the
  spike by up to one window).
* **queue depth** — PENDING requests in the serve pool right now (the
  leading signal: a spike shows up here within one tick, long before the
  latency window turns over).

Scale-out joins pay a warm-up (:data:`repro_torch.core.perfmodel.SERVE_WARMUP_S`
by default): a joiner takes no traffic until ``join_t + warmup_s``, so
added capacity is provably not instant.  Scale-in drains prefer idle
victims and never go below ``min_servers``; both directions honour a
cooldown so one hot window cannot thrash the fleet.
"""

from __future__ import annotations

import bisect
import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core import perfmodel
from repro_torch.launch.cluster import ElasticEvent, FleetController, FleetView

#: must match repro_torch.serve.tileserver.SERVE_POOL (kept literal here so the
#: policy module does not import the server module it steers)
DEFAULT_POOL = "serve"


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """The SLO contract the autoscaler enforces, and how hard it reacts.

    `target_p99_s` is the breach line (scale out above it);
    `scale_in_p99_s` is the calm line (eligible to scale in below it —
    keep a wide gap between the two or the fleet flaps).  Queue depth
    breaches at ``queue_high_per_server * (active + warming)`` so a
    half-warmed fleet is not double-scaled.  `lease_s` is the request
    lease under autoscaling: a request orphaned by a drained worker is
    re-delivered after at most this much virtual time (the exactly-once
    handoff path), so keep it a small multiple of a miss service time.
    """

    min_servers: int = 1
    max_servers: int = 16
    target_p99_s: float = 0.05
    scale_in_p99_s: float = 0.01
    window_s: float = 0.1
    interval_s: float = 0.02
    queue_high_per_server: float = 3.0
    #: absolute floor under the depth trigger: a briefly-busy tiny fleet
    #: (one server, a few misses back to back) must not read as a spike
    queue_high_min: int = 10
    #: minimum join size; the actual join is backlog-proportional —
    #: ``max(scale_out_step, ceil(depth / queue_high_per_server))`` capped
    #: at max_servers — so a deep backlog is answered in one round, not
    #: chased with fixed steps while it compounds
    scale_out_step: int = 4
    scale_in_step: int = 3
    warmup_s: float = perfmodel.SERVE_WARMUP_S
    cooldown_s: float = 0.08
    #: consecutive calm ticks required before a drain (debounce)
    calm_ticks_to_drain: int = 3
    #: scale-in keeps at least ``offered_rps * mean_latency * headroom``
    #: servers: low latency alone is not a drain licence — it may simply
    #: mean the fleet is *currently adequate* for a still-raging spike,
    #: and draining on it would flap (drain -> breach -> rejoin -> ...)
    drain_headroom: float = 2.0
    lease_s: float = 0.5
    pool: str = DEFAULT_POOL
    #: never drain the serve pool while any of these *other* pools still
    #: has pending work — the continuous-ingest shape: a calm-looking
    #: serve window during a scene-batch wave is about to be re-heated by
    #: wheel-refreshed tiles (every invalidated tile is a future miss), so
    #: a drain now is a guaranteed rejoin.  Names must match the fleet's
    #: pool labels (e.g. "ingest"); empty tuple = legacy behaviour.
    hold_drain_while_pools: Tuple[str, ...] = ()
    #: predictive scale-out (default off): join on the arrival-rate
    #: *trend* — the last window's arrivals vs the window before it —
    #: instead of waiting for the trailing latency window to breach.  The
    #: latency signal lags a spike by up to ``window_s`` plus a service
    #: time; the arrival ramp is visible the instant it happens (the same
    #: counters a front-end load balancer already keeps).
    predictive: bool = False
    #: recent-rate / previous-rate ratio that counts as a surge
    predict_rate_ratio: float = 2.0
    #: ignore trends built on fewer recent arrivals than this (a handful
    #: of early requests must not read as a ramp)
    predict_min_arrivals: int = 20
    #: load-shedding line for a degradation-aware fleet (0 = off): when
    #: the serve pool's backlog exceeds ``brownout_queue_per_server *
    #: servers`` a :class:`~repro_torch.serve.tileserver.DegradePolicy`-driven
    #: handler sheds the request instead of queueing it deeper.  Sits
    #: *above* queue_high_per_server: scale-out is the first answer, shed
    #: is the last (capacity is already maxed or still warming).
    brownout_queue_per_server: float = 0.0

    def __post_init__(self):
        if self.min_servers < 1:
            raise ValueError(f"min_servers must be >= 1, got "
                             f"{self.min_servers}")
        if self.max_servers < self.min_servers:
            raise ValueError(f"max_servers {self.max_servers} < min_servers "
                             f"{self.min_servers}")
        if self.scale_in_p99_s >= self.target_p99_s:
            raise ValueError(
                f"scale-in threshold {self.scale_in_p99_s} must sit below "
                f"the target {self.target_p99_s} (hysteresis gap)")
        if min(self.window_s, self.interval_s, self.warmup_s,
               self.cooldown_s, self.lease_s) < 0 or self.interval_s == 0:
            raise ValueError("window/interval/warmup/cooldown/lease "
                             "must be non-negative (interval positive)")
        if self.scale_out_step < 1 or self.scale_in_step < 1:
            raise ValueError("scale steps must be >= 1")
        if self.drain_headroom < 1.0:
            raise ValueError(f"drain_headroom must be >= 1, got "
                             f"{self.drain_headroom}")
        if self.predict_rate_ratio <= 1.0:
            raise ValueError(f"predict_rate_ratio must exceed 1, got "
                             f"{self.predict_rate_ratio}")
        if self.predict_min_arrivals < 1:
            raise ValueError(f"predict_min_arrivals must be >= 1, got "
                             f"{self.predict_min_arrivals}")
        if self.brownout_queue_per_server < 0:
            raise ValueError(f"brownout_queue_per_server must be >= 0, got "
                             f"{self.brownout_queue_per_server}")


@dataclasses.dataclass(frozen=True)
class AutoscaleAction:
    """One decision, with the evidence it was taken on (all virtual time)."""

    t: float
    delta: int
    reason: str
    window_p99_s: float
    queue_depth: int
    servers_before: int
    servers_after: int


@dataclasses.dataclass
class AutoscaleReport:
    """Gathered autoscaling outcome for one campaign."""

    policy: AutoscalePolicy
    actions: List[AutoscaleAction]
    peak_servers: int
    min_servers_seen: int
    #: every joiner's first completion waited out its warm-up window
    warmup_ok: bool = True

    @property
    def joins(self) -> List[AutoscaleAction]:
        return [a for a in self.actions if a.delta > 0]

    @property
    def drains(self) -> List[AutoscaleAction]:
        return [a for a in self.actions if a.delta < 0]


class ServeAutoscaler(FleetController):
    """Watch the serve pool's SLO inside the DES; emit joins and drains.

    `arrivals` maps serve task ids to their virtual arrival instants (the
    fleet passes the request trace's timestamps) — joined with the
    engine's completion times it yields the windowed latency percentile.
    """

    def __init__(self, policy: AutoscalePolicy,
                 arrivals: Optional[Dict[str, float]] = None):
        self.policy = policy
        self.interval_s = policy.interval_s
        self.arrivals: Dict[str, float] = dict(arrivals or {})
        #: arrival instants, sorted once: offered-rate queries bisect this
        #: instead of scanning every arrival each tick
        self._arrival_times = sorted(self.arrivals.values())
        self.actions: List[AutoscaleAction] = []
        #: cooldowns are asymmetric: a scale-out is blocked only by a
        #: recent scale-out (give the warm-up a chance to land), never by
        #: a drain — reacting to a breach right after a drain IS the job;
        #: a drain is blocked by any recent action (join+drain = flap)
        self._last_out_t = float("-inf")
        self._last_in_t = float("-inf")
        self._calm_ticks = 0
        # The trailing latency window, maintained incrementally.  The old
        # scheme re-collected and re-sorted the whole window every tick
        # (O(W log W) — quadratic in aggregate over a million-request
        # run); instead, _log_ix marks how much of the engine's
        # append-only completion log has been consumed, _win_order holds
        # (done_t, latency) in completion order (expiry and the demand
        # floor's mean walk it front to back, preserving the old
        # summation order bit for bit), and _win_sorted keeps the same
        # latencies sorted via bisect insert/remove so the percentile
        # never sorts.
        self._log_ix = 0
        self._win_order: Deque[Tuple[float, float]] = deque()
        self._win_sorted: List[float] = []
        self._last_now = float("-inf")
        #: serve-pool size (active + warming) as of the last tick — the
        #: denominator a shedding handler's brownout threshold scales by
        #: (0 until the first tick; callers fall back to base fleet size)
        self.last_servers = 0

    # -- signal extraction ----------------------------------------------------
    def _advance(self, now: float, view: FleetView) -> None:
        """Fold new completions into the window; expire the stale edge."""
        log = view.completion_log
        if now < self._last_now or self._log_ix > len(log):
            # a rewound clock or a replaced log (unit tests drive ticks
            # with synthetic views): rebuild from scratch
            self._log_ix = 0
            self._win_order.clear()
            self._win_sorted = []
        self._last_now = now
        if self._log_ix < len(log):
            for done, tid in log[self._log_ix:]:
                t0 = self.arrivals.get(tid)
                if t0 is not None:
                    lat = done - t0
                    self._win_order.append((done, lat))
                    bisect.insort(self._win_sorted, lat)
            self._log_ix = len(log)
        horizon = now - self.policy.window_s
        order, ws = self._win_order, self._win_sorted
        while order and order[0][0] < horizon:
            _, lat = order.popleft()
            del ws[bisect.bisect_left(ws, lat)]

    def _window_latencies(self, now: float, view: FleetView) -> List[float]:
        """completion - arrival for requests completed in the last window,
        in completion order (a read of the incrementally-maintained
        window, so a tick costs its *new* completions, not the window's)."""
        self._advance(now, view)
        return [lat for _, lat in self._win_order]

    def _window_p99(self) -> float:
        """p99 straight off the sorted window.  The empty-window
        convention lives here and only here: no completions yet means no
        evidence of a breach, not a breach."""
        ws = self._win_sorted
        return perfmodel.percentile_sorted(ws, 99) if ws else 0.0

    def window_p99_s(self, now: float, view: FleetView) -> float:
        """Windowed latency p99 (0.0 while nothing has completed yet)."""
        self._advance(now, view)
        return self._window_p99()

    def _window_offered_rps(self, now: float) -> float:
        """Requests that *arrived* in the last window, as a rate."""
        if self.policy.window_s <= 0:
            return 0.0
        horizon = now - self.policy.window_s
        times = self._arrival_times
        n = (bisect.bisect_right(times, now)
             - bisect.bisect_right(times, horizon))
        return n / self.policy.window_s

    def _arrival_surge(self, now: float) -> bool:
        """True when the last window's arrivals outnumber the previous
        window's by the policy ratio — the leading edge of a spike, read
        off the arrival counters alone (no completions involved)."""
        w = self.policy.window_s
        if w <= 0:
            return False
        times = self._arrival_times
        hi = bisect.bisect_right(times, now)
        mid = bisect.bisect_right(times, now - w)
        lo = bisect.bisect_right(times, now - 2.0 * w)
        recent = hi - mid
        if recent < self.policy.predict_min_arrivals:
            return False
        return recent >= self.policy.predict_rate_ratio * max(mid - lo, 1)

    def _demand_floor(self, now: float, lats: List[float]) -> int:
        """Servers the current offered load needs (a Little's-law estimate:
        windowed arrival rate x mean observed latency x headroom).  With an
        empty queue the observed latency approximates pure service time, so
        this is what keeps a calm-*looking* but still-loaded fleet from
        draining into a flap (drain -> breach -> rejoin -> ...)."""
        if not lats:
            return self.policy.min_servers
        mean_lat = sum(lats) / len(lats)
        demand = (self._window_offered_rps(now) * mean_lat
                  * self.policy.drain_headroom)
        return max(self.policy.min_servers, math.ceil(demand))

    # -- the decision loop ----------------------------------------------------
    def tick(self, now: float, view: FleetView) -> List[ElasticEvent]:
        p = self.policy
        lats = self._window_latencies(now, view)
        p99 = self._window_p99()
        depth = view.pending_by_pool.get(p.pool, 0)
        active = view.active_by_pool.get(p.pool, 0)
        warming = view.warming_by_pool.get(p.pool, 0)
        servers = active + warming
        self.last_servers = servers
        out_cooled = now - self._last_out_t >= p.cooldown_s
        in_cooled = (now - max(self._last_out_t, self._last_in_t)
                     >= p.cooldown_s)

        hot = (p99 > p.target_p99_s
               or depth > max(p.queue_high_per_server * max(1, servers),
                              p.queue_high_min))
        if hot:
            self._calm_ticks = 0
            if servers >= p.max_servers or not out_cooled:
                return []
            # join sized to the backlog: enough capacity to drain it to
            # the per-server target in one round, never less than the step
            want = max(p.scale_out_step,
                       math.ceil(depth / max(p.queue_high_per_server, 1.0)))
            n = min(want, p.max_servers - servers)
            reason = ("p99_breach" if p99 > p.target_p99_s
                      else "queue_depth")
            self._record(now, +n, reason, p99, depth, servers)
            return [ElasticEvent(now, +n, pool=p.pool, warmup_s=p.warmup_s)]

        if p.predictive and self._arrival_surge(now):
            # the leading signal: arrivals are ramping even though neither
            # trailing signal has breached yet — join *now* so the warm-up
            # is paid before the backlog forms, and hold off any drain
            self._calm_ticks = 0
            if servers >= p.max_servers or not out_cooled:
                return []
            n = min(p.scale_out_step, p.max_servers - servers)
            self._record(now, +n, "predicted_demand", p99, depth, servers)
            return [ElasticEvent(now, +n, pool=p.pool, warmup_s=p.warmup_s)]

        calm = p99 < p.scale_in_p99_s and depth == 0
        if not calm:
            self._calm_ticks = 0
            return []
        if any(view.pending_by_pool.get(pool, 0) > 0
               for pool in p.hold_drain_while_pools):
            # an ingest/wheel wave is still in flight: its invalidations
            # are queued-up future misses, so the calm is not credible
            self._calm_ticks = 0
            return []
        self._calm_ticks += 1
        if (self._calm_ticks < p.calm_ticks_to_drain or not in_cooled
                or warming > 0 or servers <= p.min_servers):
            return []
        floor = self._demand_floor(now, lats)
        n = min(p.scale_in_step, servers - floor)
        if n < 1:
            return []  # demand still needs this fleet; latency just says ok
        self._calm_ticks = 0
        self._record(now, -n, "calm", p99, depth, servers)
        return [ElasticEvent(now, -n, pool=p.pool, prefer_idle=True)]

    def _record(self, now: float, delta: int, reason: str, p99: float,
                depth: int, servers: int) -> None:
        if delta > 0:
            self._last_out_t = now
        else:
            self._last_in_t = now
        self.actions.append(AutoscaleAction(
            t=now, delta=delta, reason=reason, window_p99_s=p99,
            queue_depth=depth, servers_before=servers,
            servers_after=servers + delta))

    # -- gather ---------------------------------------------------------------
    def report(self, base_servers: int) -> AutoscaleReport:
        sizes = [base_servers] + [a.servers_after for a in self.actions]
        return AutoscaleReport(policy=self.policy, actions=list(self.actions),
                               peak_servers=max(sizes),
                               min_servers_seen=min(sizes))
