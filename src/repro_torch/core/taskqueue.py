"""Asynchronous task queue (the paper's Celery/Redis layer, §V.A).

"As worker nodes are provisioned and start, they connect to the Celery
broker to receive processing tasks in the queue."  Worker-*pull* scheduling
is what gives the paper's pipeline its elasticity (pre-emptible nodes join
and leave freely) and fault tolerance (a dead worker's tasks simply get
re-delivered).  This module implements that contract on the shared
MetadataStore, with the production features a thousand-node deployment
needs:

* **Leases with deadlines** — a claimed task must be completed or
  heartbeated before its lease expires, else it returns to the queue
  (crash/pre-emption recovery with no coordinator).
* **Bounded retries + dead-letter** — poison tasks can't wedge the fleet.
* **Straggler mitigation** — tasks running far beyond the observed median
  are speculatively re-issued to another worker; first completion wins,
  duplicates are ignored (idempotent completion).
* **Priorities and batch submit** — pipeline stages enqueue downstream work.

All timing is injected (``clock``), so fault-tolerance tests run
deterministically in virtual time.

The queue is built to sit on a simulator hot path: every per-event
operation is O(log n) or better.  State counts are maintained at each
transition (``counts``/``done``/``pending`` never scan the task table),
lease expiry pops a deadline-ordered heap with lazy invalidation instead
of sweeping every task per claim, and straggler selection pops a per-pool
running-task heap against an incrementally-maintained median — the
coordination layer stays cheap relative to the (simulated) I/O it
schedules.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core.metadata import MetadataStore

PENDING = "pending"
RUNNING = "running"
DONE = "done"
DEAD = "dead"


@dataclasses.dataclass
class Task:
    task_id: str
    payload: Any
    priority: int = 0
    max_retries: int = 3
    state: str = PENDING
    attempt: int = 0
    worker: Optional[str] = None
    lease_deadline: float = 0.0
    started_at: float = 0.0
    completed_at: float = 0.0
    result: Any = None
    error: Optional[str] = None
    #: how many workers hold (possibly speculative) claims right now
    active_claims: int = 0
    #: the workers holding those claims — fail/heartbeat from anyone else
    #: (e.g. a zombie whose lease already expired) is ignored
    claimants: set = dataclasses.field(default_factory=set)
    #: routing tag: only workers claiming with the same pool see this task
    #: (None = the default shared pool) — how a serving tier and a batch
    #: campaign share one queue + fabric without stealing each other's work
    pool: Optional[str] = None


class _RunningMedian:
    """Median of an append-only float stream: O(log n) add, O(1) median.

    Two balanced heaps (classic running median); matches
    ``statistics.median`` exactly, including the mean-of-middle-two rule
    for even counts — the straggler threshold must not drift by a ulp
    when the scan-based implementation is replaced."""

    __slots__ = ("_lo", "_hi")

    def __init__(self):
        self._lo: List[float] = []  # max-heap (negated): lower half
        self._hi: List[float] = []  # min-heap: upper half

    def add(self, x: float) -> None:
        if self._lo and x > -self._lo[0]:
            heapq.heappush(self._hi, x)
        else:
            heapq.heappush(self._lo, -x)
        if len(self._lo) > len(self._hi) + 1:
            heapq.heappush(self._hi, -heapq.heappop(self._lo))
        elif len(self._hi) > len(self._lo):
            heapq.heappush(self._lo, -heapq.heappop(self._hi))

    def __len__(self) -> int:
        return len(self._lo) + len(self._hi)

    def median(self) -> float:
        if not self._lo:
            raise ValueError("median of empty stream")
        if len(self._lo) > len(self._hi):
            return -self._lo[0]
        return (-self._lo[0] + self._hi[0]) / 2


class TaskQueue:
    """Worker-pull task queue with leases, retries, and speculation."""

    def __init__(self, meta: Optional[MetadataStore] = None,
                 default_lease_s: float = 60.0,
                 speculation_factor: float = 3.0,
                 min_completions_for_speculation: int = 5,
                 clock: Callable[[], float] = time.monotonic):
        self.meta = meta if meta is not None else MetadataStore()
        self.default_lease_s = default_lease_s
        self.speculation_factor = speculation_factor
        self.min_completions = min_completions_for_speculation
        self.clock = clock
        self._tasks: Dict[str, Task] = {}
        #: per-pool ready heaps of (-priority, seq, task_id); None is the
        #: default shared pool (claims match a task's pool exactly)
        self._ready: Dict[Optional[str], List] = {}
        #: per-pool PENDING counts, maintained at every state transition —
        #: an autoscaler polls this every tick, so it must not cost a
        #: full-task scan (the heaps can't be used: they hold stale entries)
        self._pending_counts: Dict[Optional[str], int] = {}
        #: per-state totals, maintained at every transition: counts()/done()
        #: are polled per simulated event and must not scan the task table
        self._state_counts: Dict[str, int] = {PENDING: 0, RUNNING: 0,
                                              DONE: 0, DEAD: 0}
        #: (lease_deadline, seq, task_id) of RUNNING tasks; entries whose
        #: deadline no longer matches the task are discarded lazily on pop
        self._lease_heap: List = []
        #: per-pool (started_at, seq, task_id) of RUNNING tasks — the
        #: straggler candidates, oldest first; lazily invalidated like the
        #: lease heap (a re-claim changes started_at)
        self._running_heaps: Dict[Optional[str], List] = {}
        self._seq = 0
        self._lock = threading.RLock()
        #: completed-duration median, maintained incrementally (the
        #: straggler threshold's input; no duration list is retained)
        self._median = _RunningMedian()
        self.stats = {"submitted": 0, "completed": 0, "retried": 0,
                      "expired": 0, "speculated": 0, "dead": 0,
                      "duplicate_completions": 0}

    def _transition(self, old: str, new: str) -> None:
        self._state_counts[old] -= 1
        self._state_counts[new] += 1

    # -- producer side --------------------------------------------------------
    def submit(self, task_id: str, payload: Any, priority: int = 0,
               max_retries: int = 3, pool: Optional[str] = None) -> Task:
        with self._lock:
            if task_id in self._tasks:
                raise ValueError(f"duplicate task id {task_id}")
            task = Task(task_id=task_id, payload=payload, priority=priority,
                        max_retries=max_retries, pool=pool)
            self._tasks[task_id] = task
            self._state_counts[PENDING] += 1
            self._push_ready(task)
            self.stats["submitted"] += 1
            return task

    def submit_batch(self, items: Dict[str, Any], priority: int = 0):
        for task_id, payload in items.items():
            self.submit(task_id, payload, priority=priority)

    def _push_ready(self, task: Task):
        """Every PENDING transition comes through here (submit, retry,
        lease-expiry requeue), so the per-pool count rides along."""
        self._seq += 1
        heapq.heappush(self._ready.setdefault(task.pool, []),
                       (-task.priority, self._seq, task.task_id))
        self._pending_counts[task.pool] = \
            self._pending_counts.get(task.pool, 0) + 1

    # -- worker side ----------------------------------------------------------
    def claim(self, worker: str, lease_s: Optional[float] = None,
              pool: Optional[str] = None) -> Optional[Task]:
        """Claim the next task: pending first, then a straggler to speculate.

        A worker claiming with ``pool=P`` sees only tasks submitted with
        ``pool=P`` (None being the default shared pool)."""
        lease = lease_s if lease_s is not None else self.default_lease_s
        now = self.clock()
        with self._lock:
            self._reap_expired(now)
            ready = self._ready.get(pool, ())
            while ready:
                _, _, tid = heapq.heappop(ready)
                task = self._tasks[tid]
                if task.state != PENDING:
                    continue  # stale heap entry
                self._pending_counts[task.pool] -= 1
                self._transition(PENDING, RUNNING)
                task.state = RUNNING
                task.worker = worker
                task.attempt += 1
                task.claimants = {worker}
                task.active_claims = 1
                task.started_at = now
                task.lease_deadline = now + lease
                self._track_running(task)
                return task
            # nothing pending: speculate on a straggler (same pool only)
            straggler = self._pick_straggler(now, exclude_worker=worker,
                                             pool=pool)
            if straggler is not None:
                straggler.claimants.add(worker)
                straggler.active_claims = len(straggler.claimants)
                straggler.lease_deadline = max(straggler.lease_deadline,
                                               now + lease)
                self._track_lease(straggler)
                self.stats["speculated"] += 1
                return straggler
            return None

    def _track_running(self, task: Task) -> None:
        """Index a fresh RUNNING claim for O(log n) expiry + speculation."""
        self._seq += 1
        heapq.heappush(self._lease_heap,
                       (task.lease_deadline, self._seq, task.task_id))
        heapq.heappush(self._running_heaps.setdefault(task.pool, []),
                       (task.started_at, self._seq, task.task_id))

    def _track_lease(self, task: Task) -> None:
        """Re-index a moved lease deadline (heartbeat, speculative claim);
        the superseded heap entry is discarded lazily on pop."""
        self._seq += 1
        heapq.heappush(self._lease_heap,
                       (task.lease_deadline, self._seq, task.task_id))

    def heartbeat(self, task_id: str, worker: str,
                  lease_s: Optional[float] = None) -> bool:
        lease = lease_s if lease_s is not None else self.default_lease_s
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None or task.state != RUNNING \
                    or worker not in task.claimants:
                return False
            task.lease_deadline = self.clock() + lease
            self._track_lease(task)
            return True

    def complete(self, task_id: str, worker: str, result: Any = None) -> bool:
        """Idempotent completion; the first finisher wins.

        A DEAD task stays dead: a zombie's late result must not resurrect a
        task already counted in the dead letter (the counters would lie)."""
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                return False
            if task.state in (DONE, DEAD):
                self.stats["duplicate_completions"] += 1
                return False
            if task.state == PENDING:
                # a zombie's completion landing after lease expiry
                # re-queued the task: it leaves PENDING without a claim
                self._pending_counts[task.pool] -= 1
            self._transition(task.state, DONE)
            task.state = DONE
            task.worker = worker
            task.result = result
            task.completed_at = self.clock()
            task.active_claims = 0
            task.claimants = set()
            if task.attempt > 0:  # ever claimed (started_at==0.0 is valid)
                self._median.add(task.completed_at - task.started_at)
            self.stats["completed"] += 1
            return True

    def fail(self, task_id: str, worker: str, error: str) -> None:
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None or task.state in (DONE, DEAD):
                return
            if worker not in task.claimants:
                return  # zombie: this worker's claim already expired
            task.claimants.discard(worker)
            task.active_claims = len(task.claimants)
            if task.active_claims > 0:
                return  # a speculative twin is still running
            task.error = error
            if task.attempt > task.max_retries:
                self._transition(RUNNING, DEAD)
                task.state = DEAD
                self.stats["dead"] += 1
            else:
                self._transition(RUNNING, PENDING)
                task.state = PENDING
                self.stats["retried"] += 1
                self._push_ready(task)

    # -- maintenance -----------------------------------------------------------
    def _reap_expired(self, now: float) -> None:
        """Expire overdue leases by popping the deadline heap — O(log n)
        per expiry, O(1) when nothing is due (the per-claim fast path).
        Entries whose deadline no longer matches the live task (heartbeat
        extension, completion, re-claim) are discarded lazily."""
        heap = self._lease_heap
        while heap and heap[0][0] <= now:
            deadline, _, tid = heapq.heappop(heap)
            task = self._tasks.get(tid)
            if task is None or task.state != RUNNING \
                    or task.lease_deadline != deadline:
                continue  # superseded entry
            task.active_claims = 0
            task.claimants.clear()
            self.stats["expired"] += 1
            if task.attempt > task.max_retries:
                self._transition(RUNNING, DEAD)
                task.state = DEAD
                task.error = "lease expired (max retries)"
                self.stats["dead"] += 1
            else:
                self._transition(RUNNING, PENDING)
                task.state = PENDING
                self._push_ready(task)

    def _pick_straggler(self, now: float, exclude_worker: str,
                        pool: Optional[str] = None) -> Optional[Task]:
        """Oldest singly-claimed RUNNING task of `pool` beyond the
        speculation threshold, from the per-pool running heap (oldest
        started_at == maximum age, so the heap top is the best candidate);
        the median over completed durations is maintained incrementally."""
        if len(self._median) < self.min_completions:
            return None
        threshold = self.speculation_factor * max(self._median.median(), 1e-9)
        heap = self._running_heaps.get(pool)
        if not heap:
            return None
        skipped = []
        found = None
        while heap:
            started_at, seq, tid = heap[0]
            task = self._tasks.get(tid)
            if task is None or task.state != RUNNING \
                    or task.started_at != started_at:
                heapq.heappop(heap)  # dead entry: drop for good
                continue
            if now - started_at <= threshold:
                break  # the oldest candidate is not old enough: nobody is
            if task.active_claims != 1 or task.worker == exclude_worker:
                # still RUNNING, just not speculatable right now (already
                # speculated, or it's the asker's own task): keep the entry
                skipped.append(heapq.heappop(heap))
                continue
            found = task
            break
        for entry in skipped:
            heapq.heappush(heap, entry)
        return found

    # -- introspection ----------------------------------------------------------
    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._state_counts)

    def pending(self) -> int:
        with self._lock:
            return self._state_counts[PENDING]

    def pending_by_pool(self) -> Dict[Optional[str], int]:
        """PENDING depth per routing pool (None = the default shared pool).

        This is the backlog signal an autoscaling controller watches (every
        tick, so it is counter-maintained, not scanned): tasks submitted
        (or re-queued by lease expiry) but not yet claimed by any worker
        of that pool."""
        with self._lock:
            return {pool: n for pool, n in self._pending_counts.items()
                    if n > 0}

    def done(self) -> bool:
        with self._lock:
            return (self._state_counts[PENDING] == 0
                    and self._state_counts[RUNNING] == 0)

    def results(self) -> Dict[str, Any]:
        with self._lock:
            return {tid: t.result for tid, t in self._tasks.items()
                    if t.state == DONE}

    def completion_times(self) -> Dict[str, float]:
        """task_id -> clock() at first completion (virtual time under the
        cluster DES) — the timestamps a serving tier turns into latency."""
        with self._lock:
            return {tid: t.completed_at for tid, t in self._tasks.items()
                    if t.state == DONE}

    def dead_tasks(self) -> List[Task]:
        with self._lock:
            return [t for t in self._tasks.values() if t.state == DEAD]


def run_workers(queue: TaskQueue, handler: Callable[[Any], Any],
                num_workers: int = 4, poll_s: float = 0.001,
                max_idle_polls: int = 50) -> None:
    """Thread-pool worker fleet for tests/examples/benchmarks.

    Each worker loops: claim -> run handler -> complete/fail.  Exceptions in
    the handler are converted to `fail` (triggering retry), reproducing the
    paper's pre-emptible-worker behaviour.
    """

    def worker_loop(worker_id: int):
        name = f"w{worker_id}"
        idle = 0
        while idle < max_idle_polls:
            task = queue.claim(name)
            if task is None:
                if queue.done():
                    return
                idle += 1
                time.sleep(poll_s)
                continue
            idle = 0
            try:
                result = handler(task.payload)
            except Exception as e:  # noqa: BLE001 — worker must not die
                queue.fail(task.task_id, name, f"{type(e).__name__}: {e}")
            else:
                queue.complete(task.task_id, name, result)

    threads = [threading.Thread(target=worker_loop, args=(i,), daemon=True)
               for i in range(num_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
