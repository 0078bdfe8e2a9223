"""Elastic training orchestration: lease-based step ownership.

The paper's Celery pattern lifted to the training control plane: the
*trainer itself* is a queue worker.  A work item is a step range; a trainer
claims it under a lease, heartbeats while stepping, checkpoints at range
boundaries, and completes the item.  If the trainer is pre-empted (lease
expires), the range is re-delivered and the next trainer resumes from the
last committed checkpoint — no coordinator, no state outside the object
store + metadata KV.

Elastic scaling falls out of the same machinery: trainers can join/leave
between ranges, and checkpoint restore re-shards to whatever mesh the
claiming trainer runs (train/checkpoint.py restores region-wise).

This module is deliberately runtime-agnostic (the step function is
injected) so tests can drive it with a counter instead of a model.

The *simulated* counterpart lives in :mod:`repro_torch.launch.cluster`
(`ElasticSchedule` / `ElasticEvent` / `FleetController`): there the
join/leave timetable — or an SLO autoscaler extending it mid-run
(:mod:`repro_torch.serve.autoscale`) — drives virtual-time workers through the
same lease-expiry handoff this trainer relies on for real pre-emption.
Both sides lean on the queue's indexed hot path: lease expiry is a
deadline-heap pop and ``done()`` a counter read, so a trainer (or a
thousand simulated workers) polling between ranges costs O(log n), not a
task-table scan per claim.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

from repro_torch.core.metadata import MetadataStore
from repro_torch.core.taskqueue import TaskQueue


@dataclasses.dataclass
class RangeSpec:
    start: int
    stop: int

    @property
    def task_id(self) -> str:
        return f"steps:{self.start}:{self.stop}"


class ElasticTrainer:
    """Claims step ranges, heartbeats, checkpoints, survives pre-emption."""

    def __init__(self, queue: TaskQueue, worker_id: str,
                 step_fn: Callable[[int], None],
                 save_fn: Callable[[int], None],
                 restore_fn: Callable[[], int],
                 heartbeat_every: int = 8,
                 lease_s: float = 30.0):
        self.queue = queue
        self.worker_id = worker_id
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.heartbeat_every = heartbeat_every
        self.lease_s = lease_s
        self.steps_run = 0

    def run_once(self, die_at_step: Optional[int] = None) -> Optional[str]:
        """Claim and run one range; returns task id or None if queue empty.

        `die_at_step` simulates pre-emption: the trainer abandons the range
        without failing it — only the lease expiry recovers it, which is the
        realistic cloud failure mode.
        """
        task = self.queue.claim(self.worker_id, lease_s=self.lease_s)
        if task is None:
            return None
        rng: RangeSpec = task.payload
        resume = self.restore_fn()
        start = max(rng.start, resume)
        for step in range(start, rng.stop):
            if die_at_step is not None and step >= die_at_step:
                return task.task_id  # vanish: no complete, no fail
            self.step_fn(step)
            self.steps_run += 1
            if (step + 1) % self.heartbeat_every == 0:
                self.queue.heartbeat(task.task_id, self.worker_id,
                                     self.lease_s)
        self.save_fn(rng.stop)
        self.queue.complete(task.task_id, self.worker_id,
                            {"stop": rng.stop})
        return task.task_id

    def run(self, die_at_step: Optional[int] = None):
        while self.run_once(die_at_step) is not None:
            if die_at_step is not None and self.steps_run >= die_at_step:
                return


def submit_step_ranges(queue: TaskQueue, total_steps: int,
                       range_size: int) -> int:
    n = 0
    for start in range(0, total_steps, range_size):
        spec = RangeSpec(start, min(start + range_size, total_steps))
        queue.submit(spec.task_id, spec, priority=-start)  # in order
        n += 1
    return n
