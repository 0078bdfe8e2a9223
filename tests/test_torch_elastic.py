"""The port's elastic trainer (``repro_torch.launch.elastic``, a copy of
``repro.launch.elastic`` with the import prefix changed) against the JAX
package's, and over the port's real train step, on the CPU.

The queue trace of ``tests/test_taskqueue.py``'s pre-emption test is
replayed through both copies with the same injected clock: the steps run,
the commits and the queue's stats are equal.  Then ``ElasticTrainer``
drives ``launch.train.Trainer`` (llama3-8b smoke, f32, on the CPU) in
ranges of 2 steps: a trainer dies mid-range, its lease expires, a second
trainer restores the last commit and finishes; the final parameters and
moments equal, bit for bit, those of a run that was not interrupted.
"""

import argparse
import dataclasses

import pytest
import torch

from repro.core.taskqueue import TaskQueue as JTaskQueue
from repro.launch.elastic import ElasticTrainer as JElasticTrainer
from repro.launch.elastic import submit_step_ranges as jsubmit
from repro_torch.configs import get_config
from repro_torch.core.taskqueue import TaskQueue
from repro_torch.launch import ElasticTrainer, submit_step_ranges
from repro_torch.launch import train as ptrain
from repro_torch.train.checkpoint import flatten_with_path


class Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _replay(queue_cls, trainer_cls, submit, die_at: int):
    """tests/test_taskqueue.py's pre-emption trace: 30 steps in ranges of
    10, worker 1 commits the first range and dies at ``die_at``, the lease
    passes, worker 2 finishes."""
    clock = Clock()
    q = queue_cls(clock=clock, default_lease_s=5)
    submitted = submit(q, total_steps=30, range_size=10)
    committed = {"step": 0}
    steps_run, commits = [], []

    def save(s):
        committed["step"] = s
        commits.append(s)

    def mk(worker):
        return trainer_cls(q, worker, step_fn=steps_run.append, save_fn=save,
                           restore_fn=lambda: committed["step"], lease_s=5)

    w1 = mk("w1")
    claimed = [w1.run_once(), w1.run_once(die_at_step=die_at)]
    clock.t += 10.0
    w2 = mk("w2")
    while True:
        tid = w2.run_once()
        if tid is None:
            break
        claimed.append(tid)
    return {"submitted": submitted, "steps_run": steps_run,
            "commits": commits, "claimed": claimed,
            "w1_steps": w1.steps_run, "w2_steps": w2.steps_run,
            "stats": dict(q.stats), "done": q.done()}


@pytest.mark.parametrize("die_at", [13, 10, 19])
def test_elastic_copy_replays_the_jax_trace(die_at):
    want = _replay(JTaskQueue, JElasticTrainer, jsubmit, die_at)
    got = _replay(TaskQueue, ElasticTrainer, submit_step_ranges, die_at)
    assert got == want
    assert got["commits"] == [10, 20, 30] and got["done"]
    assert max(got["steps_run"]) == 29
    # steps re-run only from the last commit
    assert got["steps_run"][10:10 + die_at - 10] == list(range(10, die_at))
    assert got["steps_run"][die_at:die_at + 10] == list(range(10, 20))


def _args(**kw):
    args = ptrain.parser().parse_args(
        ["--arch", "llama3-8b", "--variant", "smoke", "--device", "cpu",
         "--steps", "6", "--batch", "2", "--seq", "16", "--lr", "3e-3",
         "--warmup", "2", "--data-shards", "2", "--ckpt-codec", "raw"])
    return argparse.Namespace(**{**vars(args), **kw})


def _state(tr):
    return [leaf for _, leaf in flatten_with_path(
        {"params": tr.params, "opt": tr.opt_state})]


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_elastic_trainer_over_the_real_train_step(moments):
    # d_ff 512: the FFN's leaves take int8 moments (65536 elements)
    cfg = dataclasses.replace(get_config("llama3-8b", "smoke"),
                              dtype="float32", d_ff=512)
    whole = ptrain.Trainer(_args(moments=moments), cfg)
    whole.fresh()
    for s in range(6):
        whole.run_step(s)

    tr = ptrain.Trainer(_args(moments=moments), cfg)
    clock = Clock()
    q = TaskQueue(clock=clock, default_lease_s=5)
    assert submit_step_ranges(q, total_steps=6, range_size=2) == 3
    ran = []

    def mk(worker):
        def step_fn(s):
            ran.append((worker, s))
            tr.run_step(s)
        return ElasticTrainer(q, worker, step_fn=step_fn, save_fn=tr.save,
                              restore_fn=tr.resume, lease_s=5)

    a = mk("a")
    assert a.run_once() == "steps:0:2"
    assert a.run_once(die_at_step=3) == "steps:2:4"  # dies after step 2
    tr.wait()
    assert tr.ckpt.steps() == [2]
    clock.t += 10.0  # the lease passes
    b = mk("b")
    b.run()
    tr.wait()
    assert q.done() and tr.ckpt.steps() == [4, 6]
    assert ran == [("a", 0), ("a", 1), ("a", 2),
                   ("b", 2), ("b", 3), ("b", 4), ("b", 5)]
    assert int(tr.opt_state.step) == 6
    for x, y in zip(_state(whole), _state(tr)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_a_dropped_mesh_trainer_frees_its_state():
    """A pre-empted trainer's state is freed once the trainer is dropped.
    Its loader's thread runs the batch generators, so they must hold
    nothing of the trainer: a mesh trainer's used to, and on the card the
    second trainer of ``chip_smoke.py``'s ``mesh_train`` stepped beside the
    first one's whole state (8.9 GB more at each step's peak)."""
    import gc
    import weakref

    from repro_torch.launch import mesh as pmesh

    cfg = dataclasses.replace(get_config("llama3-8b", "smoke"),
                              dtype="float32")
    try:
        tr = ptrain.Trainer(_args(mesh=True), cfg)
        tr.fresh()
        tr.run_step(0)
        assert tr.mesh is not None and tr._loader is not None
        held = weakref.ref(tr.params["embed"])
        del tr
        gc.collect()
        assert held() is None
    finally:
        pmesh.shutdown()
