"""The training loop: closed-loop steps through the port's train step.

Set-up builds one train step (``train.make_train_step`` with
``launch.train.optimizer_config``), its model and its optimizer state, the
weights drawn from the seed as f32 masters, and feeds it through
``data.PrefetchLoader``: the pieces ``launch.train.Trainer.run_step``
puts together.  The first ``check_steps`` steps go through that same call
and feed, on rows that all differ; their losses, the first gradient as
the optimizer got it (its first moment over 1 - beta1) and the
parameters' change over them (before the next step moves them) are what
the reference is held to.  The window then runs step after step, the
losses kept on the device and read back every ``log_every`` steps, as
``launch.train``'s loop reads its metrics for its log line, until
``--seconds`` have passed at a log line; no checkpoint is written.

The comparison: each checked step's loss, the first gradient's norm and
the parameters' change over the checked steps, leaf by leaf, as the gap
between the program's norm and the reference's over the larger of the
reference's norm of that leaf and of the median leaf.  Leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of both (their change is round-off alone).  The control: the
reference with bfloat16 master weights and moments, one step below the
float32 the configuration states.
"""

from __future__ import annotations

import argparse
import math
import statistics
import sys
from typing import Dict, Optional, Tuple

from harness import faults, port, tokens, trace, weights
from harness.context import Context
from harness.record import Run
from reference.train import leaves

#: the numbers a limits file may name
NUMBERS = ("loss_gap", "grad_gap", "change_gap")
FAULTS = faults.KINDS
#: a leaf whose reference gradient is under this share of the median
#: leaf's is left out of the leaf comparisons
TINY_GRADIENT = 1e-3


def _rows(ctx: Context):
    tr = ctx.traffic
    B, S = tr["batch"], tr["seq_len"]
    pool = tokens.rows(ctx.seed, 0, tr["pool"] * B, S, ctx.spec.vocab_size,
                       tr["tokens"]["chain_share"])
    return [pool[i * B:(i + 1) * B] for i in range(tr["pool"])]


def _path(index: int, n_layers: int, name: str) -> str:
    """The parameter path of ``weights.draw_layer(index)``'s leaf."""
    return name if index in (0, n_layers + 1) else f"blocks.{index - 1}.{name}"


def _read(torch, losses) -> list:
    """The losses of the steps since the last log line, read back to the
    host at once (a wait for those steps)."""
    return torch.stack(losses).float().tolist() if losses else []


def run(ctx: Context) -> Tuple[Run, Dict[str, float], int, int]:
    """-> (the run, the compared numbers, steps attempted, steps failed)."""
    from repro_torch import convert
    from repro_torch.data.pipeline import PrefetchLoader
    from repro_torch.launch import train as ptrain
    from repro_torch.models import build
    from repro_torch.train import make_train_step
    from repro_torch.train import optimizer as opt_mod

    torch, spec, tr = ctx.torch, ctx.spec, ctx.traffic
    o = tr["optimizer"]
    cfg = port.config(ctx.arch, ctx.model, spec)
    model = build(cfg, device=ctx.port_device)
    params = weights.draw(spec, ctx.seed, torch.float32, ctx.device)
    n_params = sum(t.numel() for t in leaves(params).values())
    opt_cfg = ptrain.optimizer_config(argparse.Namespace(
        lr=o["lr"], warmup=o["warmup"], steps=o["decay_steps"],
        moments=o["moments"]))
    state = opt_mod.init(params, opt_cfg, convert.reference_shapes(cfg))
    step = make_train_step(model, opt_cfg)
    rows = _rows(ctx)
    loader = PrefetchLoader(({"tokens": r, "labels": r} for r in rows),
                            depth=2, device=ctx.device)
    record = Run(cell=ctx.cell, kind="train", spec=spec, batch=tr["batch"],
                 seq_len=tr["seq_len"], n_params=n_params, setup_s=0.0)
    record.marks["state_drawn"] = ctx.now() - ctx.t0

    def one_step():
        nonlocal params, state
        params, state, metrics = step(params, state,
                                      faults.batch(ctx.fault, next(loader)))
        return metrics

    program = {"loss": [], "grad_norms": {}, "change_norms": {}}
    with faults.optimizer(ctx.fault):
        ctx.reset_peak()
        for i in range(tr["check_steps"]):
            program["loss"].append(float(one_step()["loss"]))
            record.marks[f"step_{i + 1}"] = ctx.now() - ctx.t0
            if i == 0:
                program["grad_norms"] = {
                    k: float(v.norm()) / (1 - opt_cfg.beta1)
                    for k, v in leaves(state.mu).items()}
        now = leaves(params)
        with torch.no_grad():
            for index in range(spec.num_layers + 2):
                for name, t in weights.draw_layer(
                        spec, ctx.seed, index, torch.float32,
                        ctx.device).items():
                    path = _path(index, spec.num_layers, name)
                    program["change_norms"][path] = float(
                        (now[path] - t).norm())
        del now
        ctx.sync()
        record.setup_s = ctx.now() - ctx.t0
        losses, spent = [], False
        if ctx.trace:
            from harness import spans as spans_mod
            with spans_mod.recording(torch, spec.ssm_state) as spans:
                record.trace = trace.capture(torch, one_step,
                                             tr["trace_steps"], spans)
            record.iterations = 2 * tr["trace_steps"]
        else:
            pending = []  # the losses not yet read back, on the device
            start = last = ctx.now()
            while last - start < ctx.seconds:
                try:
                    pending.append(one_step()["loss"].detach())
                except StopIteration:  # the pool of distinct rows is spent
                    spent = True
                    break
                if len(pending) == tr["log_every"]:
                    losses += _read(torch, pending)
                    now = ctx.now()
                    record.latencies_s.append((now - last) / len(pending))
                    last, pending = now, []
            losses += _read(torch, pending)
            record.window_s = ctx.now() - start
            record.iterations = len(losses)
        record.peak_bytes = ctx.peak_bytes()
    failed = sum(1 for v in losses if not math.isfinite(v))

    if not spent:
        for _ in loader:  # the loader's thread ends with its rows
            pass
    del params, state, step, model, loader, one_step
    ctx.free()
    start = ctx.now()
    numbers = _check(ctx, program, rows[:tr["check_steps"]])
    record.check_s = ctx.now() - start
    return record, numbers, record.iterations, failed


def _batches(ctx: Context, rows):
    return [ctx.torch.as_tensor(r).to(ctx.device) for r in rows]


def _reference(ctx: Context, batches, **kw) -> dict:
    from reference import train as ref_train

    torch, spec, o = ctx.torch, ctx.spec, ctx.traffic["optimizer"]
    return ref_train.run(
        lambda: weights.draw(spec, ctx.seed, torch.float32, ctx.device),
        spec, batches, ref_train.AdamW(o["lr"], o["warmup"],
                                       o["decay_steps"]),
        o["z_loss_weight"], **kw)


def _check(ctx: Context, program: dict, check_rows) -> Dict[str, float]:
    worst: dict = {}
    ref = _reference(ctx, _batches(ctx, check_rows))
    numbers = train_numbers(program, ref, worst)
    for name, (leaf, got, want) in worst.items():
        print(f"{name}: leaf {leaf}, program {got!r}, reference {want!r}",
              file=sys.stderr)
    return numbers


def control_numbers(ctx: Context) -> Dict[str, float]:
    """The control's numbers: the reference with bfloat16 masters and
    moments, over the same rows, against the float32 reference."""
    batches = _batches(ctx, _rows(ctx)[:ctx.traffic["check_steps"]])
    return train_numbers(_reference(ctx, batches, masters=ctx.torch.bfloat16),
                         _reference(ctx, batches))


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               kept) -> Dict[str, float]:
    median = statistics.median(want[k] for k in kept)
    return {k: abs(got[k] - want[k]) / max(want[k], median) for k in kept}


def train_numbers(program: dict, ref: dict, worst: Optional[dict] = None
                  ) -> Dict[str, float]:
    """{"loss_gap", "grad_gap", "change_gap"} of the program's readings
    against the reference's; ``worst`` gets the leaf behind each leaf
    number and that leaf's two norms."""
    if set(program["grad_norms"]) != set(ref["grad_norms"]):
        raise ValueError("the program's leaves are not the reference's")
    g = ref["grad_norms"]
    floor = TINY_GRADIENT * statistics.median(g.values())
    kept = [k for k in g if g[k] >= floor]
    out = {"loss_gap": max(abs(a - b) / abs(b)
                           for a, b in zip(program["loss"], ref["loss"]))}
    for name, key in (("grad_gap", "grad_norms"),
                      ("change_gap", "change_norms")):
        gaps = _leaf_gaps(program[key], ref[key], kept)
        leaf = max(gaps, key=gaps.get)
        out[name] = gaps[leaf]
        if worst is not None:
            worst[name] = (leaf, program[key][leaf], ref[key][leaf])
    return out
