"""The prefill loop: one client, closed loop, through the port's
``train.serve_step.make_prefill``.

Set-up draws the weights in bf16 and a pool of distinct prompt batches
from the seed, all on the device, and warms the batch shape with two
prefills.  In the window the client sends a batch, takes the next token at
every position (the argmax of each position's logits over the vocabulary)
and copies the last position's tokens to the host; a batch's time to first
token runs from the call to that copy.  The next batch is sent at once.

The check samples, from the seed, requests the window finished
(:func:`checked`) and holds every position's next token against the
reference's logits of the same prompt: how far below the reference's best
each served token lies.  The control puts first, at each position of the
same kind of sample, the token the reference picks with weight-only fp8
weights, one step below the configuration's bfloat16.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from harness import faults, port, tokens, trace, weights
from harness.context import Context
from harness.record import Run
from reference import model
from reference.train import leaves

#: the numbers a limits file may name
NUMBERS = ("top_gap", "mean_gap")
FAULTS = faults.KINDS


def _pool(ctx: Context):
    """The distinct prompt batches [pool, B, S], on the device."""
    tr = ctx.traffic
    B, S = tr["batch"], tr["seq_len"]
    return ctx.torch.as_tensor(tokens.rows(
        ctx.seed, 1, tr["pool"] * B, S, ctx.spec.vocab_size,
        tr["tokens"]["chain_share"]), device=ctx.device).view(
            tr["pool"], B, S)


def checked(ctx: Context, served: int) -> np.ndarray:
    """The requests the check reads, drawn from the seed among the first
    ``served`` requests in the order sent (request r is row r % B of batch
    r // B, the batches sent in turn from the pool)."""
    return np.random.default_rng([ctx.seed % (1 << 64), 2]).choice(
        served, size=min(ctx.traffic["check_requests"], served),
        replace=False)


def _prompts(ctx: Context, pool, requests):
    B = ctx.traffic["batch"]
    return ctx.torch.stack([pool[(r // B) % len(pool), r % B]
                            for r in requests])


def run(ctx: Context) -> Tuple[Run, Dict[str, float], int, int]:
    """-> (the run, the compared numbers, requests attempted, failed)."""
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    torch, spec, tr = ctx.torch, ctx.spec, ctx.traffic
    B, S, V = tr["batch"], tr["seq_len"], spec.vocab_size
    cfg = port.config(ctx.arch, ctx.model, spec)
    net = build(cfg, device=ctx.port_device)
    params = weights.draw(spec, ctx.seed, torch.bfloat16, ctx.device)
    n_params = sum(t.numel() for t in leaves(params).values())
    pool = _pool(ctx)
    prefill = faults.stale(ctx.fault, make_prefill(net))
    record = Run(cell=ctx.cell, kind="prefill", spec=spec, batch=B,
                 seq_len=S, n_params=n_params, setup_s=0.0)
    record.marks["state_drawn"] = ctx.now() - ctx.t0

    def serve(i: int):
        start = ctx.now()
        logits = prefill(params, tokens=pool[i % tr["pool"]])
        top = faults.answer(ctx.fault, logits[..., :V].argmax(dim=-1), V)
        top[:, -1].cpu()
        return top.to(torch.int32), ctx.now() - start

    ctx.reset_peak()
    for w in range(tr["warmup_batches"]):
        serve(tr["pool"] - 1 - w)
        record.marks[f"warmup_{w + 1}"] = ctx.now() - ctx.t0
    ctx.sync()
    record.setup_s = ctx.now() - ctx.t0
    served = []
    if ctx.trace:
        from harness import spans as spans_mod
        with spans_mod.recording(torch, spec.ssm_state) as spans:
            record.trace = trace.capture(
                torch, lambda: served.append(serve(len(served))[0]),
                tr["trace_batches"], spans)
    else:
        start = ctx.now()
        while ctx.now() - start < ctx.seconds:
            top, seconds = serve(len(served))
            served.append(top)
            record.latencies_s.append(seconds)
        record.window_s = ctx.now() - start
    record.iterations = len(served)
    record.peak_bytes = ctx.peak_bytes()

    n = len(served) * B
    pick = checked(ctx, n)
    prompts = _prompts(ctx, pool, pick)
    answers = torch.stack([served[r // B][r % B] for r in pick])
    failed = int(((answers < 0) | (answers >= V)).any(dim=-1).sum())
    del params, prefill, net, served, pool
    ctx.free()
    start = ctx.now()
    numbers = gap_numbers(*prefill_gaps(ctx, prompts, answers))
    record.check_s = ctx.now() - start
    return record, numbers, n, failed


def control_numbers(ctx: Context) -> Dict[str, float]:
    """The control's numbers: it has no window, so its sample is drawn by
    :func:`checked` as from a window that served the whole pool."""
    tr = ctx.traffic
    prompts = _prompts(ctx, _pool(ctx), checked(ctx, tr["pool"] * tr["batch"]))
    return gap_numbers(*prefill_gaps(ctx, prompts, control=True))


def fp8(t):
    """``t`` through float8 e4m3 with one absmax scale a matrix (a matrix
    of a stack each): weight-only fp8, the step below bf16 weights."""
    import torch

    if t.dim() < 2:
        return t
    dims = tuple(range(t.dim() - 2, t.dim()))
    scale = t.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def prefill_gaps(ctx: Context, prompts, answers=None, control: bool = False):
    """The reference's logits of ``prompts`` [R, S], layer by layer from
    weights drawn again from the seed: the gap below the best of each
    served token ``answers`` [R, S], and each position's least router
    margin over the MoE layers (None without MoE) -> ([R, S], [R, S]);
    with ``control``, the gaps of the tokens the reference puts first with
    fp8 weights instead."""
    torch, spec = ctx.torch, ctx.spec
    n = spec.num_layers

    def exact(index: int, cast=lambda v: v.float()):
        drawn = weights.draw_layer(spec, ctx.seed, index, torch.bfloat16,
                                   ctx.device)
        return weights.nest({k: cast(v) for k, v in drawn.items()})

    def quantised(index: int):
        return exact(index, lambda v: fp8(v.float()))

    with torch.no_grad(), model.no_tf32():
        makers = (exact, quantised) if control else (exact,)
        xs = [model.embed(make(0)["embed"], prompts) for make in makers]
        margins: list = []
        for i, (mixer, ff) in enumerate(model.layer_plan(spec), start=1):
            xs = [model.block(make(i), spec, mixer, ff, x, m)
                  for make, x, m in zip(makers, xs, (margins, None))]
        tops = [dict(make(n + 1), embed=make(0)["embed"]) for make in makers]
        gaps = []
        for r in range(prompts.shape[0]):
            logits = model.head(tops[0], spec, xs[0][r:r + 1])
            if control:
                own = model.head(tops[1], spec, xs[1][r:r + 1])
                chosen = own[..., :spec.vocab_size].argmax(dim=-1)
            else:
                chosen = answers[r:r + 1]
            gaps.append(model.top_gap(logits, chosen, spec.vocab_size))
    least = (torch.stack(margins).min(dim=0).values if margins else None)
    return torch.cat(gaps), least


def gap_numbers(gaps, margins=None) -> Dict[str, float]:
    """{"top_gap": the widest gap, "mean_gap": the mean gap} over every
    position of every sampled prompt; with the positions' router
    ``margins``, the margin where the widest gap lies and the median
    margin (how near a tie the routing there was)."""
    out = {"top_gap": float(gaps.max()), "mean_gap": float(gaps.mean())}
    if margins is not None:
        out["router_margin_at_top_gap"] = float(
            margins.reshape(-1)[gaps.reshape(-1).argmax()])
        out["router_margin_median"] = float(margins.median())
    return out
