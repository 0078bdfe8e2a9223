"""What the metric readers (``metrics/*.py``) share: the frozen rules that
group device operations by name, and the reductions of a trace."""

from __future__ import annotations

from typing import Optional

from counts import bounds
from counts.model_flops import step_flops
from counts.peaks import BF16_OPS_PER_S
from harness.record import Run

#: the port's kernels by a part of their names (a frozen copy of
#: ``chip_smoke.py``'s ``KERNEL_SYMBOLS``)
KERNEL_SYMBOLS = {"flash_attention": "flash_attention_kernel",
                  "flash_attention_bwd": "flash_bwd_",
                  "ssd_scan": "ssd_scan_kernel",
                  "ssd_scan_bwd": "ssd_bwd_"}
#: cuBLAS's matmul kernels by a part of their names
MATMUL_WORDS = ("gemm", "nvjet", "xmma", "cutlass")


def kernel_group(name: str) -> str:
    """A device operation's group: one of the port's kernels, "matmul", or
    "other" (a frozen copy of ``chip_smoke.py``'s ``kernel_group``)."""
    for kernel, symbol in KERNEL_SYMBOLS.items():
        if symbol in name:
            return kernel
    low = name.lower()
    if any(w in low for w in MATMUL_WORDS):
        return "matmul"
    return "other"


def traced(run: Run, kind: str) -> bool:
    """Whether ``run`` is a ``kind`` run whose trace saw the device."""
    return (run.kind == kind and run.trace is not None
            and run.trace.busy_s > 0)


def idle_pct(run: Run, kind: str) -> Optional[float]:
    if not traced(run, kind):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def mfu_pct(run: Run, kind: str) -> Optional[float]:
    """Model FLOPs of an iteration over its time without the profiler
    (``Trace.plain_s``) and the bf16 peak."""
    if not traced(run, kind):
        return None
    flops = step_flops(run.spec, run.batch, run.seq_len, kind == "train")
    return (100.0 * flops * run.trace.iterations / run.trace.plain_s
            / BF16_OPS_PER_S)


def elementwise_ms(run: Run, kind: str) -> Optional[float]:
    """Device milliseconds an iteration outside matmuls and the port's
    kernels."""
    if not traced(run, kind):
        return None
    us = sum(e - s for name, s, e in run.trace.device
             if kernel_group(name) == "other")
    return us * 1e-3 / run.trace.iterations


def ssd_roofline(run: Run, kind: str, direction: str) -> Optional[float]:
    """The SSD's bound over the device time of its ranges, in %: the
    forward (``ssd_fwd``) or backward (``ssd_bwd``) ranges' labels give
    each call's shape."""
    if not traced(run, kind):
        return None
    calls = run.trace.ranges.get(f"ssd_{direction}", [])
    spent_us = sum(us for _, us in calls)
    if not calls or spent_us <= 0:
        return None
    bound_ms = 0.0
    for label, _ in calls:
        parts = label.split("|")
        shape = tuple(int(v) for v in parts[0].split(","))
        x_bytes = int(parts[1])
        if direction == "fwd":
            bound_ms += bounds.ssd_bound(shape, x_bytes, parts[2] == "1")[2]
        else:
            bound_ms += bounds.ssd_bwd_bound(shape, x_bytes, grouped=True,
                                             skip=True)[2]
    return 100.0 * bound_ms / (spent_us * 1e-3)
