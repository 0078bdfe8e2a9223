"""Tracing a few iterations with ``torch.profiler``, reduced to a
:class:`record.Trace`.

The device's busy time is the union of its operations' intervals; a
range's device time is the sum of the kernels launched by host operations
inside it (the time of the work the range asked for, whatever names its
kernels have); an idle gap is labelled by the innermost host operation
running when it began.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from harness.record import Trace

#: prefix of the benchmark's own profiler ranges ("pb::ssd_fwd|<label>")
RANGE = "pb::"
#: idle gaps labelled, longest first
LABELLED_GAPS = 300


def _union(intervals: List[Tuple[float, float]]):
    """Merged intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _subtree_kernel_us(event) -> float:
    total, stack = 0.0, [event]
    while stack:
        e = stack.pop()
        total += sum(k.duration for k in e.kernels
                     if not k.name.startswith(RANGE))
        stack.extend(e.cpu_children)
    return total


def _label_gaps(host, gaps: List[Tuple[float, float]]):
    """(label, seconds) of the longest gaps, summed by label."""
    if not host or not gaps:
        return []
    starts = np.array([e.time_range.start for e in host])
    ends = np.array([e.time_range.end for e in host])
    depth = np.zeros(len(host))
    for i, e in enumerate(host):
        p, d = e.cpu_parent, 0
        while p is not None:
            d, p = d + 1, p.cpu_parent
        depth[i] = d
    by_label: Dict[str, float] = {}
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]:
        inside = np.nonzero((starts <= s) & (ends >= s))[0]
        label = ("(no host operation)" if inside.size == 0
                 else host[inside[np.argmax(depth[inside])]].name)
        by_label[label] = by_label.get(label, 0.0) + (e - s) * 1e-6
    return sorted(by_label.items(), key=lambda kv: -kv[1])


def capture(torch, fn: Callable[[], None], iterations: int,
            spans=None) -> Trace:
    """Run ``fn`` ``iterations`` times on the host's clock alone, recording
    ``spans`` (a ``spans.Spans``), then ``iterations`` times more under the
    profiler, and reduce the second run's events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    if spans is not None:
        spans.active = True
    t0 = time.perf_counter()
    for _ in range(iterations):
        fn()
    if on_card:
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    if spans is not None:
        spans.active = False
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iterations):
            fn()
        if on_card:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    events = prof.events()
    device, host, ranges = [], [], {}
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(RANGE):
                device.append((e.name, e.time_range.start, e.time_range.end))
        elif not e.is_async:
            host.append(e)
            if e.name.startswith(RANGE):
                name, _, label = e.name[len(RANGE):].partition("|")
                ranges.setdefault(name, []).append(
                    (label, _subtree_kernel_us(e)))
    merged = _union([(s, e) for _, s, e in device])
    busy_us = sum(e - s for s, e in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return Trace(iterations=iterations, window_s=window_s, plain_s=plain_s,
                 busy_s=busy_us * 1e-6, device=device, ranges=ranges,
                 spans=spans.ms() if spans is not None else {},
                 idle_gaps=_label_gaps(host, gaps))


def breakdown(trace: Trace) -> dict:
    """The ten device operations that took most time, and the ten host
    operations the longest idle gaps began under (seconds, all digits)."""
    by_name: Dict[str, float] = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n[:160], s] for n, s in trace.idle_gaps[:10]]}
