"""The benchmark's spans around calls into the port, for a traced run.

Recorded from here, around the port's own entry points, while a run is
traced:

* ``pb::ssd_fwd|B,L,H,P,N|x_bytes|grouped``, a profiler range around each
  ``kernels.ops.ssd`` call (the SSD forward, in a prefill and in a
  training step's forward and recompute);
* ``pb::ssd_bwd|B,L,H,P,N|x_bytes``, a profiler range around each
  ``SsdScanFn.backward`` (the SSD's backward under autograd);
* ``optimizer`` and ``moe``, CUDA events on the stream around each
  ``train.optimizer.update`` and each MoE layer's ``moe_forward``, in the
  iterations timed without the profiler.

Each wrapper calls the port's function with the same arguments and
returns what it returns.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

from harness.trace import RANGE


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = vars(owner)[name]
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


class Spans:
    """CUDA-event spans by name, recorded while ``active``; :meth:`ms` once
    the stream is synced."""

    def __init__(self, torch):
        self.torch = torch
        self.active = False
        self.events: Dict[str, list] = {}

    def timed(self, name: str, fn):
        torch = self.torch

        def call(*args, **kwargs):
            if not (self.active and torch.cuda.is_available()):
                return fn(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.setdefault(name, []).append((start, end))
            return out
        return call

    def ms(self) -> Dict[str, List[float]]:
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self.events.items()}


@contextlib.contextmanager
def recording(torch, ssm_state: int):
    """Inside, the port's entry points above record their spans; yields
    the :class:`Spans`."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import SsdScanFn
    from repro_torch.models import transformer
    from repro_torch.train import optimizer

    spans = Spans(torch)
    ssd, bwd = ops.ssd, SsdScanFn.backward

    def ssd_ranged(x, dt, a, b, c, **kwargs):
        label = (f"{','.join(map(str, x.shape))},{b.shape[-1]}|"
                 f"{x.element_size()}|{int(b.shape[2] == 1)}")
        with torch.profiler.record_function(f"{RANGE}ssd_fwd|{label}"):
            return ssd(x, dt, a, b, c, **kwargs)

    def bwd_ranged(ctx, dy):
        label = f"{','.join(map(str, dy.shape))},{ssm_state}|{dy.element_size()}"
        with torch.profiler.record_function(f"{RANGE}ssd_bwd|{label}"):
            return bwd(ctx, dy)

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(ops, "ssd", ssd_ranged))
        stack.enter_context(_patched(SsdScanFn, "backward",
                                     staticmethod(bwd_ranged)))
        stack.enter_context(_patched(optimizer, "update", spans.timed(
            "optimizer", optimizer.update)))
        stack.enter_context(_patched(transformer, "moe_forward", spans.timed(
            "moe", transformer.moe_forward)))
        yield spans
