"""What one run measured, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from reference.model import Spec


@dataclasses.dataclass
class Trace:
    """The traced iterations, reduced from the profiler's events.

    ``device``: each device operation as (name, start_us, end_us);
    ``busy_s``: the union of their intervals; ``window_s``: the traced
    window's length on the host's clock; ``plain_s``: the same number of
    iterations just before, timed without the profiler; ``ranges``: the benchmark's
    profiler ranges around calls into the port, name -> [(label, device
    microseconds of the kernels launched inside)]; ``spans``: CUDA-event
    spans, name -> [milliseconds]; ``idle_gaps``: seconds the device sat
    idle, by the host operation running when each gap began."""

    iterations: int
    window_s: float
    plain_s: float
    busy_s: float
    device: List[Tuple[str, float, float]]
    ranges: Dict[str, List[Tuple[str, float]]]
    spans: Dict[str, List[float]]
    idle_gaps: List[Tuple[str, float]]


@dataclasses.dataclass
class Run:
    """One run of a cell: its sizes, its window and, with ``--trace 1``,
    its trace."""

    cell: str
    kind: str  # the loop's kind: "train" or "prefill"
    spec: Spec
    batch: int
    seq_len: int
    n_params: int
    setup_s: float
    window_s: float = 0.0
    iterations: int = 0
    #: each prefill's time to first token, or each training step's seconds
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    peak_bytes: int = 0
    check_s: float = 0.0  # the output check's seconds, after the window
    #: set-up's stages: seconds from the process's start at each mark
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None

    @property
    def tokens(self) -> int:
        """Tokens the window's iterations processed."""
        return self.iterations * self.batch * self.seq_len
