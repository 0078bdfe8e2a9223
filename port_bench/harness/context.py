"""One run's settings, as the window loops take them."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from reference.model import Spec


@dataclasses.dataclass
class Context:
    torch: Any
    cell: str
    arch: str  # the port's registered architecture
    model: dict  # the configuration's sizes (``model``)
    spec: Spec
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any  # torch.device the run draws and runs on
    t0: float  # the process's start on the host's clock
    fault: Optional[str] = None  # a fault planted under the timed path

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def port_device(self):
        """``models.build``'s device: None for the card, "cpu" here."""
        return None if self.on_card else "cpu"

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize()

    def now(self) -> float:
        return time.perf_counter()

    def reset_peak(self) -> None:
        if self.on_card:
            self.torch.cuda.reset_peak_memory_stats()

    def peak_bytes(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.on_card else 0

    def free(self) -> None:
        """Return what the process freed to the card."""
        import gc

        gc.collect()
        if self.on_card:
            self.torch.cuda.empty_cache()
