"""Continuous scene ingest and the reanalysis wheel (paper §V, Matsu wheel)."""

from repro_torch.ingest.wheel import (SceneBatch, WheelTick, make_wheel_handler,
                                scene_batch_stream, wheel_campaign,
                                wheel_outcome, wheel_ticks)

__all__ = [
    "SceneBatch",
    "WheelTick",
    "make_wheel_handler",
    "scene_batch_stream",
    "wheel_campaign",
    "wheel_outcome",
    "wheel_ticks",
]
