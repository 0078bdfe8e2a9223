"""Async input pipeline: background prefetch between store and device.

The counterpart of ``repro/data/pipeline.py``: a reader thread fills a
bounded queue of batches in order, and an error in the source surfaces on
the ``next()`` after the last good batch.  Where the JAX package
``device_put``s each batch with the step's shardings, the port copies it to
``device``: on the card, the reader thread puts each array in a pinned host
buffer and starts a ``non_blocking`` copy on a side CUDA stream, recording
an event; ``__next__`` makes the consumer's current stream wait on that
event, so the copy of batch N+1 overlaps step N.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.kernels.backend import DeviceLike


class PrefetchLoader:
    """Wraps a batch iterator with a daemon prefetch thread.  With
    ``device`` None the items pass as they come; with a device each batch
    (a dict of arrays) becomes a dict of tensors there."""

    def __init__(self, batches: Iterator, depth: int = 2,
                 device: DeviceLike = None):
        self._src = batches
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = None if device is None else torch.device(device)
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None
                        and self._device.type == "cuda" else None)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _prepare(self, batch):
        """-> (the batch as the consumer gets it, the copy's event or
        None, the pinned buffers the copy reads)."""
        if self._device is None:
            return batch, None, None
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self._stream is None:
            return {k: t.to(self._device) for k, t in host.items()}, None, None
        pinned = {k: t.pin_memory() for k, t in host.items()}
        with torch.cuda.stream(self._stream):
            out = {k: t.to(self._device, non_blocking=True)
                   for k, t in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready, pinned

    def _fill(self):
        try:
            for batch in self._src:
                self._q.put(self._prepare(batch))
        except BaseException as e:  # noqa: BLE001 — surfaced on next()
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready, _pinned = item
        if ready is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(ready)
            for t in batch.values():
                # made on the side stream, used on this one: the allocator
                # must not hand the memory out again before this stream is
                # done with it
                t.record_stream(stream)
        return batch
