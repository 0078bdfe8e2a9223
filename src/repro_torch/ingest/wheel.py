"""Continuous ingest + the reanalysis wheel over the cluster DES.

The paper's workloads exist because scenes *keep arriving*: the composite
is not a prebuilt artifact but a living array that an ingest tier keeps
writing while the serving tier keeps answering tiles over it.  The Matsu
Wheel (PAPERS.md) is the recurring half: a scanning campaign that sweeps
every freshly-ingested batch through the analytics (here an NDVI-class
band index) exactly once, then refreshes the overview pyramid so the
serving tier sees the new pixels at every zoom.

Two payload kinds ride the cluster engine's queue, both marked with a
truthy ``wheel_payload`` class attribute (how
:meth:`repro_torch.serve.tileserver.TileFleet.run` routes them to the ingest
handler without importing this module):

* :class:`SceneBatch` — a batch of scenes landing at virtual instant
  ``t``; the ingest task decodes/QAs them (CPU billed through
  :data:`repro_torch.core.perfmodel.INGEST_MODEL`), writes the pixels into the
  composite's chunk grid (object PUTs — real fabric flows, contending
  with serve and batch traffic), and records the batch in the shared
  metadata KV for the wheel to find.
* :class:`WheelTick` — the recurring scan: claims every
  ingested-but-unwheeled batch via ``setnx`` (the same lease-safe
  exactly-once primitive the task queue uses: a tick re-delivered after
  a lease expiry re-claims only its own half-done batches, and two ticks
  racing for one batch cannot both win), re-reads each batch's region,
  bills the band math, and runs the *incremental* pyramid rebuild —
  only the dirty ancestors are re-pooled.

Everything is deterministic: scene pixels are seeded per batch, arrival
times are seeded per stream, and under the virtual-time DES handlers run
one at a time.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import perfmodel
from repro_torch.core.chunkstore import spatial_dims

#: default chunkstore root — matches TileFleet's default
DEFAULT_ROOT = "bucket"


# ---------------------------------------------------------------------------
# payloads
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SceneBatch:
    """A batch of scenes arriving at virtual instant `t`.

    The footprint (`y0`, `x0`, `height`, `width`) addresses the target
    array's level-0 spatial axes; non-spatial axes (e.g. channels) span
    their full extent — a scene delivers every band.  `seed` makes the
    pixel payload reproducible.
    """

    #: marker TileFleet dispatches on (class attribute, survives frozen)
    wheel_payload = True

    batch_id: str
    t: float
    y0: int
    x0: int
    height: int
    width: int
    seed: int
    array: str = "composite"
    #: scenes folded into this batch (per-scene overhead is billed per)
    scenes: int = 1


@dataclasses.dataclass(frozen=True)
class WheelTick:
    """One revolution of the wheel at virtual instant `t`."""

    wheel_payload = True

    tick: int
    t: float
    array: str = "composite"


# ---------------------------------------------------------------------------
# KV schema (shared metadata store)
# ---------------------------------------------------------------------------
def _ingested_key(root: str, array: str) -> str:
    return f"wheel:ingested:{root}/{array}"


def _done_key(root: str, array: str) -> str:
    return f"wheel:done:{root}/{array}"


def _stats_key(root: str, array: str) -> str:
    return f"wheel:ndvi:{root}/{array}"


def _claim_key(root: str, array: str, batch_id: str) -> str:
    return f"wheel:claim:{root}/{array}:{batch_id}"


# ---------------------------------------------------------------------------
# arrival streams
# ---------------------------------------------------------------------------
def scene_batch_stream(shape: Sequence[int], chunks: Sequence[int],
                       duration_s: float, batches: int, seed: int = 0,
                       array: str = "composite", scenes_per_batch: int = 1,
                       max_span_chunks: int = 2,
                       align: bool = True) -> List[SceneBatch]:
    """A seeded stream of scene batches over ``(0, duration_s]``.

    Each batch rewrites a rectangle of 1..`max_span_chunks` chunks per
    spatial axis, chunk-aligned by default; ``align=False`` jitters the
    offsets into chunk interiors so edge chunks take the read-modify-write
    path (two batches sharing a boundary chunk then exercise the per-chunk
    KV lock).  Arrival times are sorted uniforms — the trace-shaped
    contract :meth:`TileFleet.run` expects.
    """
    if batches < 1:
        raise ValueError(f"need at least one batch, got {batches}")
    dh, dw = spatial_dims(shape)
    h, w = int(shape[dh]), int(shape[dw])
    ch, cw = int(chunks[dh]), int(chunks[dw])
    ny, nx = -(-h // ch), -(-w // cw)
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.uniform(duration_s * 0.02, duration_s, size=batches))
    out: List[SceneBatch] = []
    for i in range(batches):
        sy = int(rng.integers(1, max_span_chunks + 1))
        sx = int(rng.integers(1, max_span_chunks + 1))
        y0 = int(rng.integers(0, ny)) * ch
        x0 = int(rng.integers(0, nx)) * cw
        if not align:
            y0 = min(y0 + int(rng.integers(0, max(ch // 2, 1))), h - 1)
            x0 = min(x0 + int(rng.integers(0, max(cw // 2, 1))), w - 1)
        out.append(SceneBatch(
            batch_id=f"{i:04d}", t=float(ts[i]), y0=y0, x0=x0,
            height=min(sy * ch, h - y0), width=min(sx * cw, w - x0),
            seed=seed * 100003 + i, array=array, scenes=scenes_per_batch))
    return out


def wheel_ticks(duration_s: float, period_s: float,
                array: str = "composite",
                final_slack_s: float = 5.0) -> List[WheelTick]:
    """Recurring ticks every `period_s`, plus one final sweep after the
    last possible batch arrival — the revolution that catches batches
    ingested after the last periodic tick fired."""
    if period_s <= 0:
        raise ValueError(f"period must be positive, got {period_s}")
    times = []
    t = period_s
    while t < duration_s:
        times.append(t)
        t += period_s
    times.append(duration_s + final_slack_s)
    return [WheelTick(tick=i, t=float(t), array=array)
            for i, t in enumerate(times)]


def wheel_campaign(shape: Sequence[int], chunks: Sequence[int],
                   duration_s: float, batches: int, period_s: float,
                   seed: int = 0, array: str = "composite",
                   align: bool = True, scenes_per_batch: int = 1,
                   ) -> Tuple[Dict[str, Any], List[SceneBatch], List[WheelTick]]:
    """One call for the whole plan: ``(tasks, scenes, ticks)`` where
    `tasks` is ready for ``TileFleet.run(ingest_tasks=...)``."""
    scenes = scene_batch_stream(shape, chunks, duration_s, batches,
                                seed=seed, array=array, align=align,
                                scenes_per_batch=scenes_per_batch)
    ticks = wheel_ticks(duration_s, period_s, array=array)
    tasks: Dict[str, Any] = {f"scene/{b.batch_id}": b for b in scenes}
    tasks.update({f"tick/{t.tick:04d}": t for t in ticks})
    return tasks, scenes, ticks


# ---------------------------------------------------------------------------
# handlers
# ---------------------------------------------------------------------------
def make_wheel_handler(root: str = DEFAULT_ROOT):
    """The ingest-pool handler: dispatches both payload kinds.

    Handlers receive a :class:`~repro_torch.launch.cluster.Worker`; all I/O
    goes through its mount (accounted, water-filled on the fabric) and
    all coordination through its metered KV view.

    When the cluster exposes a fabric-aware placement handle
    (``worker.placement``, e.g. :class:`repro_torch.core.object_store.ZoneSpread`),
    each scene batch is placed into a home zone on ingest and both its
    write wave and the wheel's later scan route their flows there
    (:meth:`Worker.route_io`) — freshly-ingested hot chunks spread across
    every zone's water-filled capacity instead of piling onto the ingest
    pool's own (possibly pinned) zone.
    """

    def handler(worker, payload):
        if isinstance(payload, SceneBatch):
            return _ingest_batch(worker, root, payload)
        if isinstance(payload, WheelTick):
            return _wheel_tick(worker, root, payload)
        raise TypeError(f"not a wheel payload: {payload!r}")

    return handler


def _placement_key(root: str, array: str, batch_id: str) -> str:
    return f"{root}/{array}/batch:{batch_id}"


def _scene_pixels(spec, batch: SceneBatch) -> np.ndarray:
    """Deterministic stand-in for the decoded scene: seeded noise in the
    array's dtype, full extent on non-spatial axes."""
    dh, dw = spatial_dims(spec.shape)
    shape = list(spec.shape)
    shape[dh], shape[dw] = batch.height, batch.width
    rng = np.random.default_rng(batch.seed)
    dt = np.dtype(spec.dtype)
    if dt.kind in "ui":
        hi = min(np.iinfo(dt).max, 4095)  # 12-bit sensor range
        return rng.integers(0, hi, size=tuple(shape), dtype=dt)
    return rng.random(tuple(shape)).astype(dt)


def _ingest_batch(worker, root: str, batch: SceneBatch) -> Dict[str, Any]:
    arr = worker.chunkstore(root).open(batch.array)
    if worker.placement is not None:
        # place the batch's chunks into a home zone (round-robin, sticky)
        # and host this task's write flow there
        worker.route_io(worker.placement.place(
            _placement_key(root, batch.array, batch.batch_id)))
    data = _scene_pixels(arr.spec, batch)
    worker.charge_compute(
        perfmodel.INGEST_MODEL.ingest_cost_s(data.nbytes, batch.scenes))
    dh, dw = spatial_dims(arr.spec.shape)
    start = [0] * len(arr.spec.shape)
    start[dh], start[dw] = batch.y0, batch.x0
    arr.write_region(tuple(start), data)
    worker.fs.meta.hset(
        _ingested_key(root, batch.array), batch.batch_id,
        json.dumps({"y0": batch.y0, "x0": batch.x0,
                    "height": batch.height, "width": batch.width,
                    "t": batch.t, "scenes": batch.scenes}))
    return {"batch": batch.batch_id, "bytes": int(data.nbytes)}


def _wheel_tick(worker, root: str, tk: WheelTick) -> Dict[str, Any]:
    meta = worker.fs.meta
    ingested = meta.hgetall(_ingested_key(root, tk.array))
    done_key = _done_key(root, tk.array)
    claimed: List[str] = []
    for bid in sorted(ingested):
        ck = _claim_key(root, tk.array, bid)
        if meta.setnx(ck, tk.tick):
            claimed.append(bid)
        elif (meta.get(ck) == tk.tick
              and meta.hget(done_key, bid) is None):
            # our own lease-expired redelivery: the claim is ours but the
            # done marker never landed — reprocess (idempotent: every
            # write below is a plain overwrite)
            claimed.append(bid)
    if not claimed:
        return {"tick": tk.tick, "batches": 0, "scanned_bytes": 0,
                "pyramid_writes": 0}
    if worker.placement is not None:
        # scan where the data lives: a tick's read flow is hosted on the
        # first claimed batch's home zone (one flow per task is the DES
        # contract; claims are sorted, so the choice is deterministic)
        zone = worker.placement.zone_of(
            _placement_key(root, tk.array, claimed[0]))
        if zone is not None:
            worker.route_io(zone)
    arr = worker.chunkstore(root).open(tk.array)
    dh, dw = spatial_dims(arr.spec.shape)
    scanned = 0
    for bid in claimed:
        info = json.loads(ingested[bid])
        start = [0] * len(arr.spec.shape)
        stop = list(arr.spec.shape)
        start[dh], stop[dh] = info["y0"], info["y0"] + info["height"]
        start[dw], stop[dw] = info["x0"], info["x0"] + info["width"]
        pixels = arr.read_region(tuple(start), tuple(stop)).astype(np.float64)
        worker.charge_compute(perfmodel.INGEST_MODEL.scan_cost_s(pixels.nbytes))
        # NDVI shape when a band axis exists: (NIR - red) / (NIR + red);
        # single-band arrays fall back to a plain intensity mean
        if pixels.ndim >= 3 and pixels.shape[-1] >= 2:
            red, nir = pixels[..., 0], pixels[..., 1]
            ndvi = (nir - red) / (nir + red + 1e-9)
            summary = {"ndvi_mean": float(ndvi.mean()),
                       "pixels": int(ndvi.size)}
        else:
            summary = {"mean": float(pixels.mean()),
                       "pixels": int(pixels.size)}
        meta.hset(_stats_key(root, tk.array), bid, json.dumps(summary))
        meta.hset(done_key, bid, tk.tick)
        scanned += pixels.nbytes
    writes = arr.build_pyramid()  # incremental: dirty ancestors only
    return {"tick": tk.tick, "batches": len(claimed),
            "scanned_bytes": int(scanned), "pyramid_writes": int(writes)}


# ---------------------------------------------------------------------------
# outcome inspection (bench/test proofs)
# ---------------------------------------------------------------------------
def wheel_outcome(meta, root: str = DEFAULT_ROOT,
                  array: str = "composite") -> Dict[str, Any]:
    """Exactly-once audit from the KV: every ingested batch must appear in
    the done set exactly once, and the per-batch analytics must exist."""
    ingested = set(meta.hgetall(_ingested_key(root, array)))
    done = meta.hgetall(_done_key(root, array))
    stats = meta.hgetall(_stats_key(root, array))
    return {
        "ingested": len(ingested),
        "wheeled": len(done),
        "analyzed": len(stats),
        "missing": sorted(ingested - set(done)),
        "spurious": sorted(set(done) - ingested),
    }
