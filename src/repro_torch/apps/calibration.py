"""Initial processing pipeline (paper §V.A): the petabyte campaign, in shape.

Per-scene stages, exactly as the paper lists them: "retrieving it from
Cloud Storage, uncompressing it, parsing the metadata, identifying the
bounding rectangle that contains valid data, cleaning the edges of the
image, converting the raw pixel information into meaningful units
(calibrated top of atmosphere reflectance using the appropriate constants
for each satellite and accounting for solar distance and zenith angle),
tiling each image, ... compressing the data into JPEG 2000 format, and
storing the result back into Cloud Storage."

Counterpart of ``repro/apps/calibration.py``.  The raw DN scene is read and
decoded on the host through the chunk store, copied to the device once as
uint16 (half the bytes of an f32 copy), and the bounding rectangle, the
crop, the valid mask, its erosion and the calibration all run there as
plain tensor ops; the masked reflectance comes back once and is tiled and
stored exactly as the JAX package does (same tile order, names, chunk
shapes, codec and all-invalid skip), so both packages write the same
bucket byte for byte.  The campaign runs on the port's scatter/gather
cluster engine, one worker thread per simulated node.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunkstore import ChunkStore
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.launch.cluster import (
    ClusterConfig,
    ClusterEngine,
    Worker,
    campaign_config,
)

@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Per-scene calibration metadata (Landsat MTL-style)."""

    scene_id: str
    gains: Tuple[float, ...]  # per-band reflectance rescale gain
    biases: Tuple[float, ...]  # per-band additive bias
    sun_elevation_deg: float  # solar elevation
    earth_sun_au: float  # Earth-Sun distance in AU

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @staticmethod
    def from_json(s: str) -> "SceneMeta":
        d = json.loads(s)
        d["gains"] = tuple(d["gains"])
        d["biases"] = tuple(d["biases"])
        return SceneMeta(**d)


def toa_reflectance(dn: torch.Tensor, meta: SceneMeta) -> torch.Tensor:
    """DN -> top-of-atmosphere reflectance (USGS Landsat 8 handbook form):

        rho' = M_p * DN + A_p
        rho  = rho' * d^2 / sin(theta_se)

    dn: [H, W, C] uint16 -> f32 reflectance clipped to [0, 1.5], bit for
    bit the JAX package's numpy result.  The scalars are f32 tensors on
    ``dn``'s device: CUDA divides by a host scalar through its reciprocal,
    which is not IEEE division."""
    dev = dn.device
    gains = torch.tensor(meta.gains, dtype=torch.float32, device=dev)
    biases = torch.tensor(meta.biases, dtype=torch.float32, device=dev)
    d2 = np.float32(meta.earth_sun_au ** 2)
    sin_e = max(np.float32(math.sin(math.radians(meta.sun_elevation_deg))),
                1e-3)
    rho = dn.to(torch.float32) * gains + biases
    rho = rho * torch.tensor(d2, dtype=torch.float32, device=dev)
    rho = rho / torch.tensor(sin_e, dtype=torch.float32, device=dev)
    return rho.clamp_(0.0, 1.5)


def valid_bounding_rect(dn: torch.Tensor,
                        fill_value: int = 0) -> Tuple[int, int, int, int]:
    """(y0, x0, y1, x1) of the valid-data rectangle (paper: "identifying the
    bounding rectangle that contains valid data"); (0, 0, 0, 0) when no
    pixel is valid.  One host sync for the four ints."""
    valid = (dn != fill_value).any(dim=-1)
    if valid.numel() == 0:
        return (0, 0, 0, 0)
    bounds = []
    for axis_any in (valid.any(dim=1), valid.any(dim=0)):
        idx = torch.arange(axis_any.numel(), device=valid.device)
        bounds += [torch.where(axis_any, idx, axis_any.numel()).min(),
                   torch.where(axis_any, idx, -1).max()]
    y0, y_last, x0, x_last = torch.stack(bounds).tolist()
    if y_last < 0:
        return (0, 0, 0, 0)
    return y0, x0, y_last + 1, x_last + 1


def clean_edges(img: torch.Tensor, valid: torch.Tensor,
                erode_px: int = 2) -> torch.Tensor:
    """Erode the valid mask inward: scan-line / edge artifacts die here."""
    v = valid.clone()
    for _ in range(erode_px):
        shrunk = v.clone()
        shrunk[1:, :] &= v[:-1, :]
        shrunk[:-1, :] &= v[1:, :]
        shrunk[:, 1:] &= v[:, :-1]
        shrunk[:, :-1] &= v[:, 1:]
        v = shrunk
    return v


def _synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def calibrate_scene(raw: np.ndarray, meta: SceneMeta,
                    device: DeviceLike = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> Tuple[Tuple[int, int, int, int], np.ndarray]:
    """A raw [H, W, C] uint16 scene -> (its valid rectangle, the cropped
    reflectance [h, w, C] f32 with the eroded invalid pixels zeroed).  One
    copy to ``device`` and one back.  ``timings``, when given, receives the
    seconds of the copy in, the device work (synchronised) and the copy
    out."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    dn = torch.from_numpy(np.ascontiguousarray(raw)).to(dev)
    if timings is not None:
        _synchronize(dev)
        timings["host_to_device"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    y0, x0, y1, x1 = valid_bounding_rect(dn)
    dn = dn[y0:y1, x0:x1]
    valid = clean_edges(dn, (dn != 0).any(dim=-1))
    refl = toa_reflectance(dn, meta).mul_(valid[..., None])
    del dn, valid
    if timings is not None:
        _synchronize(dev)
        timings["device_ops"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = refl.cpu().numpy()
    if timings is not None:
        timings["device_to_host"] = time.perf_counter() - t0
    return (y0, x0, y1, x1), out


def process_scene(cs_in: ChunkStore, cs_out: ChunkStore,
                  scene_key: str, tile_px: int = 64,
                  device: DeviceLike = None,
                  timings: Optional[Dict[str, float]] = None) -> Dict:
    """One task: read raw scene -> calibrate -> clean -> tile -> store.
    Runs on the card unless ``device="cpu"``; ``timings``, when given,
    receives the seconds of each stage (see :func:`calibrate_scene`)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    raw = cs_in.open(f"{scene_key}/dn").read_all()  # [H, W, C] uint16
    meta = SceneMeta.from_json(
        cs_in.fs.read(f"{cs_in.root}/{scene_key}/meta.json").decode())
    if timings is not None:
        timings["read_decode"] = time.perf_counter() - t0

    (y0, x0, y1, x1), refl = calibrate_scene(raw, meta, dev, timings)

    t0 = time.perf_counter()
    h, w, c = refl.shape
    tiles = 0
    for ty in range(0, h, tile_px):
        for tx in range(0, w, tile_px):
            tile = refl[ty:ty + tile_px, tx:tx + tile_px]
            if not tile.any():
                continue  # all-invalid tile: don't store (paper's economics)
            name = f"{scene_key}/t{ty // tile_px}_{tx // tile_px}"
            arr = cs_out.create(name, tile.shape, np.float32,
                                (min(tile_px, tile.shape[0]),
                                 min(tile_px, tile.shape[1]), c),
                                codec="zlib")
            arr.write_region((0, 0, 0), tile)
            tiles += 1
    if timings is not None:
        timings["tile_encode_put"] = time.perf_counter() - t0
    return {"scene": scene_key, "tiles": tiles,
            "rect": [y0, x0, y1, x1]}


def make_raw_scene(cs: ChunkStore, scene_key: str, height: int, width: int,
                   bands: int = 4, seed: int = 0) -> SceneMeta:
    """Synthesize a raw DN scene + metadata (the test/bench input side)."""
    rng = np.random.default_rng(seed)
    dn = rng.integers(1, 40000, size=(height, width, bands)).astype(np.uint16)
    # fill borders with nodata (the edge-cleaning target)
    pad = max(1, height // 16)
    dn[:pad], dn[-pad:], dn[:, :pad], dn[:, -pad:] = 0, 0, 0, 0
    meta = SceneMeta(scene_id=scene_key,
                     gains=tuple([2e-5] * bands),
                     biases=tuple([-0.1] * bands),
                     sun_elevation_deg=float(rng.uniform(25, 65)),
                     earth_sun_au=float(rng.uniform(0.98, 1.02)))
    arr = cs.create(f"{scene_key}/dn", dn.shape, np.uint16,
                    (min(256, height), min(256, width), bands), codec="zlib")
    arr.write_region((0, 0, 0), dn)
    cs.fs.write(f"{cs.root}/{scene_key}/meta.json", meta.to_json().encode())
    return meta


def run_campaign(cs_in: ChunkStore, cs_out: ChunkStore, scene_keys,
                 num_workers: Optional[int] = None, tile_px: int = 64,
                 engine_config: Optional[ClusterConfig] = None,
                 device: DeviceLike = None) -> Dict:
    """The §V.A pattern through the scatter/gather cluster engine.

    One task per scene over `num_workers` simulated nodes (default 4; or
    a full :class:`ClusterConfig` via `engine_config` — e.g. virtual-time
    with an elastic schedule).  Each node mounts the campaign bucket via
    its own Festivus instance over the *shared* object store and metadata
    KV, so the caller's mounts see every tile the fleet writes.  `cs_in`
    and `cs_out` must share one underlying store (they may use different
    roots); the per-worker mounts re-root onto both.  The worker threads
    calibrate on ``device`` concurrently.  Returns the legacy summary dict
    plus the full :class:`ClusterReport` under ``"report"``.
    """
    if cs_in.fs.store is not cs_out.fs.store or cs_in.fs.meta is not cs_out.fs.meta:
        raise ValueError(
            "run_campaign needs cs_in and cs_out over one shared object "
            "store + metadata KV (the fleet mounts a single bucket)")
    config = campaign_config(num_workers, engine_config)
    dev = resolve_device(device)

    def handler(worker: Worker, scene_key: str):
        return process_scene(worker.chunkstore(cs_in.root),
                             worker.chunkstore(cs_out.root),
                             scene_key, tile_px, device=dev)

    engine = ClusterEngine(cs_in.fs.store, meta=cs_in.fs.meta, config=config)
    report = engine.run({k: k for k in scene_keys}, handler)
    if not report.all_done:
        raise RuntimeError(
            f"campaign incomplete: {report.queue_stats} "
            f"dead={report.dead_tasks}")
    return {"scenes": len(scene_keys), "stats": report.queue_stats,
            "results": report.results, "report": report}
