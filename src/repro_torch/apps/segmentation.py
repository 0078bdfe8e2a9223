"""Field segmentation (paper §V.B): temporal edges -> fields -> polygons.

Counterpart of ``repro/apps/segmentation.py``.  The chain, stage by stage:

1. cloud mask: ``valid & (cloud_score < 0.5)``, torch ops on the device;
2. masked temporal gradient accumulation: the hand-written ``grad_mag``
   kernel;
3. temporal-mean gradient ``grad_sum / max(count, 1)``, thresholded into a
   binary edge map;
4. morphological closing with a 4-neighbour cross (:func:`clean_edges`);
5. connected components of the non-edge pixels (:func:`connected_components`,
   a min-label flood on the device) and a GeoJSON-style feature collection
   (:func:`polygonize`, one pass over the labels on the host).

A tile's stack is copied to the device once; the edge map and the labels
stay there until the labels come back to the host as ``np.int32``.

The stage functions take numpy arrays, which they copy to ``device`` (the
card unless ``"cpu"``) and answer in numpy, or tensors, which they keep on
the tensors' device and answer in tensors.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.apps.composite import cloud_score
from repro_torch.configs.festivus_imagery import ImageryConfig
from repro_torch.convert import stack_to_device
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.data import imagery
from repro_torch.kernels import ops as kops
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.launch.cluster import (
    ClusterConfig,
    ClusterEngine,
    Worker,
    campaign_config,
)

ArrayLike = Union[np.ndarray, torch.Tensor]

#: iterations of the label flood between two tests for its fixpoint (each
#: test is one host sync)
CHECK_EVERY = 16


def _tensor(a: ArrayLike, device: DeviceLike) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(np.asarray(a), device=resolve_device(device))


def _like(result: torch.Tensor, arg: ArrayLike) -> ArrayLike:
    """``result`` as a numpy array where the caller passed one."""
    return result if isinstance(arg, torch.Tensor) else result.cpu().numpy()


def temporal_edges(images: ArrayLike, valid: ArrayLike, cfg: ImageryConfig,
                   impl: str = "auto", device: DeviceLike = None) -> ArrayLike:
    """Stages 1-3: images [T, H, W, C], valid [T, H, W] bool -> the
    temporal-mean gradient thresholded into an edge map [H, W] bool."""
    if isinstance(images, torch.Tensor):
        imgs, v = images, valid
    else:
        imgs, v = stack_to_device(images, valid, resolve_device(device))
    valid_eff = v & (cloud_score(imgs, cfg) < 0.5)
    gsum, count = kops.grad_mag(imgs, valid_eff, impl=impl)
    return _like(gsum / count.clamp_min(1.0) > cfg.edge_threshold, images)


def _binary_dilate(x: torch.Tensor) -> torch.Tensor:
    p = F.pad(x, (1, 1, 1, 1), value=False)
    return (p[1:-1, 1:-1] | p[:-2, 1:-1] | p[2:, 1:-1]
            | p[1:-1, :-2] | p[1:-1, 2:])


def _binary_erode(x: torch.Tensor) -> torch.Tensor:
    p = F.pad(x, (1, 1, 1, 1), value=True)
    return (p[1:-1, 1:-1] & p[:-2, 1:-1] & p[2:, 1:-1]
            & p[1:-1, :-2] & p[1:-1, 2:])


def clean_edges(edges: ArrayLike, closing_steps: int = 1,
                device: DeviceLike = None) -> ArrayLike:
    """Stage 4: morphological closing (dilate then erode, 4-neighbour
    cross) bridges one-pixel gaps in field boundaries without fattening
    them permanently."""
    x = _tensor(edges, device)
    for _ in range(closing_steps):
        x = _binary_dilate(x)
    for _ in range(closing_steps):
        x = _binary_erode(x)
    return _like(x, edges)


def connected_components(mask: ArrayLike, device: DeviceLike = None
                         ) -> Tuple[ArrayLike, int]:
    """Label the 4-connected True regions of ``mask`` [H, W] -> (int32
    labels, 0 = background; the flood's iteration count).

    Each pixel starts with its 1-based row-major index and takes the
    minimum of its 4 neighbours' labels until nothing changes, so every
    component ends with the least index it holds: the JAX package's
    canonical labels, byte for byte.  The fixpoint is tested every
    ``CHECK_EVERY`` iterations (iterations past it change nothing), so the
    host syncs that many times less often; the count returned is the
    iterations run, a multiple of ``CHECK_EVERY``."""
    m = _tensor(mask, device).bool()
    h, w = m.shape
    if h * w + 2 > torch.iinfo(torch.int32).max:
        raise ValueError(f"{h}x{w} labels do not fit in int32")
    big = h * w + 2
    background = ~m
    # labels live inside a frame of `big`, the pad of the JAX version
    buf = torch.full((h + 2, w + 2), big, dtype=torch.int32, device=m.device)
    lab = buf[1:-1, 1:-1]
    lab.copy_(torch.arange(1, h * w + 1, dtype=torch.int32,
                           device=m.device).view(h, w))
    lab.masked_fill_(background, big)
    new = torch.empty((h, w), dtype=torch.int32, device=m.device)
    iterations = 0
    while True:
        before = lab.clone()
        for _ in range(CHECK_EVERY):
            torch.minimum(buf[:-2, 1:-1], buf[2:, 1:-1], out=new)
            torch.minimum(new, buf[1:-1, :-2], out=new)
            torch.minimum(new, buf[1:-1, 2:], out=new)
            torch.minimum(new, lab, out=new)
            new.masked_fill_(background, big)
            lab.copy_(new)
        iterations += CHECK_EVERY
        if torch.equal(lab, before):
            break
    return _like(lab.masked_fill(background, 0), mask), iterations


def polygonize(labels: ArrayLike, min_pixels: int = 8) -> Dict:
    """Stage 5: components -> GeoJSON-style feature collection.

    Each field becomes a feature with its bounding-box polygon, pixel count
    and centroid, in ascending label order; fields under ``min_pixels`` are
    dropped.  The same dict as the JAX package's, built from one pass over
    the labels: the tile is cut into runs of one label along each row, and
    counts, coordinate sums and bounds are gathered per run.  Every sum is
    an integer below 2**53, so each centroid equals numpy's mean of the
    field's coordinates bit for bit."""
    if isinstance(labels, torch.Tensor):
        labels = labels.cpu().numpy()
    labels = np.asarray(labels)
    if labels.size == 0:
        return {"type": "FeatureCollection", "features": []}
    h, w = labels.shape
    flat = labels.ravel()
    starts = np.ones(flat.size, bool)
    np.not_equal(flat[1:], flat[:-1], out=starts[1:])
    starts[::w] = True  # a run never crosses a row
    starts = np.flatnonzero(starts)
    ends = np.append(starts[1:], flat.size)
    run_lab = flat[starts]
    keep = run_lab > 0
    starts, ends, run_lab = starts[keep], ends[keep], run_lab[keep]
    y = starts // w
    x0 = starts - y * w
    n = ends - starts
    x1 = x0 + n - 1

    ids, inv = np.unique(run_lab, return_inverse=True)
    counts = np.zeros(ids.size, np.int64)
    sum_x = np.zeros(ids.size, np.int64)
    sum_y = np.zeros(ids.size, np.int64)
    np.add.at(counts, inv, n)
    np.add.at(sum_x, inv, (x0 + x1) * n // 2)
    np.add.at(sum_y, inv, y * n)
    y_min = np.full(ids.size, h, np.int64)
    y_max = np.full(ids.size, -1, np.int64)
    x_min = np.full(ids.size, w, np.int64)
    x_max = np.full(ids.size, -1, np.int64)
    np.minimum.at(y_min, inv, y)
    np.maximum.at(y_max, inv, y)
    np.minimum.at(x_min, inv, x0)
    np.maximum.at(x_max, inv, x1)

    feats = []
    for i in np.flatnonzero(counts >= min_pixels):
        count = int(counts[i])
        x0_, y0_ = int(x_min[i]), int(y_min[i])
        x1_, y1_ = int(x_max[i]) + 1, int(y_max[i]) + 1
        feats.append({
            "type": "Feature",
            "properties": {"field_id": int(ids[i]), "pixels": count,
                           "centroid": [float(sum_x[i]) / count,
                                        float(sum_y[i]) / count]},
            "geometry": {"type": "Polygon",
                         "coordinates": [[[x0_, y0_], [x1_, y0_],
                                          [x1_, y1_], [x0_, y1_],
                                          [x0_, y0_]]]},
        })
    return {"type": "FeatureCollection", "features": feats}


def segment_tile(images: np.ndarray, valid: np.ndarray, cfg: ImageryConfig,
                 impl: str = "auto", device: DeviceLike = None
                 ) -> Tuple[np.ndarray, Dict]:
    """Full §V.B chain for one tile -> (labels [H, W] np.int32, geojson
    dict).  Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    imgs, v = stack_to_device(images, valid, dev)
    edges = temporal_edges(imgs, v, cfg, impl=impl)
    del imgs, v  # the stack's device memory is free for the flood
    labels, _ = connected_components(~clean_edges(edges))
    labels = labels.cpu().numpy()
    return labels, polygonize(labels)


def segment_to_store(cs: ChunkStore, tile_name: str, cfg: ImageryConfig,
                     out_prefix: str = "fields", device: DeviceLike = None
                     ) -> Dict:
    """Segment a stored tile and write its label array (one zlib chunk) and
    its ``fields.geojson`` beside it."""
    imgs, valid = imagery.read_scene_stack(cs, tile_name)
    labels, geo = segment_tile(imgs, valid, cfg, device=device)
    arr = cs.create(f"{out_prefix}/{tile_name}/labels", labels.shape,
                    labels.dtype, labels.shape, codec="zlib")
    arr.write_region((0, 0), labels)
    cs.fs.write(f"{cs.root}/{out_prefix}/{tile_name}/fields.geojson",
                json.dumps(geo).encode())
    return {"tile": tile_name, "fields": len(geo["features"])}


def run_segmentation_campaign(cs: ChunkStore, tile_names: Sequence[str],
                              cfg: ImageryConfig, out_prefix: str = "fields",
                              num_workers: Optional[int] = None,
                              engine_config: Optional[ClusterConfig] = None,
                              device: DeviceLike = None) -> Dict:
    """Tile-per-task §V.B campaign through the scatter/gather cluster engine.

    Mirrors the composite campaign's contract: each simulated node mounts
    the campaign bucket via its own Festivus instance over `cs`'s shared
    object store and metadata KV, pulls tile tasks from the worker-pull
    queue, and writes the label array and GeoJSON for its tile (idempotent,
    disjoint outputs, safe under lease-expiry re-delivery and straggler
    speculation).  The worker threads segment on ``device`` concurrently.
    Returns the summary dict plus the full :class:`ClusterReport` under
    ``"report"``.
    """
    config = campaign_config(num_workers, engine_config)
    dev = resolve_device(device)

    def handler(worker: Worker, tile_name: str):
        return segment_to_store(worker.chunkstore(cs.root), tile_name, cfg,
                                out_prefix, device=dev)

    engine = ClusterEngine(cs.fs.store, meta=cs.fs.meta, config=config)
    report = engine.run({t: t for t in tile_names}, handler)
    if not report.all_done:
        raise RuntimeError(
            f"segmentation campaign incomplete: {report.queue_stats} "
            f"dead={report.dead_tasks}")
    return {"tiles": len(tile_names), "stats": report.queue_stats,
            "report": report}
