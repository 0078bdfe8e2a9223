"""Cloud-free composite (paper §V.C), tile-parallel over the task queue.

"The output is a weighted average of this imagery, with higher weight given
to cloud-free, verdant input images. ... The work was easily parallelized by
dividing the earth's surface into 43k square tiles; each tile was processed
independently."

Counterpart of ``repro/apps/composite.py``.  A tile's stack is copied to
the device once; the cloud score and the weights are plain tensor ops there
(the JAX package computes both outside its kernel too), and the reduction
is the hand-written ``composite`` kernel.  The campaign runs on the
port's copy of the scatter/gather cluster engine: each simulated node
mounts the campaign bucket through its own Festivus over the shared store
and metadata KV, and its worker thread runs tiles on the card.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.festivus_imagery import ImageryConfig
from repro_torch.convert import stack_to_device
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.data import imagery
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.launch.cluster import (
    ClusterConfig,
    ClusterEngine,
    Worker,
    campaign_config,
)


def cloud_score(images: torch.Tensor, cfg: ImageryConfig) -> torch.Tensor:
    """Simple reflectance cloud mask ([12] Oreopoulos et al. in the paper):
    clouds are bright and spectrally flat.  images [T, H, W, C] -> [T, H, W]
    score in [0, 1]."""
    brightness = images[..., :3].mean(dim=-1)
    flatness = 1.0 - (images[..., 0] - images[..., 2]).abs()
    score = ((brightness - cfg.cloud_reflectance_threshold) * 4.0).clamp(
        0.0, 1.0)
    return score * flatness.clamp(0.0, 1.0)


def composite_tile(images: np.ndarray, cfg: ImageryConfig,
                   impl: str = "auto", device: DeviceLike = None
                   ) -> np.ndarray:
    """One tile: [T, H, W, C] numpy stack -> [H, W, C] numpy composite.
    Runs on the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    imgs, _ = stack_to_device(images, None, dev)
    weights = kref.composite_weights(cloud_score(imgs, cfg),
                                     nir=imgs[..., 1], red=imgs[..., 0])
    out = kops.composite(imgs, weights, impl=impl)
    return out.cpu().numpy()


def run_composite_campaign(cs: ChunkStore, tile_names: Sequence[str],
                           cfg: ImageryConfig, out_prefix: str = "composite",
                           num_workers: Optional[int] = None,
                           engine_config: Optional[ClusterConfig] = None,
                           device: DeviceLike = None) -> Dict:
    """Tile-per-task campaign through the scatter/gather cluster engine.

    Each simulated node (`num_workers` of them, default 4; or
    `engine_config.nodes` when a full config is supplied — passing both
    inconsistently raises) mounts the campaign bucket via its own Festivus
    instance over `cs`'s shared object store and metadata KV, so the
    caller's mount sees every output the fleet writes.  The worker threads
    call :func:`composite_tile` on ``device`` concurrently.  Returns the
    summary dict plus the full :class:`ClusterReport` under ``"report"``.
    """
    config = campaign_config(num_workers, engine_config)
    dev = resolve_device(device)

    def handler(worker: Worker, tile_name: str):
        wcs = worker.chunkstore(cs.root)
        imgs, _ = imagery.read_scene_stack(wcs, tile_name)
        comp = composite_tile(imgs, cfg, device=dev)
        arr = wcs.create(f"{out_prefix}/{tile_name}", comp.shape, comp.dtype,
                         (min(cfg.chunk_px, comp.shape[0]),
                          min(cfg.chunk_px, comp.shape[1]), comp.shape[2]),
                         codec="zlib", pyramid_levels=2)
        arr.write_region((0, 0, 0), comp)
        arr.build_pyramid()  # the JPX multi-resolution serving layer
        return {"tile": tile_name, "mean": float(comp.mean())}

    engine = ClusterEngine(cs.fs.store, meta=cs.fs.meta, config=config)
    report = engine.run({t: t for t in tile_names}, handler)
    if not report.all_done:
        raise RuntimeError(
            f"composite campaign incomplete: {report.queue_stats} "
            f"dead={report.dead_tasks}")
    return {"tiles": len(tile_names), "stats": report.queue_stats,
            "report": report}
