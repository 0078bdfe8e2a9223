"""Synthetic Landsat-like scenes: the imagery data plane for the paper apps.

Deterministic generator of multi-temporal, multi-band tiles with the three
structures the paper's applications key on:

* **fields** — a static piecewise-constant reflectance mosaic (seeded
  Voronoi partition), so field-boundary edges persist in time (§V.B:
  "the edges we care about have the property of being persistent in time");
* **clouds** — per-timestep smooth blobs that occlude pixels (drives the
  cloud mask, the composite weighting, and the valid-data bookkeeping);
* **seasonality** — a per-timestep verdancy scalar modulating the NIR band
  (drives the composite's verdant-pixel weighting).

Bands: 0=red, 1=nir, 2=green, 3=blue, reflectance in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.chunkstore import ChunkStore


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    tile_px: int = 96
    bands: int = 4
    temporal_depth: int = 8
    num_fields: int = 12
    cloud_cover: float = 0.3
    seed: int = 0


def field_labels(spec: SceneSpec) -> np.ndarray:
    """Seeded Voronoi partition: ground-truth field map [H, W] int32."""
    rng = np.random.default_rng(spec.seed)
    h = w = spec.tile_px
    pts = rng.uniform(0, h, size=(spec.num_fields, 2))
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = ((yy[None] - pts[:, 0, None, None]) ** 2
          + (xx[None] - pts[:, 1, None, None]) ** 2)
    return np.argmin(d2, axis=0).astype(np.int32)


def cloud_field(spec: SceneSpec, t: int) -> np.ndarray:
    """Smooth cloud-probability field [H, W] in [0, 1] for timestep t."""
    rng = np.random.default_rng(spec.seed * 7919 + t)
    h = w = spec.tile_px
    field = np.zeros((h, w))
    yy, xx = np.mgrid[0:h, 0:w]
    n_blobs = rng.poisson(3)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(h / 12, h / 3, size=2)
        field += np.exp(-(((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2))
    field = field / max(1e-9, field.max()) if field.max() > 0 else field
    # scale so the expected covered fraction tracks spec.cloud_cover
    return np.clip(field * spec.cloud_cover * 3.0, 0.0, 1.0)


def scene(spec: SceneSpec, t: int) -> Tuple[np.ndarray, np.ndarray]:
    """One timestep: (image [H, W, C] f32, valid [H, W] bool)."""
    rng = np.random.default_rng(spec.seed * 104729 + t)
    labels = field_labels(spec)
    frng = np.random.default_rng(spec.seed + 1)
    base = frng.uniform(0.05, 0.45, size=(spec.num_fields, spec.bands))
    img = base[labels]  # [H, W, C]

    # seasonality: verdant fields swing NIR
    season = 0.5 + 0.5 * np.sin(2 * np.pi * t / max(2, spec.temporal_depth))
    img[..., 1] = np.clip(img[..., 1] * (0.6 + 0.8 * season), 0, 1)

    img += rng.normal(0, 0.01, size=img.shape)  # sensor noise

    cloud = cloud_field(spec, t)
    cloudy = cloud > 0.5
    # clouds are bright and flat in all bands
    img = np.where(cloudy[..., None],
                   0.7 + rng.normal(0, 0.02, size=img.shape), img)
    valid = ~cloudy
    return np.clip(img, 0, 1).astype(np.float32), valid


def scene_stack(spec: SceneSpec) -> Tuple[np.ndarray, np.ndarray]:
    """All timesteps: (images [T, H, W, C], valid [T, H, W])."""
    imgs, valids = zip(*(scene(spec, t) for t in range(spec.temporal_depth)))
    return np.stack(imgs), np.stack(valids)


def write_scene_stack(cs: ChunkStore, name: str, spec: SceneSpec,
                      chunk_px: int = 32) -> None:
    """Store a tile's temporal stack as chunked arrays (1 timestep x
    chunk_px x chunk_px x bands chunks ~ the 4 MiB lesson at full scale)."""
    imgs, valid = scene_stack(spec)
    a = cs.create(f"{name}/images", imgs.shape, np.float32,
                  (1, chunk_px, chunk_px, spec.bands), codec="zlib")
    a.write_region((0, 0, 0, 0), imgs)
    v = cs.create(f"{name}/valid", valid.shape, np.uint8,
                  (1, chunk_px, chunk_px), codec="zlib")
    v.write_region((0, 0, 0), valid.astype(np.uint8))


def read_scene_stack(cs: ChunkStore, name: str):
    imgs = cs.open(f"{name}/images").read_all()
    valid = cs.open(f"{name}/valid").read_all().astype(bool)
    return imgs, valid
