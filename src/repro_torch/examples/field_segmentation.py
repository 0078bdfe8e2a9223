"""§V.B end-to-end: field segmentation of a (miniature) Kherson-style tile.

Counterpart of ``examples/field_segmentation.py``.  The full chain on a
synthetic multi-temporal stack: cloud mask -> masked temporal gradient
accumulation (the hand-written ``grad_mag`` kernel on the card, checked
against its plain PyTorch version) -> threshold -> morphology -> connected
components -> GeoJSON, plus accuracy against the generator's ground-truth
field map.

    PYTHONPATH=src python -m repro_torch.examples.field_segmentation [--device cpu]
"""

import json

import numpy as np

from repro_torch.apps import segmentation
from repro_torch.configs.festivus_imagery import SMOKE as IMG_CFG
from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore
from repro_torch.data import imagery
from repro_torch.examples import device_arg
from repro_torch.kernels.backend import DeviceLike, resolve_device


def main(device: DeviceLike = None):
    dev = resolve_device(device)
    store = InMemoryObjectStore()
    cs = ChunkStore(Festivus(store), "bucket")
    spec = imagery.SceneSpec(tile_px=96, temporal_depth=10, num_fields=12,
                             cloud_cover=0.35, seed=7)
    imagery.write_scene_stack(cs, "tiles/kherson-mini", spec, chunk_px=32)
    imgs, valid = imagery.read_scene_stack(cs, "tiles/kherson-mini")
    print(f"[1] stack {imgs.shape}, valid fraction "
          f"{valid.mean():.2f} (clouds removed per scene)")

    # kernel path (the plain version on the CPU) vs plain cross-check
    edges_kernel = segmentation.temporal_edges(imgs, valid, IMG_CFG,
                                               impl="auto", device=dev)
    edges_plain = segmentation.temporal_edges(imgs, valid, IMG_CFG,
                                              impl="ref", device=dev)
    assert (edges_kernel == edges_plain).mean() > 0.999
    print(f"[2] temporal edges on {dev}: kernel == plain version "
          f"({edges_kernel.mean():.1%} of pixels are edges)")

    labels, geo = segmentation.segment_tile(imgs, valid, IMG_CFG, device=dev)
    truth = imagery.field_labels(spec)
    found = len(geo["features"])
    print(f"[3] fields found: {found} (ground truth {spec.num_fields})")

    # the same chain as a fleet campaign: 2 simulated nodes, each its own
    # festivus mount over the shared store, pulling tile tasks — and the
    # cluster's labels byte-match this process's own segmentation
    out = segmentation.run_segmentation_campaign(
        cs, ["tiles/kherson-mini"], IMG_CFG, num_workers=2, device=dev)
    report = out["report"]
    stored = cs.open("fields/tiles/kherson-mini/labels").read_all()
    assert stored.tobytes() == labels.tobytes()
    print(f"[3b] campaign on {report.nodes} nodes wrote byte-identical "
          f"labels; queue: {out['stats']}")

    # per-field purity: majority-truth-label fraction inside each found field
    purities = []
    for feat in geo["features"]:
        fid = feat["properties"]["field_id"]
        mask = labels == fid
        if mask.sum() < 8:
            continue
        vals, counts = np.unique(truth[mask], return_counts=True)
        purities.append(counts.max() / counts.sum())
    print(f"[4] mean field purity vs ground truth: {np.mean(purities):.2f}")
    assert np.mean(purities) > 0.8
    print(json.dumps(geo["features"][0], indent=1)[:400])
    print("FIELD_SEGMENTATION_OK")


if __name__ == "__main__":
    main(device_arg(__doc__))
