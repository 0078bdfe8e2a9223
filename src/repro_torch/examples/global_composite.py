"""§V.C end-to-end: a (miniature) global cloud-free composite campaign.

Counterpart of ``examples/global_composite.py``.  Decomposes a latitude
band into UTM tiles, synthesizes a temporal stack per tile, then runs the
weighted composite through the scatter/gather cluster engine: three
simulated nodes, each with its own festivus mount over the shared (and
deliberately flaky — pre-emptible-cloud realism) object store, pulling
tile tasks from the worker-pull queue, each compositing on the card with
the ``composite`` kernel.  The cluster output is cross-checked byte for
byte against the single-process path, and a Web-Mercator-style overview is
served from the multi-resolution pyramid.

    PYTHONPATH=src python -m repro_torch.examples.global_composite [--device cpu]
"""

from repro_torch.apps.composite import composite_tile, run_composite_campaign
from repro_torch.configs.festivus_imagery import SMOKE as IMG_CFG
from repro_torch.core import (ChunkStore, Festivus, FlakyObjectStore,
                              InMemoryObjectStore)
from repro_torch.core.tiling import UTMGridSpec, zone_tiles
from repro_torch.data import imagery
from repro_torch.examples import device_arg
from repro_torch.kernels.backend import DeviceLike, resolve_device


def main(device: DeviceLike = None):
    dev = resolve_device(device)
    inner = InMemoryObjectStore()
    flaky = FlakyObjectStore(inner, failure_rate=0.02, seed=7)
    cs = ChunkStore(Festivus(flaky), "bucket")

    # 1. domain decomposition: tiles covering a narrow equatorial band
    spec = UTMGridSpec(tile_px=IMG_CFG.composite_tile_px, border_px=0,
                       resolution_m=30000.0)  # coarse: few tiles per zone
    tiles = [t for z in (31, 32) for t in zone_tiles(z, spec, (-2.0, 2.0))]
    print(f"[1] decomposed into {len(tiles)} UTM tiles: "
          f"{[t.key() for t in tiles][:4]} ...")

    # 2. synthesize per-tile temporal stacks (the data plane)
    names = []
    for i, tile in enumerate(tiles):
        name = f"stacks/{tile.key()}"
        imagery.write_scene_stack(
            cs, name, imagery.SceneSpec(tile_px=IMG_CFG.composite_tile_px,
                                        temporal_depth=IMG_CFG.temporal_depth,
                                        seed=100 + i),
            chunk_px=IMG_CFG.chunk_px)
        names.append(name)
    print(f"[2] wrote {len(names)} stacks "
          f"({inner.stats.bytes_written / 1e6:.1f} MB)")

    # 3. the campaign: 3 simulated nodes, each its own mount, shared queue
    out = run_composite_campaign(cs, names, IMG_CFG, num_workers=3,
                                 device=dev)
    report = out["report"]
    per_node = {r.worker: r.tasks_completed for r in report.per_worker}
    print(f"[3] campaign done on {report.nodes} nodes ({dev}); queue: "
          f"{out['stats']}; work split {per_node}; fleet read "
          f"{report.bytes_read / 1e6:.1f} MB; "
          f"transient store failures absorbed by VFS retries: "
          f"{report.festivus_stats.retried_ops} "
          f"(injected: {flaky.injected_failures})")

    # 4. byte-identical cross-check against the single-process path
    for n in names:
        imgs, _ = imagery.read_scene_stack(cs, n)
        ref = composite_tile(imgs, IMG_CFG, device=dev)
        got = cs.open(f"composite/{n}").read_all()
        assert got.tobytes() == ref.tobytes(), f"cluster output diverges on {n}"
    print(f"[4] cluster output byte-identical to single-process path "
          f"on all {len(names)} tiles")

    # 5. serve an overview from the pyramid (Mapserver-over-festivus role)
    overview = [cs.open(f"composite/{n}").read_level(2) for n in names[:2]]
    print(f"[5] pyramid overviews: {[o.shape for o in overview]}")
    print("GLOBAL_COMPOSITE_OK")


if __name__ == "__main__":
    main(device_arg(__doc__))
