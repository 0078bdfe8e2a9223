"""§V.D end-to-end: serve the global composite as map tiles under a spike.

Counterpart of ``examples/tile_server.py``.  Builds a (miniature) global
composite through the scatter/gather cluster engine, compositing on the
card with the ``composite`` kernel — exactly
``repro_torch.examples.global_composite``'s campaign — then stands up a
``repro_torch.serve.TileFleet`` over the resulting chunkstore pyramid and
drives it with a Zipf request trace containing a load spike, in virtual
time:

* requests arrive at their trace timestamps and queue for N simulated
  tile servers, each with its own festivus mount and LRU tile cache;
* every cache miss becomes modeled object I/O water-filled against the
  same simulated zone fabric the batch campaigns use;
* the serving report carries the SLO numbers (hit rate, p50/p99 virtual
  latency) plus a byte-identity check against direct pyramid reads.

    PYTHONPATH=src python -m repro_torch.examples.tile_server [--device cpu]
"""

from repro_torch.apps.composite import run_composite_campaign
from repro_torch.configs.festivus_imagery import SMOKE as IMG_CFG
from repro_torch.core import (ChunkStore, Festivus, InMemoryObjectStore,
                              MetadataStore)
from repro_torch.data import imagery
from repro_torch.examples import device_arg
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.serve import (
    Spike,
    TileFleet,
    TileRequest,
    TileServer,
    tile_universe,
    zipf_spike_trace,
)


def main(device: DeviceLike = None):
    dev = resolve_device(device)
    inner = InMemoryObjectStore()
    meta = MetadataStore()
    cs = ChunkStore(Festivus(inner, meta=meta), "bucket")

    # 1. the batch side: synthesize stacks, run the composite campaign
    names = []
    for i in range(3):
        name = f"stacks/t{i}"
        imagery.write_scene_stack(
            cs, name, imagery.SceneSpec(tile_px=IMG_CFG.composite_tile_px,
                                        temporal_depth=IMG_CFG.temporal_depth,
                                        seed=100 + i),
            chunk_px=IMG_CFG.chunk_px)
        names.append(name)
    out = run_composite_campaign(cs, names, IMG_CFG, num_workers=3,
                                 device=dev)
    print(f"[1] composite campaign done on {out['report'].nodes} nodes "
          f"({dev}); queue: {out['stats']}")

    # 2. the serving side: XYZ requests over the composite pyramid
    target = f"composite/{names[0]}"
    arr = cs.open(target)
    tile_px = max(8, IMG_CFG.composite_tile_px // 4)
    universe = tile_universe(arr.spec.shape, arr.spec.pyramid_levels,
                             tile_px, array=target)
    spike = Spike(1.0, 1.6, 6.0)
    trace = zipf_spike_trace(universe, duration_s=3.0, base_rps=60.0,
                             alpha=1.1, spikes=(spike,), seed=11)
    print(f"[2] {len(universe)} addressable tiles across levels "
          f"0..{arr.spec.pyramid_levels}; trace: {len(trace)} requests, "
          f"spike x{spike.multiplier} over [{spike.t0}, {spike.t1})")

    # 3. run the fleet in virtual time on the shared store + metadata KV
    fleet = TileFleet(inner, meta, root="bucket", servers=2, tile_px=tile_px,
                      cache_bytes=2 * 1024 * 1024)
    rep = fleet.run(trace)
    assert rep.all_served
    print(f"[3] served {rep.requests} requests on {rep.servers} servers: "
          f"hit rate {rep.hit_rate:.1%} ({rep.cache_evictions} evictions), "
          f"p50 {rep.p50_s * 1e3:.2f} ms, p99 {rep.p99_s * 1e3:.2f} ms, "
          f"spike-window p99 "
          f"{rep.window_percentile(99, spike.t0, spike.t1 + 0.2) * 1e3:.2f} ms "
          f"(virtual time)")

    # 4. tiles byte-identical to direct pyramid reads
    srv = TileServer(cs, tile_px=tile_px, cache_bytes=1024 * 1024)
    for level in range(arr.spec.pyramid_levels + 1):
        got = srv.serve(TileRequest(0.0, level, 0, 0, array=target)).data
        ref = arr.read((0, 0, 0), got.shape, level=level)
        assert got.tobytes() == ref.tobytes(), f"tile mismatch at level {level}"
    print(f"[4] tiles byte-identical to direct pyramid reads at all "
          f"{arr.spec.pyramid_levels + 1} levels")
    print("TILE_SERVER_OK")


if __name__ == "__main__":
    main(device_arg(__doc__))
