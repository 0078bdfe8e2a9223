"""The port's serving tier, ingest wheel and examples against the JAX
package, on the CPU.

``repro_torch.serve`` and ``repro_torch.ingest`` are copies of the JAX
package's modules with the import prefix changed: the same scenario, on the
same bytes, must give the same report field by field (virtual time from
the DES, so every float is compared exactly; only the simulator's own
wall-clock cost is left out).  The port's tile server serves a pyramid the
JAX package wrote, byte for byte, and each port example runs on the CPU to
its marker.
"""

import dataclasses
import enum
import math
from pathlib import Path

import numpy as np
import pytest

import repro.core as jcore
import repro.ingest as jingest
import repro.serve as jserve
import repro_torch.core as pcore
import repro_torch.ingest as pingest
import repro_torch.serve as pserve
from repro.configs import regions as jregions
from repro_torch.configs import regions as pregions
from repro_torch.examples import (field_segmentation, global_composite,
                                  tile_server)

KiB = 1024
MiB = 1024 * 1024
ROOT = "bucket"
SRC = Path(__file__).resolve().parents[1] / "src"
COPIES = [f"{pkg}/{name}" for pkg in ("serve", "ingest")
          for name in sorted(p.name for p in (SRC / "repro" / pkg).glob("*.py"))]
#: the simulator's cost of simulating (host seconds), not a result
WALL_CLOCK_KEYS = {"wall_s", "events_per_s"}

SIDES = {"jax": (jcore, jserve, jingest, jregions),
         "port": (pcore, pserve, pingest, pregions)}


@pytest.mark.parametrize("path", COPIES)
def test_copy_differs_from_the_jax_module_only_in_the_prefix(path):
    jax_side = (SRC / "repro" / path).read_text()
    port = (SRC / "repro_torch" / path).read_text()
    assert port == jax_side.replace("repro.", "repro_torch.")


def _plain(x):
    """A report as plain data: dataclasses and objects by their fields,
    NaN as a string, enum members by name; wall-clock keys dropped."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{f.name: _plain(getattr(x, f.name))
                   for f in dataclasses.fields(x)
                   if f.name not in WALL_CLOCK_KEYS}}
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()
                if k not in WALL_CLOCK_KEYS}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, float) and math.isnan(x):
        return "nan"
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (int, float, str, bool, type(None), np.generic)):
        return x
    return {"__type__": type(x).__name__, **_plain(vars(x))}


def _world(core, shape, chunk, levels, seed=0, codec=None, array="composite"):
    inner = core.InMemoryObjectStore()
    meta = core.MetadataStore()
    cs = core.ChunkStore(core.Festivus(inner, meta=meta), ROOT)
    data = np.random.default_rng(seed).random(shape, dtype=np.float32)
    kw = {"codec": codec} if codec else {}
    arr = cs.create(array, data.shape, np.float32,
                    (chunk, chunk, shape[2]), pyramid_levels=levels, **kw)
    arr.write_region((0, 0, 0), data)
    arr.build_pyramid()
    cs.fs.close()
    return inner, meta


def _both(run):
    """run(core, serve, ingest, regions) on each side -> (jax, port)."""
    return run(*SIDES["jax"]), run(*SIDES["port"])


@pytest.mark.parametrize("cache_bytes", [2 * MiB, 8 * KiB])
def test_tile_fleet_on_the_example_trace_matches_jax(cache_bytes):
    """examples/tile_server.py's serving step: a 64 px, 4-band composite
    pyramid (two levels, 32 px zlib chunks), 16 px tiles, a 3 s Zipf trace
    with a x6 spike, two servers."""
    target = "composite/stacks/t0"

    def run(core, serve, ingest, regions):
        inner, meta = _world(core, (64, 64, 4), 32, 2, seed=100,
                             codec="zlib", array=target)
        universe = serve.tile_universe((64, 64, 4), 2, 16, array=target)
        spike = serve.Spike(1.0, 1.6, 6.0)
        trace = serve.zipf_spike_trace(universe, duration_s=3.0,
                                       base_rps=60.0, alpha=1.1,
                                       spikes=(spike,), seed=11)
        fleet = serve.TileFleet(inner, meta, root=ROOT, servers=2,
                                tile_px=16, cache_bytes=cache_bytes)
        rep = fleet.run(trace)
        return trace, rep, rep.window_percentile(99, spike.t0, spike.t1 + 0.2)

    (jtrace, want, jspike), (ptrace, got, pspike) = _both(run)
    assert _plain(ptrace) == _plain(jtrace)
    assert got.all_served and got.requests == len(ptrace) > 100
    for field in ("requests", "hit_rate", "cache_evictions", "p50_s",
                  "p99_s"):
        assert getattr(got, field) == getattr(want, field), field
    assert pspike == jspike
    assert _plain(got) == _plain(want)
    if cache_bytes < MiB:
        assert got.cache_evictions > 0


def test_autoscaled_spike_matches_jax():
    """tests/test_autoscale.py's saturating spike: 80 rps x70 for 0.6 s on
    a 4-server base fleet that may grow to 10."""

    def run(core, serve, ingest, regions):
        inner, meta = _world(core, (256, 256, 3), 64, 2)
        uni = serve.tile_universe((256, 256, 3), 2, 64)
        spike = serve.Spike(1.0, 1.6, 70.0)
        trace = serve.zipf_spike_trace(uni, 3.0, 80.0, alpha=0.7,
                                       spikes=(spike,), seed=11)
        policy = serve.AutoscalePolicy(
            min_servers=1, max_servers=10, target_p99_s=0.03,
            scale_in_p99_s=0.005, window_s=0.1, interval_s=0.02,
            scale_out_step=4, scale_in_step=3, warmup_s=0.05,
            cooldown_s=0.08)
        fleet = serve.TileFleet(inner, meta, root=ROOT, servers=4,
                                tile_px=64, cache_bytes=48 * KiB,
                                autoscale=policy)
        return fleet.run(trace)

    want, got = _both(run)
    assert got.all_served and got.autoscale.joins
    assert ([(a.t, a.delta, a.reason) for a in got.autoscale.actions]
            == [(a.t, a.delta, a.reason) for a in want.autoscale.actions])
    assert got.serve_worker_seconds == want.serve_worker_seconds
    assert _plain(got) == _plain(want)


def test_geo_demand_k_fleet_matches_jax():
    """tests/test_geo_serving.py's tiny world under demand-k replication:
    two servers in every region, promotion after two reads."""

    def run(core, serve, ingest, regions):
        inner, meta = _world(core, (256, 256, 1), 64, 2)
        universes = serve.continental_universes((256, 256, 1), 2, 64,
                                                regions.REGIONS)
        trace = serve.geo_trace(universes, 0.5, 200.0, alpha=1.1, seed=3)
        fleet = serve.GeoTileFleet(
            inner, meta, root=ROOT, tile_px=64, cache_bytes=2 * 16 * KiB,
            servers_by_region={r: 2 for r in regions.REGIONS},
            placement="demand_k", k=4, promote_after=2)
        return fleet.run(trace)

    want, got = _both(run)
    assert got.all_served and got.promotions > 0
    for field in ("p99_s", "cost_usd", "remote_reads", "egress_bytes",
                  "replication_usd"):
        assert getattr(got, field) == getattr(want, field), field
    assert _plain(got) == _plain(want)


def test_ingest_wheel_matches_jax():
    """The wheel on a 128 px world: eight scene batches and a tick every
    half second under a Zipf trace, with two ingest nodes."""
    shape, chunks = (128, 128, 3), (32, 32, 3)

    def run(core, serve, ingest, regions):
        inner, meta = _world(core, shape, 32, 2)
        uni = serve.tile_universe(shape, 2, 32)
        trace = serve.zipf_spike_trace(uni, 3.0, 100.0, alpha=1.0, seed=4)
        tasks, scenes, ticks = ingest.wheel_campaign(
            shape, chunks, 3.0, 8, period_s=0.5, seed=11)
        fleet = serve.TileFleet(inner, meta, root=ROOT, servers=2,
                                tile_px=32, cache_bytes=64 * KiB)
        rep = fleet.run(trace, ingest_tasks=tasks,
                        ingest_handler=ingest.make_wheel_handler(ROOT),
                        ingest_nodes=2)
        return (scenes, ticks), rep, ingest.wheel_outcome(meta, ROOT)

    (jplan, want, jout), (pplan, got, pout) = _both(run)
    assert _plain(pplan) == _plain(jplan)
    assert pout == jout
    assert pout["ingested"] == pout["wheeled"] == 8
    assert not pout["missing"] and not pout["spurious"]
    assert got.all_served and got.ingest["chunk_writes"] > 0
    assert _plain(got) == _plain(want)


def test_port_tile_server_serves_a_pyramid_the_jax_package_wrote(tmp_path):
    jstore = jcore.LocalDirObjectStore(str(tmp_path))
    jcs = jcore.ChunkStore(jcore.Festivus(jstore), ROOT)
    data = np.random.default_rng(5).random((96, 80, 4), dtype=np.float32)
    jarr = jcs.create("composite/a", data.shape, np.float32, (32, 32, 4),
                      codec="zlib", pyramid_levels=2)
    jarr.write_region((0, 0, 0), data)
    jarr.build_pyramid()

    fs = pcore.Festivus(pcore.LocalDirObjectStore(str(tmp_path)))
    assert fs.sync_metadata() > 0
    # which levels were built lives in the writer's metadata KV: carry it
    key = f"pyramid:{ROOT}/composite/a"
    for level, value in jcs.fs.meta.hgetall(key).items():
        fs.meta.hset(key, level, value)
    cs = pcore.ChunkStore(fs, ROOT)
    arr = cs.open("composite/a")
    srv = pserve.TileServer(cs, tile_px=16, cache_bytes=MiB)
    served = 0
    for level in range(3):
        for ty, tx in np.ndindex(*pserve.tile_grid(arr.level_shape(level),
                                                   16)):
            got = srv.serve(pserve.TileRequest(0.0, level, tx, ty,
                                               array="composite/a")).data
            start, stop = pserve.tile_bounds(arr.level_shape(level), 16,
                                             tx, ty)
            want = jarr.read(start, stop, level=level)
            assert got.tobytes() == want.tobytes(), (level, ty, tx)
            served += 1
    assert served > 3


@pytest.mark.parametrize("example,marker", [
    (global_composite, "GLOBAL_COMPOSITE_OK"),
    (field_segmentation, "FIELD_SEGMENTATION_OK"),
    (tile_server, "TILE_SERVER_OK"),
], ids=["global_composite", "field_segmentation", "tile_server"])
def test_port_example_runs_on_the_cpu(example, marker, capsys):
    example.main(device="cpu")
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == marker
    assert "cpu" in out
