"""The port's §V.A calibration against the JAX package, on the CPU.

The same numpy-seeded DN rasters go through ``repro.apps.calibration``
(numpy) and ``repro_torch.apps.calibration`` on CPU tensors or with
``device="cpu"``: the reflectance must match byte for byte, and a
campaign must leave the same bucket, key for key and byte for byte.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.apps import calibration as jcal
from repro.core import ChunkStore as JChunkStore
from repro.core import Festivus as JFestivus
from repro.core import FlakyObjectStore as JFlaky
from repro.core import InMemoryObjectStore as JStore
from repro.launch.cluster import ClusterConfig as JClusterConfig
from repro_torch.apps import calibration as pcal
from repro_torch.core import ChunkStore, Festivus, FlakyObjectStore
from repro_torch.core import InMemoryObjectStore
from repro_torch.launch import ClusterConfig


def _metas(gains, biases, elev, au):
    jm = jcal.SceneMeta("s", tuple(gains), tuple(biases), elev, au)
    return jm, pcal.SceneMeta(**dataclasses.asdict(jm))


@pytest.mark.parametrize("elev", [0.01, 30.0, 89.0])
@pytest.mark.parametrize("bands,seed", [(4, 0), (3, 1), (6, 2)])
def test_toa_reflectance_byte_identical(elev, bands, seed):
    rng = np.random.default_rng(seed)
    dn = rng.integers(0, 65536, size=(67, 45, bands)).astype(np.uint16)
    gains = rng.uniform(1e-5, 6e-5, size=bands)
    biases = rng.uniform(-0.3, 0.1, size=bands)
    jm, pm = _metas(gains, biases, elev, float(rng.uniform(0.98, 1.02)))
    want = jcal.toa_reflectance(dn, jm)
    got = pcal.toa_reflectance(torch.from_numpy(dn), pm).numpy()
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == dn.shape
    assert got.tobytes() == want.tobytes()
    # the draw reaches both clip bounds
    assert (want == 0.0).any() and (want == 1.5).any()


def test_toa_reflectance_low_sun_reaches_the_clamp():
    dn = np.full((4, 4, 2), 3, np.uint16)
    jm, pm = _metas((1e-6, 2e-6), (0.0, 1e-7), 0.01, 1.0)
    want = jcal.toa_reflectance(dn, jm)
    # sin(0.01 deg) < 1e-3: the divisor is the clamp, and nothing clips
    assert 0.0 < want.min() and want.max() < 1.5
    assert pcal.toa_reflectance(torch.from_numpy(dn), pm).numpy().tobytes() \
        == want.tobytes()


def test_toa_reflectance_keeps_tensors_on_their_device():
    dn = np.random.default_rng(3).integers(0, 40000, (8, 8, 4)).astype(
        np.uint16)
    jm, pm = _metas((2e-5,) * 4, (-0.1,) * 4, 45.0, 1.0)
    t = torch.from_numpy(dn.copy())
    got = pcal.toa_reflectance(t, pm)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.device == t.device and t.numpy().tobytes() == dn.tobytes()
    assert got.numpy().tobytes() == jcal.toa_reflectance(dn, jm).tobytes()


RECTS = [(2, 3, 7, 9), (0, 0, 10, 12), (9, 11, 10, 12), (4, 5, 5, 6),
         (0, 4, 10, 5), (3, 0, 4, 12)]


@pytest.mark.parametrize("rect", RECTS + [None],
                         ids=[str(r) for r in RECTS] + ["all_fill"])
@pytest.mark.parametrize("fill", [0, 7])
def test_valid_bounding_rect_matches_jax(rect, fill):
    dn = np.full((10, 12, 3), fill, np.uint16)
    if rect is not None:
        y0, x0, y1, x1 = rect
        dn[y0:y1, x0:x1, 1] = fill + 100
        # only the corners of the rectangle: it is a bounding box
        dn[y0 + 1:y1 - 1, x0 + 1:x1 - 1] = fill
    want = jcal.valid_bounding_rect(dn, fill)
    got = pcal.valid_bounding_rect(torch.from_numpy(dn), fill)
    assert got == want == (rect or (0, 0, 0, 0))


@pytest.mark.parametrize("erode_px", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["random", "full", "border_band"])
def test_clean_edges_matches_jax(erode_px, kind):
    rng = np.random.default_rng(erode_px)
    if kind == "random":
        valid = rng.random((23, 31)) > 0.2
    elif kind == "full":
        valid = np.ones((23, 31), bool)  # touches every border
    else:
        valid = np.zeros((23, 31), bool)
        valid[:, :6] = True  # a band along the left border
        valid[-4:] = True  # and along the bottom
    img = np.zeros(valid.shape + (4,), np.uint16)
    want = jcal.clean_edges(img, valid, erode_px)
    got = pcal.clean_edges(torch.from_numpy(img), torch.from_numpy(valid),
                           erode_px).numpy()
    assert got.dtype == want.dtype == np.bool_
    assert got.tobytes() == want.tobytes()
    if erode_px == 0:
        assert got.tobytes() == valid.tobytes()


def _bucket(store, prefix):
    return {k: bytes(store.get(k)) for k in sorted(store.list(prefix))}


def _scenes(cs, cal, keys, px, seed0):
    for i, k in enumerate(keys):
        cal.make_raw_scene(cs, k, px, px, seed=seed0 + i)


def test_make_raw_scene_writes_the_same_bytes():
    jstore, pstore = JStore(), InMemoryObjectStore()
    jm = jcal.make_raw_scene(JChunkStore(JFestivus(jstore), "raw"), "s", 40,
                             56, bands=4, seed=3)
    pm = pcal.make_raw_scene(ChunkStore(Festivus(pstore), "raw"), "s", 40, 56,
                             bands=4, seed=3)
    assert dataclasses.asdict(pm) == dataclasses.asdict(jm)
    assert _bucket(pstore, "raw/") == _bucket(jstore, "raw/") != {}


@pytest.mark.parametrize("tile_px", [48, 64, 17])
def test_process_scene_bucket_byte_identical(tile_px):
    jstore, pstore = JStore(), InMemoryObjectStore()
    jcs = JChunkStore(JFestivus(jstore), "raw")
    pcs = ChunkStore(Festivus(pstore), "raw")
    keys = [f"scenes/s{i}" for i in range(2)]
    _scenes(jcs, jcal, keys, 96, 10)
    _scenes(pcs, pcal, keys, 96, 10)
    jout = JChunkStore(jcs.fs, "out")
    pout = ChunkStore(pcs.fs, "out")
    for k in keys:
        want = jcal.process_scene(jcs, jout, k, tile_px=tile_px)
        got = pcal.process_scene(pcs, pout, k, tile_px=tile_px, device="cpu")
        assert got == want and got["tiles"] > 0
    assert _bucket(pstore, "out/") == _bucket(jstore, "out/") != {}


def test_process_scene_all_fill_writes_nothing():
    store = InMemoryObjectStore()
    cs = ChunkStore(Festivus(store), "raw")
    arr = cs.create("scenes/empty/dn", (32, 32, 4), np.uint16, (32, 32, 4),
                    codec="zlib")
    arr.write_region((0, 0, 0), np.zeros((32, 32, 4), np.uint16))
    meta = pcal.SceneMeta("empty", (2e-5,) * 4, (-0.1,) * 4, 40.0, 1.0)
    cs.fs.write("raw/scenes/empty/meta.json", meta.to_json().encode())
    out = pcal.process_scene(cs, ChunkStore(cs.fs, "out"), "scenes/empty",
                             device="cpu")
    assert out == {"scene": "scenes/empty", "tiles": 0, "rect": [0, 0, 0, 0]}
    assert store.list("out/") == []


def test_process_scene_reports_its_stages():
    cs = ChunkStore(Festivus(InMemoryObjectStore()), "raw")
    pcal.make_raw_scene(cs, "s", 64, 64, seed=1)
    timings = {}
    pcal.process_scene(cs, ChunkStore(cs.fs, "out"), "s", tile_px=32,
                       device="cpu", timings=timings)
    assert set(timings) == {"read_decode", "host_to_device", "device_ops",
                            "device_to_host", "tile_encode_put"}
    assert all(v >= 0.0 for v in timings.values())


def test_campaign_byte_identical_to_jax():
    """tests/test_apps.py's 96 px campaign, three scenes, tile_px 48."""
    keys = [f"scenes/s{i}" for i in range(3)]
    jstore, pstore = JStore(), InMemoryObjectStore()
    jcs = JChunkStore(JFestivus(jstore), "bucket")
    pcs = ChunkStore(Festivus(pstore), "bucket")
    _scenes(jcs, jcal, keys, 96, 10)
    _scenes(pcs, pcal, keys, 96, 10)
    want = jcal.run_campaign(jcs, jcs, keys, num_workers=3, tile_px=48)
    got = pcal.run_campaign(pcs, pcs, keys, num_workers=3, tile_px=48,
                            device="cpu")
    assert got["report"].all_done and got["scenes"] == 3
    assert got["results"] == want["results"]
    assert _bucket(pstore, "bucket/") == _bucket(jstore, "bucket/")

    # and the port's campaign equals the port's single-process path
    ref_cs = ChunkStore(pcs.fs, "ref_out")
    for k in keys:
        pcal.process_scene(pcs, ref_cs, k, tile_px=48, device="cpu")
    ref = _bucket(pstore, "ref_out/")
    tiles = {k.removeprefix("ref_out/"): v for k, v in ref.items()}
    assert tiles and all(_bucket(pstore, f"bucket/{k}") == {f"bucket/{k}": v}
                         for k, v in tiles.items())


def test_campaign_over_flaky_store_byte_identical_to_jax():
    """tests/test_apps.py's 64 px scenes over a store failing half its
    operations."""
    keys = ["scenes/s0", "scenes/s1"]

    def run(cal, store_cls, festivus, chunkstore, flaky_cls, **kw):
        inner = store_cls()
        cs_in = chunkstore(festivus(inner), "raw")
        _scenes(cs_in, cal, keys, 64, 0)
        flaky = flaky_cls(inner, failure_rate=0.5, seed=0)
        cs = chunkstore(festivus(flaky, meta=cs_in.fs.meta), "raw")
        out = cal.run_campaign(cs, cs, keys, num_workers=2, **kw)
        return inner, flaky, out

    jinner, jflaky, want = run(jcal, JStore, JFestivus, JChunkStore, JFlaky)
    pinner, pflaky, got = run(pcal, InMemoryObjectStore, Festivus,
                              ChunkStore, FlakyObjectStore, device="cpu")
    assert got["scenes"] == 2 and pflaky.injected_failures > 0
    assert got["results"] == want["results"]
    assert _bucket(pinner, "raw/") == _bucket(jinner, "raw/")


def test_campaign_through_virtual_time_engine_byte_identical_to_jax():
    keys = [f"scenes/v{i}" for i in range(2)]
    jstore, pstore = JStore(), InMemoryObjectStore()
    jcs = JChunkStore(JFestivus(jstore), "bucket")
    pcs = ChunkStore(Festivus(pstore), "bucket")
    _scenes(jcs, jcal, keys, 64, 20)
    _scenes(pcs, pcal, keys, 64, 20)
    want = jcal.run_campaign(
        jcs, jcs, keys, tile_px=32,
        engine_config=JClusterConfig(nodes=2, virtual_time=True))
    got = pcal.run_campaign(
        pcs, pcs, keys, tile_px=32,
        engine_config=ClusterConfig(nodes=2, virtual_time=True),
        device="cpu")
    assert got["report"].all_done and got["report"].makespan_s > 0
    assert got["results"] == want["results"]
    assert _bucket(pstore, "bucket/") == _bucket(jstore, "bucket/")


def test_campaign_rejects_split_stores():
    a = ChunkStore(Festivus(InMemoryObjectStore()), "raw")
    b = ChunkStore(Festivus(InMemoryObjectStore()), "raw")
    with pytest.raises(ValueError):
        pcal.run_campaign(a, b, ["scenes/s0"], device="cpu")
