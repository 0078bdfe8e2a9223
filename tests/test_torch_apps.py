"""The port's §V.C composite app and its copied substrate against the JAX
package, on the CPU.

The same numpy-seeded stacks go through ``repro.apps.composite`` (its jnp
oracle) and ``repro_torch.apps.composite`` with ``device="cpu"`` (its plain
PyTorch version).  The port's campaign must be byte-identical to the port's
own single-process path, and the copied cluster engine must reproduce the
JAX package's 64-node Table III point exactly.
"""

import numpy as np
import pytest

from repro.apps import composite as japp
from repro.configs.festivus_imagery import SMOKE as J_SMOKE
from repro.core import ChunkStore as JChunkStore
from repro.core import Festivus as JFestivus
from repro.core import FestivusConfig as JFestivusConfig
from repro.core import InMemoryObjectStore as JStore
from repro.core import perfmodel as jperf
from repro.core.metadata import MetadataStore as JMeta
from repro.data import imagery as jimagery
from repro.launch.cluster import ClusterConfig as JClusterConfig
from repro.launch.cluster import ClusterEngine as JClusterEngine
from repro_torch.apps import composite as papp
from repro_torch.configs.festivus_imagery import SMOKE
from repro_torch.core import ChunkStore, Festivus, FestivusConfig
from repro_torch.core import FlakyObjectStore, InMemoryObjectStore
from repro_torch.core import perfmodel
from repro_torch.core.metadata import MetadataStore
from repro_torch.data import imagery
from repro_torch.kernels import backend
from repro_torch.launch import ClusterConfig, ClusterEngine

MiB = 1024 * 1024
F32_TOL = dict(rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("temporal_depth", [4, 6])
@pytest.mark.parametrize("tile_px", [32, 64])
def test_composite_tile_matches_jax(tile_px, temporal_depth, seed):
    spec = jimagery.SceneSpec(tile_px=tile_px, temporal_depth=temporal_depth,
                              seed=seed)
    imgs, _ = jimagery.scene_stack(spec)
    want = japp.composite_tile(imgs, J_SMOKE, impl="ref")
    got = papp.composite_tile(imgs, SMOKE, device="cpu")
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == (tile_px, tile_px, 4)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # both packages synthesise the same bytes from the same seed
    pimgs, _ = imagery.scene_stack(imagery.SceneSpec(
        tile_px=tile_px, temporal_depth=temporal_depth, seed=seed))
    assert pimgs.tobytes() == imgs.tobytes()


def _write_stacks(cs, imagery_mod, n=3):
    names = []
    for i in range(n):
        name = f"stacks/t{i}"
        imagery_mod.write_scene_stack(
            cs, name, imagery_mod.SceneSpec(tile_px=32, temporal_depth=4,
                                            seed=i), chunk_px=16)
        names.append(name)
    return names


def test_campaign_identical_to_single_process_and_close_to_jax():
    flaky = FlakyObjectStore(InMemoryObjectStore(), failure_rate=0.02, seed=7)
    cs = ChunkStore(Festivus(flaky), "bucket")
    names = _write_stacks(cs, imagery)
    backend.reset_launch_counts()
    out = papp.run_composite_campaign(cs, names, SMOKE, num_workers=3,
                                      device="cpu")
    assert out["tiles"] == 3 and out["report"].all_done
    assert backend.launch_counts()["composite"] == 0  # CPU: plain version

    jcs = JChunkStore(JFestivus(JStore()), "bucket")
    _write_stacks(jcs, jimagery)
    japp.run_composite_campaign(jcs, names, J_SMOKE, num_workers=3)
    for n in names:
        imgs, _ = imagery.read_scene_stack(cs, n)
        single = papp.composite_tile(imgs, SMOKE, device="cpu")
        got = cs.open(f"composite/{n}").read_all()
        assert got.dtype == single.dtype and got.shape == single.shape
        assert got.tobytes() == single.tobytes()
        np.testing.assert_allclose(got, jcs.open(f"composite/{n}").read_all(),
                                   **F32_TOL)
        assert cs.open(f"composite/{n}").read_level(2).shape == (8, 8, 4)


def _table_iii_64_report(store_cls, meta_cls, fs_cls, fs_cfg_cls, cfg_cls,
                         engine_cls, fabric):
    """The 64-node Table III sweep point of tests/test_cluster.py."""
    task_bytes = 8 * MiB
    inner = store_cls()
    meta = meta_cls()
    inner.put("bucket/scan", b"\x5a" * (8 * task_bytes))
    writer = fs_cls(inner, meta=meta)
    writer.sync_metadata()
    writer.close()
    engine = engine_cls(inner, meta=meta, config=cfg_cls(
        nodes=64, vcpus=16, virtual_time=True, lease_s=3600.0,
        fabric=fabric,
        festivus=fs_cfg_cls(block_bytes=4 * MiB, readahead_blocks=0,
                            cache_bytes=0, max_inflight=2)))

    def handler(worker, offset):
        return len(worker.fs.read_view("bucket/scan", offset, task_bytes))

    tasks = {f"scan{i}": (i % 8) * task_bytes for i in range(64 * 2)}
    return engine.run(tasks, handler)


def test_copied_engine_reproduces_64_node_table_iii_point():
    port = _table_iii_64_report(InMemoryObjectStore, MetadataStore, Festivus,
                                FestivusConfig, ClusterConfig, ClusterEngine,
                                perfmodel.FABRIC_MODEL)
    jax_side = _table_iii_64_report(JStore, JMeta, JFestivus, JFestivusConfig,
                                    JClusterConfig, JClusterEngine,
                                    jperf.FABRIC_MODEL)
    assert port.all_done and jax_side.all_done
    for field in ("tasks", "bytes_read", "bytes_written", "meta_ops",
                  "makespan_s", "read_bandwidth_bytes_per_s"):
        assert getattr(port, field) == getattr(jax_side, field), field
    assert port.queue_stats == jax_side.queue_stats
    assert port.bytes_read == 128 * 8 * MiB
    assert port.makespan_s == pytest.approx(0.029659664573002766, rel=1e-9)
