"""State carried across packages: a bucket written by one package reads
byte for byte in the other, and the imagery configuration crosses over as
a plain dict (repro_torch.convert)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import festivus_imagery as jcfg
from repro.core import ChunkStore as JChunkStore
from repro.core import Festivus as JFestivus
from repro.core import LocalDirObjectStore as JLocalDir
from repro.data import imagery as jimagery
from repro_torch.apps import composite as papp
from repro_torch.configs import festivus_imagery as pcfg
from repro_torch.convert import imagery_config_from_dict, stack_to_device
from repro_torch.core import ChunkStore, Festivus, LocalDirObjectStore
from repro_torch.data import imagery


def _keys(store, prefix):
    return sorted(store.list(prefix))


def test_port_reads_a_bucket_the_jax_package_wrote(tmp_path):
    jstore = JLocalDir(str(tmp_path))
    jcs = JChunkStore(JFestivus(jstore), "bucket")
    spec = jimagery.SceneSpec(tile_px=32, temporal_depth=3, seed=5)
    jimagery.write_scene_stack(jcs, "stacks/a", spec, chunk_px=16)
    jimgs, jvalid = jimagery.read_scene_stack(jcs, "stacks/a")

    store = LocalDirObjectStore(str(tmp_path))
    fs = Festivus(store)
    with pytest.raises(FileNotFoundError):  # stat goes through the KV
        ChunkStore(fs, "bucket").open("stacks/a/images")
    assert fs.sync_metadata() > 0
    cs = ChunkStore(fs, "bucket")
    imgs, valid = imagery.read_scene_stack(cs, "stacks/a")
    assert imgs.dtype == jimgs.dtype and imgs.tobytes() == jimgs.tobytes()
    assert valid.tobytes() == jvalid.tobytes()
    keys = _keys(store, "bucket/")
    assert keys and keys == _keys(jstore, "bucket/")
    for k in keys:
        assert bytes(store.get(k)) == bytes(jstore.get(k))


def test_jax_package_reads_the_ports_composite(tmp_path):
    cfg = pcfg.SMOKE
    store = LocalDirObjectStore(str(tmp_path))
    cs = ChunkStore(Festivus(store), "bucket")
    imgs, _ = imagery.scene_stack(imagery.SceneSpec(tile_px=32,
                                                    temporal_depth=4, seed=9))
    comp = papp.composite_tile(imgs, cfg, device="cpu")
    arr = cs.create("composite/a", comp.shape, comp.dtype, (16, 16, 4),
                    codec="zlib", pyramid_levels=2)
    arr.write_region((0, 0, 0), comp)
    arr.build_pyramid()

    jfs = JFestivus(JLocalDir(str(tmp_path)))
    jfs.sync_metadata()
    jarr = JChunkStore(jfs, "bucket").open("composite/a")
    assert jarr.read_all().tobytes() == comp.tobytes()
    # pyramid levels live in the writer's metadata KV; the bytes match
    for level in (1, 2):
        key = f"bucket/composite/a/p{level}/c/0.0.0"
        assert bytes(store.get(key)) == bytes(jfs.store.get(key))


@pytest.mark.parametrize("name", ["DEFAULT", "SMOKE"])
def test_imagery_config_round_trips(name):
    jax_side = getattr(jcfg, name)
    port = imagery_config_from_dict(dataclasses.asdict(jax_side))
    assert port == getattr(pcfg, name)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_side)
    assert (dataclasses.asdict(port.utm_spec())
            == dataclasses.asdict(jax_side.utm_spec()))
    assert (dataclasses.asdict(port.festivus_config())
            == dataclasses.asdict(jax_side.festivus_config()))


def test_imagery_config_refuses_unknown_fields():
    d = dataclasses.asdict(jcfg.SMOKE)
    d["tile_px"] = 7
    with pytest.raises(ValueError, match="tile_px"):
        imagery_config_from_dict(d)


def test_stack_to_device_copies_once_to_contiguous_tensors():
    rng = np.random.default_rng(0)
    imgs = rng.random((3, 8, 16, 4), dtype=np.float32)[:, :, ::2]
    valid = rng.random((3, 8, 8)) > 0.5
    t_imgs, t_valid = stack_to_device(imgs, valid, torch.device("cpu"))
    assert t_imgs.is_contiguous() and t_imgs.dtype == torch.float32
    assert np.array_equal(t_imgs.numpy(), imgs)
    assert t_valid.dtype == torch.bool and np.array_equal(t_valid.numpy(),
                                                          valid)
    assert stack_to_device(imgs, None, "cpu")[1] is None
