"""The port's meshes and sharding rules (``repro_torch.launch.mesh`` and
``repro_torch.launch.sharding``) against the JAX package's, on the CPU.

The JAX side runs in a subprocess on 8 host devices
(``--xla_force_host_platform_device_count=8``, as ``tests/test_sharding.py``
lowers its mini dry run), on a (2, 4) data x model mesh and a (2, 2, 2) pod
x data x model mesh, and prints for every leaf of the smoke parameters and
optimizer state (fp32 and int8 moments) of four architectures its
``param_shardings``/``opt_state_shardings`` spec, and for a few leaves
``devices_indices_map`` by mesh coordinate.  The port's side builds the same
meshes in this process over ``torch``'s fake process group (no
collective runs) and must give the same resolved spec for every leaf (the
JAX layout, through ``launch.train.state_layout``; the port's per-layer
leaves get their stack's spec without the stacked axes), and, rank by rank,
the same shard as JAX's devices map, both by ``shard_slices`` and by
DTensor's own placement arithmetic (one tensor dimension over ``pod`` and
``data`` nests pod-major in both).
"""

import contextlib
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import train as ptrain
from repro_torch.models import build
from repro_torch.train import OptimizerConfig
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import _key_str, flatten_with_path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["llama3-8b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b"]
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
#: leaves whose shard, rank by rank, is held against devices_indices_map:
#: a dimension over dp (("pod", "data") on the 3-D mesh) and one over
#: model; the vocabulary over model and d over dp; an int8 payload and its
#: row scales
PICKED = ["params/['blocks']['attn']['wq']", "params/['embed']",
          "params/['blocks']['moe']['w_down']",
          "opt/.mu['blocks']['mamba']['w_xz'].qv",
          "opt/.nu['blocks']['mamba']['w_xz'].qscale"]

JAX_SIDE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.launch import sharding as shd
    from repro.launch.mesh import _make_mesh, make_local_mesh
    from repro.models import build
    from repro.train import OptimizerConfig
    from repro.train import optimizer as opt_mod

    ARCHS, MESHES, PICKED = {archs!r}, {meshes!r}, {picked!r}

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    def rows(prefix, shardings, abstract, mesh, coords):
        out = {{}}
        flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
        for (path, s), leaf in zip(flat, jax.tree.leaves(abstract)):
            name = prefix + "/" + jax.tree_util.keystr(path)
            row = {{"shape": list(leaf.shape), "spec": spec(s)}}
            if name in PICKED:
                row["indices"] = {{
                    coords[d.id]: [[sl.start or 0,
                                    dim if sl.stop is None else sl.stop]
                                   for sl, dim in zip(idx, leaf.shape)]
                    for d, idx in s.devices_indices_map(
                        tuple(leaf.shape)).items()}}
            out[name] = row
        return out

    result = {{"shrunk": dict(make_local_mesh(4, 4).shape)}}
    for key, (shape, axes) in MESHES.items():
        mesh = _make_mesh(tuple(shape), tuple(axes))
        coords = {{int(d.id): ",".join(
            str(int(c)) for c in np.argwhere(mesh.devices == d)[0])
            for d in mesh.devices.flat}}
        for arch in ARCHS:
            model = build(get_config(arch, "smoke"))
            params_abs = model.abstract_params()
            p = rows("params", shd.param_shardings(mesh, params_abs),
                     params_abs, mesh, coords)
            for moments in ("fp32", "int8"):
                opt_abs = opt_mod.abstract_init(
                    params_abs, OptimizerConfig(moments_dtype=moments))
                o = rows("opt", shd.opt_state_shardings(mesh, opt_abs),
                         opt_abs, mesh, coords)
                result[f"{{key}}/{{arch}}/{{moments}}"] = {{**p, **o}}
    print(json.dumps(result))
""")


@pytest.fixture(scope="module")
def jax_specs():
    code = JAX_SIDE.format(archs=ARCHS, meshes=MESHES, picked=PICKED)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def fake_world(size: int, rank: int = 0):
    """A fake process group of ``size`` ranks, this process as ``rank``."""
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _spec(sh):
    return [list(e) if isinstance(e, tuple) else e for e in sh.spec]


def _port_rows(mesh, cfg, moments):
    """Every leaf of the JAX-layout train state -> (shape, spec, its
    Sharding), named as the JAX subprocess names them."""
    state = ptrain.state_layout(cfg, OptimizerConfig(moments_dtype=moments))
    sh = ptrain.state_shardings(mesh, state)
    out = {}
    for part in ("params", "opt"):
        for (path, leaf), (_, s) in zip(flatten_with_path(state[part]),
                                        flatten_with_path(sh[part])):
            name = f"{part}/" + "".join(_key_str(k) for k in path)
            out[name] = (list(leaf.shape), _spec(s), s)
    return out


@pytest.mark.parametrize("moments", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_every_leaf_resolves_as_in_jax(jax_specs, mesh_key, arch, moments):
    shape, axes = MESHES[mesh_key]
    want = jax_specs[f"{mesh_key}/{arch}/{moments}"]
    with fake_world(8):
        mesh = pmesh._make_mesh(shape, axes, "cpu")
        got = _port_rows(mesh, get_config(arch, "smoke"), moments)
    assert sorted(got) == sorted(want)
    for name, row in want.items():
        assert list(got[name][:2]) == [row["shape"], row["spec"]], name
    if moments == "int8" and arch == "jamba-v0.1-52b":
        assert any(n.endswith(".qscale") for n in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_layer_leaves_take_their_stacks_spec(arch):
    """The port's per-layer parameters and moments (its own tree, as
    ``Trainer.fresh`` places them) get the JAX layout's spec without the
    stacked axes."""
    cfg = get_config(arch, "smoke")
    opt_cfg = OptimizerConfig(moments_dtype="int8")
    params = build(cfg, device="cpu").init(0, param_dtype=torch.float32)
    state = opt_mod.init(params, opt_cfg, convert.reference_shapes(cfg))
    with fake_world(8):
        mesh = pmesh._make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        got = ptrain.state_shardings(mesh, {"params": params, "opt": state})
        stacked = ptrain.state_shardings(
            mesh, ptrain.state_layout(cfg, opt_cfg))

    def trim(x, index):
        if isinstance(x, opt_mod.QTensor):
            return opt_mod.QTensor(trim(x.q, index), trim(x.scale, index),
                                   x.shape)
        return repr(x.spec[len(index):])  # a leaf, where a tuple is not

    for part, g, s in (("params", got["params"], stacked["params"]),
                       ("mu", got["opt"].mu, stacked["opt"].mu),
                       ("nu", got["opt"].nu, stacked["opt"].nu)):
        want = convert.split_layers(s, cfg, trim)
        flat_got = [(p, x.spec) for p, x in flatten_with_path(g)]
        flat_want = flatten_with_path(want)
        assert [p for p, _ in flat_got] == [p for p, _ in flat_want], part
        for (path, a), (_, b) in zip(flat_got, flat_want):
            assert repr(a) == b, (part, path)


@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_each_ranks_shard_is_jaxs_devices_map(jax_specs, mesh_key):
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    shape, axes = MESHES[mesh_key]
    want = jax_specs[f"{mesh_key}/jamba-v0.1-52b/int8"]
    want.update({k: v for k, v in
                 jax_specs[f"{mesh_key}/dbrx-132b/int8"].items()
                 if "moe" in k})
    cfg = {n: get_config(a, "smoke") for n, a in
           (("j", "jamba-v0.1-52b"), ("d", "dbrx-132b"))}
    checked = 0
    for rank in range(8):
        with fake_world(8, rank):
            mesh = pmesh._make_mesh(shape, axes, "cpu")
            rows = {**_port_rows(mesh, cfg["j"], "int8"),
                    **{k: v for k, v in _port_rows(mesh, cfg["d"],
                                                   "int8").items()
                       if "moe" in k}}
            coord = mesh.get_coordinate()
            for name in PICKED:
                gshape, _, s = rows[name]
                region = shd.shard_slices(s, gshape)
                key = ",".join(map(str, coord))
                assert [[r.start, r.stop] for r in region] == \
                    want[name]["indices"][key], (name, key)
                # DTensor's own arithmetic gives this rank the same shard
                local, offset = compute_local_shape_and_global_offset(
                    gshape, mesh, list(s.placements))
                assert list(offset) == [r.start for r in region]
                assert list(local) == [r.stop - r.start for r in region]
                checked += 1
    assert checked == 8 * len(PICKED)
    if mesh_key == "2x2x2":  # wq's d over ("pod", "data"), pod-major
        spec = want["params/['blocks']['attn']['wq']"]["spec"]
        assert spec[1] == ["pod", "data"]


def test_production_meshes_on_a_fake_world():
    with fake_world(256):
        m = pmesh.make_production_mesh(device="cpu")
        assert m.mesh_dim_names == ("data", "model")
        assert tuple(m.mesh.shape) == (16, 16)
        assert pmesh.dp_axes(m) == ("data",) and pmesh.dp_size(m) == 16
        with pytest.raises(ValueError, match="not there"):
            pmesh.make_production_mesh(multi_pod=True, device="cpu")
    with fake_world(512):
        m = pmesh.make_production_mesh(multi_pod=True, device="cpu")
        assert m.mesh_dim_names == ("pod", "data", "model")
        assert tuple(m.mesh.shape) == (2, 16, 16)
        assert pmesh.dp_axes(m) == ("pod", "data")
        assert pmesh.dp_size(m) == 32
        sh = shd.to_named_sharding(m, ("dp", "tp"), (64, 32))
        assert sh.spec == (("pod", "data"), "model")
        assert list(sh.placements) == [Shard(0), Shard(0), Shard(1)]
        # the guard: 48 rows do not divide over 32 dp ranks
        sh = shd.to_named_sharding(m, ("dp", "tp"), (48, 32))
        assert sh.spec == (None, "model") and sh.replicas == 32


def test_local_mesh_refuses_where_jax_would_shrink(jax_specs):
    # the JAX package quietly builds (8, 1) from 8 devices for a 4 x 4
    assert jax_specs["shrunk"] == {"data": 8, "model": 1}
    with fake_world(8):
        with pytest.raises(ValueError, match="world has 8 ranks"):
            pmesh.make_local_mesh(4, 4, device="cpu")
        with pytest.raises(ValueError, match="world has 8 ranks"):
            pmesh.make_local_mesh(2, 2, device="cpu")
        m = pmesh.make_local_mesh(4, 2, device="cpu")
        assert tuple(m.mesh.shape) == (4, 2)


def test_batch_and_decode_shardings():
    with fake_world(8):
        mesh = pmesh._make_mesh((2, 4), ("data", "model"), "cpu")
        b = shd.batch_shardings(mesh, {"tokens": torch.empty(4, 16),
                                       "odd": torch.empty(3, 16)})
        assert b["tokens"].spec == ("data", None)
        assert b["odd"].spec == (None, None)  # the guard
        state = {"attn": {"k": torch.empty(2, 2, 64, 16),
                          "v": torch.empty(2, 2, 64, 16)},
                 "mamba": {"ssm": torch.empty(2, 8, 16, 16)}}
        d = shd.decode_shardings(mesh, {"state": state,
                                        "token": torch.empty(2, 1)}, 2)
        assert d["state"]["attn"]["k"].spec == ("data", None, "model", None)
        assert d["state"]["mamba"]["ssm"].spec == ("data", "model", None,
                                                   None)
        assert d["token"].spec == ("data", None)
        one = shd.decode_shardings(mesh, {"state": {"k": torch.empty(
            1, 2, 64, 16)}, "token": torch.empty(1, 1)}, 1)
        assert one["state"]["k"].spec == (None, None, ("data", "model"),
                                          None)
        assert shd.explain(d["state"], state)[0].startswith("attn/k")
        dp = shd.to_named_sharding(mesh, ("dp", "tp"), (8, 8),
                                   policy="dp_only")
        assert dp.spec == (("data", "model"), None)
        assert list(dp.placements) == [Shard(0), Shard(0)]
        assert isinstance(shd.to_named_sharding(mesh, (None,), (3,))
                          .placements[0], Replicate)
