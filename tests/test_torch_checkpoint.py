"""Checkpoints across the packages, and the parameter layouts they rest on,
on the CPU.

A checkpoint written by the JAX package's ``repro.train.CheckpointManager``
restores in the port's ``repro_torch.train.CheckpointManager`` and the
reverse, equal leaf for leaf, with f32 and int8 (``QTensor``) Adam moments:
both write the same leaf names (``jax.tree_util.keystr`` of the path,
sanitised) into the same chunk-store format.  A train state crosses in the
JAX layout (``convert.params_to_numpy``, the exact inverse of
``convert.params_from_numpy``).  ``launch.train --device cpu`` pre-empted
and resumed ends with the same parameters, bit for bit, as a run that was
not interrupted.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_config as jget_config
from repro.core import ChunkStore as JChunkStore
from repro.core import Festivus as JFestivus
from repro.core import LocalDirObjectStore as JLocalDir
from repro.models import build as jbuild
from repro.train import optimizer as jopt
from repro.train.checkpoint import CheckpointManager as JCheckpointManager
from repro.train.checkpoint import _leaf_name as jleaf_name
from repro_torch.configs import get_config
from repro_torch.convert import (jax_layout, params_from_numpy,
                                 params_to_numpy, reference_shapes)
from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore
from repro_torch.core import LocalDirObjectStore
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import train as ptrain
from repro_torch.models import build
from repro_torch.train import CheckpointManager, make_train_step
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import optimizer as opt


# ---------------------------------------------------------------------------
# parameters across, and back
# ---------------------------------------------------------------------------
ROUNDTRIP_ARCHS = ["llama3-8b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b",
                   "seamless-m4t-large-v2", "internvl2-1b"]


@pytest.mark.parametrize("arch", ROUNDTRIP_ARCHS)
def test_params_to_numpy_inverts_params_from_numpy(arch):
    jcfg = dataclasses.replace(jget_config(arch, "smoke"), dtype="float32")
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    tree = jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(3)))
    back = params_to_numpy(params_from_numpy(tree, cfg, "cpu"), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ROUNDTRIP_ARCHS)
def test_reference_shapes_lay_out_as_the_ports_params(arch):
    cfg = get_config(arch, "smoke")
    params = build(cfg, device="cpu").init(0, param_dtype=torch.float32)
    pairs = []
    opt.tree_map(lambda p, s: pairs.append((p, s)), params,
                 reference_shapes(cfg))
    assert len(pairs) == len(opt.tree_leaves(params))
    stacked = 0
    for p, s in pairs:
        # a layer's leaf is a slice of its stack's: the trailing dimensions
        assert tuple(s[len(s) - p.dim():]) == tuple(p.shape), (s, p.shape)
        stacked += len(s) > p.dim()
    assert stacked > 0
    # every JAX leaf of the layout is somewhere in the port's tree
    n_jax = len(jax.tree.leaves(jax_layout(cfg),
                                is_leaf=lambda x: isinstance(x, tuple)))
    assert n_jax <= len(pairs)


# ---------------------------------------------------------------------------
# leaf names and the format
# ---------------------------------------------------------------------------
def _port_types(tree):
    """A JAX package train state as the port's types (numpy leaves)."""
    if isinstance(tree, jopt.AdamState):
        return opt.AdamState(*(_port_types(x) for x in tree))
    if isinstance(tree, jopt.QTensor):
        return opt.QTensor(q=np.asarray(tree.q), scale=np.asarray(tree.scale),
                           shape=tuple(tree.shape))
    if isinstance(tree, dict):
        return {k: _port_types(v) for k, v in tree.items()}
    return np.asarray(tree)


#: llama3-8b-smoke with d_ff 512: its stacked FFN leaves [2, 64, 512] reach
#: the int8 threshold (65536 elements), a layer's [64, 512] alone does not
BIG_FFN = dict(dtype="float32", d_ff=512)


def _jax_state(moments, seed=0):
    cfg = dataclasses.replace(jget_config("llama3-8b", "smoke"), **BIG_FFN)
    params = jbuild(cfg).init(jax.random.PRNGKey(seed))
    ocfg = jopt.OptimizerConfig(moments_dtype=moments)
    state = jopt.init(params, ocfg)
    # moments that are not zero, so a misplaced leaf shows
    grads = jax.tree.map(lambda p: jnp.sin(p * 7.0), params)
    params, state, _ = jopt.update(grads, state, params, ocfg)
    return {"params": params, "opt": state}


def test_leaf_names_are_the_jax_packages():
    state = _jax_state("int8")
    want = [jleaf_name(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(state)[0]]
    got = [pckpt.leaf_name(p) for p, _ in
           pckpt.flatten_with_path(_port_types(state))]
    assert got == want
    assert any(n.endswith(".qv") for n in got)
    assert "opt_.step" in got and "params_blocks_attn_wq" in got
    lists = pckpt.flatten_with_path({"a": [np.zeros(1), (np.ones(2),)]})
    assert [pckpt.leaf_name(p) for p, _ in lists] == ["a_0", "a_1_0"]


def _stores(tmp_path):
    jcs = JChunkStore(JFestivus(JLocalDir(str(tmp_path))), "data")
    fs = Festivus(LocalDirObjectStore(str(tmp_path)))
    return jcs, fs


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_port_restores_a_jax_checkpoint_leaf_for_leaf(tmp_path, moments):
    state = _jax_state(moments)
    jcs, fs = _stores(tmp_path)
    JCheckpointManager(jcs, name="ck").save(3, state)
    fs.sync_metadata()
    ckpt = CheckpointManager(ChunkStore(fs, "data"), name="ck")
    assert ckpt.latest_step() == 3
    template = _port_types(state)
    got = ckpt.restore(template)
    want = pckpt.flatten_with_path(template)
    pairs = list(zip(pckpt.flatten_with_path(got), want))
    assert len(pairs) == len(jax.tree.leaves(state))
    for (path, a), (_, b) in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)
    if moments == "int8":
        assert isinstance(got["opt"].mu["blocks"]["ffn"]["w_up"], opt.QTensor)


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_jax_restores_a_port_checkpoint_leaf_for_leaf(tmp_path, moments):
    cfg = dataclasses.replace(get_config("llama3-8b", "smoke"), **BIG_FFN)
    model = build(cfg, device="cpu")
    params = model.init(1, param_dtype=torch.float32)
    ocfg = opt.OptimizerConfig(moments_dtype=moments, warmup_steps=1)
    state = opt.init(params, ocfg, reference_shapes(cfg))
    if moments == "int8":  # decided on the stacked shape, as in JAX
        assert isinstance(state.mu["blocks"][0]["ffn"]["w_up"], opt.QTensor)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32))
    params, state, _ = make_train_step(model, ocfg)(
        params, state, {"tokens": tokens, "labels": tokens})
    saved = ptrain.state_to_numpy(params, state, cfg)
    fs = Festivus(LocalDirObjectStore(str(tmp_path)))
    CheckpointManager(ChunkStore(fs, "data"), name="ck").save(1, saved)

    jcs = JChunkStore(JFestivus(JLocalDir(str(tmp_path))), "data")
    jcs.fs.sync_metadata()
    jcfg = dataclasses.replace(jget_config("llama3-8b", "smoke"), **BIG_FFN)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    template = {"params": jparams,
                "opt": jopt.init(jparams, jopt.OptimizerConfig(
                    moments_dtype=moments))}
    got = JCheckpointManager(jcs, name="ck").restore(template)
    want = pckpt.flatten_with_path(saved)
    got_leaves = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(got_leaves) == len(want)
    for (jpath, a), (path, b) in zip(got_leaves, want):
        assert jleaf_name(jpath) == pckpt.leaf_name(path)
        np.testing.assert_array_equal(np.asarray(a), b)
    # and back into the port's per-layer layout, bit for bit
    ckpt = CheckpointManager(ChunkStore(fs, "data"), name="ck")
    p2, s2 = ptrain.restore_state(ckpt, cfg, ocfg, "cpu")
    for a, b in zip(opt.tree_leaves((params, state)),
                    opt.tree_leaves((p2, s2))):
        if isinstance(a, opt.QTensor):
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        else:
            assert a.dtype == b.dtype and torch.equal(a, b)


def _cs():
    return ChunkStore(Festivus(InMemoryObjectStore()), "arrays")


def test_roundtrip_bf16_widening_scalars_and_tensor_templates():
    ckpt = CheckpointManager(_cs(), name="t", codec="raw")
    tree = {"w": torch.randn(5, 3).to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
            "xs": [torch.arange(4.0), np.ones((2, 2), np.int8)]}
    ckpt.save(1, tree)
    got = ckpt.restore(tree)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"], tree["w"])
    assert got["step"].shape == () and int(got["step"]) == 7
    assert torch.equal(got["xs"][0], tree["xs"][0])
    assert isinstance(got["xs"][1], np.ndarray)
    # sharded: each rank of a (2, 1) mesh reads its rows of "w" region-wise
    ckpt.save(2, {"w": torch.randn(6, 3).to(torch.bfloat16),
                  "step": tree["step"]})
    full = ckpt.restore({"w": tree["w"], "step": tree["step"]}, step=2)
    for rank in range(2):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=2)
        try:
            mesh = pmesh.make_local_mesh(2, 1, device="cpu")
            sh = {"w": shd.to_named_sharding(mesh, ("dp", None), (6, 3)),
                  "step": shd.to_named_sharding(mesh, (), ())}
            part = ckpt.restore({"w": tree["w"], "step": tree["step"]},
                                step=2, shardings=sh)
        finally:
            dist.destroy_process_group()
        assert part["w"].shape == (6, 3) and part["w"].dtype == torch.bfloat16
        assert torch.equal(part["w"].to_local(),
                           full["w"][3 * rank:3 * rank + 3])
        assert int(part["step"].to_local()) == 7
        assert ckpt.read_stats["region_bytes"] == 3 * 3 * 4 + 4


def test_latest_gc_and_manifest_last():
    cs = _cs()
    ckpt = CheckpointManager(cs, name="g", keep=2)
    for s in (1, 2, 3):
        ckpt.save(s, {"x": np.full(3, s, np.float32)})
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    # chunks written but no manifest: not a checkpoint
    cs.create("g/step_0000000009/x", (3,), np.float32, (3,)).write_region(
        (0,), np.zeros(3, np.float32))
    assert ckpt.latest_step() == 3
    assert float(ckpt.restore({"x": np.zeros(3, np.float32)})["x"][0]) == 3


def test_save_async_snapshots_and_wait_raises_the_writers_error():
    ckpt = CheckpointManager(_cs(), name="a")
    x = torch.zeros(4)
    ckpt.save_async(1, {"x": x})
    x += 5  # after the snapshot
    ckpt.wait()
    assert float(ckpt.restore({"x": x})["x"].sum()) == 0
    bad = CheckpointManager(_cs(), name="b", codec="no-such-codec")
    bad.save_async(1, {"x": np.zeros(2)})
    with pytest.raises(Exception):
        bad.wait()


# ---------------------------------------------------------------------------
# launch.train: pre-empted and resumed equals uninterrupted
# ---------------------------------------------------------------------------
def _args(**kw):
    args = ptrain.parser().parse_args(
        ["--arch", "llama3-8b", "--variant", "smoke", "--device", "cpu",
         "--steps", "6", "--batch", "2", "--seq", "16", "--lr", "3e-3",
         "--ckpt-every", "2", "--log-every", "1", "--data-shards", "2"])
    return argparse.Namespace(**{**vars(args), **kw})


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_train_cli_preempted_and_resumed_ends_as_uninterrupted(tmp_path,
                                                               moments):
    whole = ptrain.run(_args(store=str(tmp_path / "a"), moments=moments))
    assert whole["checkpoints"] == [4, 6]
    cut = ptrain.run(_args(store=str(tmp_path / "b"), moments=moments,
                           preempt_at=3))
    assert cut["preempted_at"] == 3 and cut["resume_from"] == 2
    resumed = ptrain.run(_args(store=str(tmp_path / "b"), moments=moments,
                               resume=True))
    assert resumed["history"][0]["step"] == 3
    for a, b in zip(opt.tree_leaves(whole["params"]),
                    opt.tree_leaves(resumed["params"])):
        assert torch.equal(a, b)
    assert whole["history"][-1]["nll"] == resumed["history"][-1]["nll"]


def test_train_cli_refuses_meshes():
    """A mesh runs only where it is the world: in this one-rank world a
    2 x 1 or 1 x 2 mesh raises (the JAX package would shrink it), a 1 x 1
    mesh trains as the single device does (tests/test_torch_mesh.py runs
    the 2-rank meshes)."""
    try:
        for kw in ({"mesh_data": 2}, {"mesh_model": 2}):
            with pytest.raises(ValueError, match="world has 1 ranks"):
                ptrain.run(_args(**kw))
        one = ptrain.run(_args(mesh=True, steps=2))
    finally:
        pmesh.shutdown()
    plain = ptrain.run(_args(steps=2))
    assert one["history"] == [{**h, "tok_per_s": g["tok_per_s"]}
                              for h, g in zip(plain["history"],
                                              one["history"])]
    for a, b in zip(opt.tree_leaves(plain["params"]),
                    opt.tree_leaves(one["params"])):
        assert torch.equal(a, b.to_local())
