"""``launch/train.py``'s mesh path on gloo, several ranks on the CPU.

A module fixture starts the ranks once: a world of 2 (2 x 1 and 1 x 2
meshes) and a world of 4 (2 x 2), each rank a process of
``tests/torch_mesh_worker.py`` joined through a file store under
``tmp_path``, with an ``init_process_group`` timeout and a join timeout.
Each case runs one data-parallel train step (two with int8 moments) from
the JAX package's initial parameters on a batch made from a seed; the
tests read what the ranks wrote and hold it

* against the port's single-process step on the same parameters and rows:
  the loss and every gradient to f32 3e-5 (the ranks sum in another
  order), the parameters after the step as ``tests/test_torch_train.py``
  holds a step, the int8 moments' row scales to 3e-5 and their payloads to
  one step;
* against the JAX package's single-device ``make_train_step`` under
  ``tests/test_torch_train.py``'s tolerances.

The cases cover llama3-8b (and two microbatches), dbrx-132b (the MoE aux
loss of global-batch fractions: a mean of the ranks' own aux losses would
differ), mamba2-2.7b, and int8 moments with the FFN widened so that its
matrices take them (``w_gate``'s last axis over ``model``, ``w_down``'s
over ``data``: each row's absmax is reduced over the ranks), at 2 x 1 and
1 x 2 also in parts of rows: the ranks' ``UPDATE_PART`` lowered so that
each such leaf takes four parts, the last one short, each part
all-reducing its own row maxima.  Those cases are held bit for bit
against the same case updated whole, and each rank's update must make
as many all-reduces as every other rank's.  A last case
trains through ``launch.train.run`` on a 2 x 1 mesh, restores the
checkpoint with ``restore(shardings=)`` at 2 x 1 and at 1 x 2, counting
the bytes each rank read, and resumes at 1 x 2.
"""

import dataclasses
import functools
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build as jbuild
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_shapes)
from repro_torch.models import build
from repro_torch.train import make_train_step
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_grads_fn

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_mesh_worker.py"
F32 = dict(rtol=3e-5, atol=3e-5)
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)  # tests/test_torch_train.py
LR = 1e-3
JOIN_TIMEOUT_S = 240

#: name -> (arch, config change, (data, model), moments, microbatches,
#: steps, seq)
CASES = {
    "llama_2x1": ("llama3-8b", {}, (2, 1), "fp32", 1, 1, 32),
    "llama_1x2": ("llama3-8b", {}, (1, 2), "fp32", 1, 1, 32),
    "llama_2x2": ("llama3-8b", {}, (2, 2), "fp32", 1, 1, 32),
    "llama_micro_2x1": ("llama3-8b", {}, (2, 1), "fp32", 2, 1, 32),
    "dbrx_2x1": ("dbrx-132b", {}, (2, 1), "fp32", 1, 1, 32),
    "dbrx_2x2": ("dbrx-132b", {}, (2, 2), "fp32", 1, 1, 32),
    "mamba_2x1": ("mamba2-2.7b", {}, (2, 1), "fp32", 1, 1, 64),
    "mamba_1x2": ("mamba2-2.7b", {}, (1, 2), "fp32", 1, 1, 64),
    "int8_2x1": ("llama3-8b", {"d_ff": 512}, (2, 1), "int8", 1, 2, 32),
    "int8_1x2": ("llama3-8b", {"d_ff": 512}, (1, 2), "int8", 1, 2, 32),
    "int8_2x2": ("llama3-8b", {"d_ff": 512}, (2, 2), "int8", 1, 2, 32),
    "int8_parts_2x1": ("llama3-8b", {"d_ff": 512}, (2, 1), "int8", 1, 2, 32),
    "int8_parts_1x2": ("llama3-8b", {"d_ff": 512}, (1, 2), "int8", 1, 2, 32),
}
#: the parts cases: the ranks' UPDATE_PART, and the case that updates the
#: same leaves whole.  5000 elements cut the local w_gate / w_up and
#: w_down shards ([32, 512] and [512, 32] at 2 x 1, [64, 256] and
#: [256, 64] at 1 x 2) into 4 parts of 9, 156, 19 and 78 rows, the last
#: part short (5, 44, 7, 22 rows)
UPDATE_PARTS = {"int8_parts_2x1": (5000, "int8_2x1"),
                "int8_parts_1x2": (5000, "int8_1x2")}
PARTS_PER_LEAF = 4
BATCH = 4


def _cfgs(arch, change):
    change = dict(dtype="float32", **change)
    return (dataclasses.replace(jget_config(arch, "smoke"), **change),
            dataclasses.replace(get_config(arch, "smoke"), **change))


def _inputs(name):
    arch, change, _, _, _, _, seq = CASES[name]
    jcfg, _ = _cfgs(arch, change)
    jparams = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (BATCH, seq), dtype=np.int32)
    return jparams, tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once on its mesh -> {case: [each rank's result]}."""
    tmp = tmp_path_factory.mktemp("mesh")
    cases = []
    for name, (arch, change, (d, m), moments, micro, steps, _) in \
            CASES.items():
        jparams, tokens = _inputs(name)
        cases.append({"name": name, "kind": "step", "arch": arch,
                      "change": change, "data": d, "model": m,
                      "moments": moments, "micro": micro, "steps": steps,
                      "lr": LR, "tokens": tokens,
                      "update_part": UPDATE_PARTS.get(name, (None,))[0],
                      "params": jax.tree.map(np.asarray, jparams)})
    cases.append({"name": "restore", "kind": "restore", "arch": "llama3-8b",
                  "change": {"d_ff": 512}, "data": 2, "model": 1})
    (tmp / "restore").mkdir()
    (tmp / "cases.pkl").write_bytes(pickle.dumps(cases))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        init = tmp / f"init{world}"
        procs += [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(init),
             str(tmp / "cases.pkl"), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        log[-3000:] for log in logs)
    out = {}
    for case in cases:
        world = case["data"] * case["model"]
        out[case["name"]] = [pickle.loads(
            (tmp / f"{case['name']}.{r}.pkl").read_bytes())
            for r in range(world)]
    return out


@functools.lru_cache(maxsize=None)
def _single(name):
    """The port's single-process gradients and steps, and the JAX
    package's steps (as many), on the case's parameters and batch."""
    arch, change, _, moments, micro, steps, _ = CASES[name]
    jcfg, cfg = _cfgs(arch, change)
    jparams, tokens = _inputs(name)
    opt_cfg = opt.OptimizerConfig(learning_rate=LR, warmup_steps=1,
                                  moments_dtype=moments)
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu", torch.float32)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)}
    grads, gm = make_grads_fn(model, micro)(params, batch)
    state = opt.init(params, opt_cfg, reference_shapes(cfg))
    step = make_train_step(model, opt_cfg, num_microbatches=micro)
    ms = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        ms.append({k: float(v) for k, v in m.items()})
    port = {"grads": params_to_numpy(grads, cfg),
            "grad_metrics": {k: float(v) for k, v in gm.items()},
            "metrics": ms, "params": params_to_numpy(params, cfg),
            "mu": params_to_numpy(state.mu, cfg),
            "nu": params_to_numpy(state.nu, cfg)}
    jopt_cfg = jopt.OptimizerConfig(**dataclasses.asdict(opt_cfg))
    jstep = jax.jit(jmake_train_step(jbuild(jcfg), jopt_cfg,
                                     num_microbatches=micro))
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    jnew, jstate, jms = jparams, jopt.init(jparams, jopt_cfg), []
    for _ in range(steps):
        jnew, jstate, jm = jstep(jnew, jstate, jbatch)
        jms.append({k: float(v) for k, v in jm.items()})
    want = {"params": jax.tree.map(np.asarray, jnew), "metrics": jms[0],
            "step_metrics": jms}
    return port, want


def _hold_params(got, want, lr=LR):
    """tests/test_torch_train.py's hold of a step's parameters."""
    close = total = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        diff = np.abs(a - b)
        ok = diff <= PARAMS_TOL["atol"] + PARAMS_TOL["rtol"] * np.abs(b)
        close, total = close + int(ok.sum()), total + ok.size
        assert diff.max() <= 2 * lr, (jax.tree_util.keystr(path), diff.max())
    assert close / total > 0.999, (close, total)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_single_process_step(ranks, name):
    port, _ = _single(name)
    results = ranks[name]
    for r in results[1:]:  # every rank ends with the same state
        for a, b in zip(jax.tree.leaves(r["params"]),
                        jax.tree.leaves(results[0]["params"])):
            np.testing.assert_array_equal(a, b)
    got = results[0]
    _, _, (d, m), moments, micro, _, _ = CASES[name]
    assert got["axes"] == ("data",)
    assert got["rows"] == BATCH // d
    for k, v in port["grad_metrics"].items():
        np.testing.assert_allclose(got["grad_metrics"][k], v, rtol=3e-5,
                                   err_msg=k)
    for a, b in zip(got["metrics"], port["metrics"]):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=3e-5, err_msg=k)
    assert jax.tree.structure(got["grads"]) == \
        jax.tree.structure(port["grads"])
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(got["grads"])[0],
            jax.tree.leaves(port["grads"])):
        np.testing.assert_allclose(a, b, **F32,
                                   err_msg=jax.tree_util.keystr(path))
    _hold_params(got["params"], port["params"])
    quantized = 0
    for part in ("mu", "nu"):
        for a, b in zip(jax.tree.leaves(got[part],
                                        is_leaf=lambda x: isinstance(
                                            x, opt.QTensor)),
                        jax.tree.leaves(port[part], is_leaf=lambda x:
                                        isinstance(x, opt.QTensor))):
            if isinstance(b, opt.QTensor):
                quantized += 1
                np.testing.assert_allclose(a.scale, b.scale, rtol=3e-5)
                assert np.abs(a.q.astype(np.int32)
                              - b.q.astype(np.int32)).max() <= 1
    assert (quantized > 0) == (moments == "int8")
    if name.startswith("dbrx"):
        assert got["metrics"][0]["moe_aux"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_the_jax_step(ranks, name):
    _, want = _single(name)
    got = ranks[name][0]
    for k in ("loss", "nll", "z_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][0][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _hold_params(got["params"], want["params"])


@pytest.mark.parametrize("name", list(UPDATE_PARTS))
def test_int8_update_in_parts_is_the_whole_leaf_update(ranks, name):
    """Each rank's parameters, int8 payloads and row scales after the
    steps in parts are those of the same case updated whole, bit for bit;
    each int8 leaf's row maxima were all-reduced once a part and moment
    (the global norm's all-reduce aside)."""
    whole = ranks[UPDATE_PARTS[name][1]]
    for got, want in zip(ranks[name], whole):
        for part in ("params", "mu", "nu"):
            a = jax.tree.leaves(got[part])
            b = jax.tree.leaves(want[part])
            assert len(a) == len(b)
            for x, y in zip(a, b):  # a QTensor's shape gives int leaves
                assert np.asarray(x).dtype == np.asarray(y).dtype
                np.testing.assert_array_equal(x, y)
        for n_parts, n_whole in zip(got["update_all_reduces"],
                                    want["update_all_reduces"]):
            assert n_whole > 1
            assert n_parts - 1 == PARTS_PER_LEAF * (n_whole - 1)


@pytest.mark.parametrize("name", list(CASES))
def test_update_makes_the_same_all_reduces_on_every_rank(ranks, name):
    """A rank that made another number of all-reduces than the others
    would hang the step: each step's update makes the same count on every
    rank (one, the global norm's, with f32 moments)."""
    counts = [r["update_all_reduces"] for r in ranks[name]]
    assert len(counts[0]) == CASES[name][5]
    assert all(c == counts[0] for c in counts), counts
    moments = CASES[name][3]
    assert all((n > 1) == (moments == "int8") for n in counts[0]), counts


def test_storage_follows_the_rule_table(ranks):
    """wq [64, 64] is ("dp", "tp"): d over data, the heads over model."""
    assert ranks["llama_2x1"][0]["wq_local"] == [32, 64]
    assert ranks["llama_1x2"][0]["wq_local"] == [64, 32]
    assert ranks["llama_2x2"][0]["wq_local"] == [32, 32]


def test_restore_at_another_mesh_reads_only_each_ranks_shards(ranks):
    results = ranks["restore"]
    saved = results[0]["saved"]
    for r in results:
        for key in ("same", "other"):
            got = r[key]
            assert got["step"] == 2
            for part in ("params", "mu", "nu"):
                for a, b in zip(jax.tree.leaves(got[part]),
                                jax.tree.leaves(saved[part])):
                    np.testing.assert_array_equal(a, b)
        assert r["same"]["wq_local"] == [32, 64]
        assert r["other"]["wq_local"] == [64, 32]
        same, other = r["same"]["read"], r["other"]["read"]
        # each rank asks for its own shards only; at the saving mesh they
        # are whole chunks (cut at the shard boundaries when saved), so it
        # decodes nothing else; at 1 x 2 its shards split the axis the
        # chunks do not, so it decodes the chunks that cover them: here
        # every chunk of a sharded leaf
        for read in (same, other):
            assert read["region_bytes"] < 0.6 * read["leaf_bytes"]
        assert same["chunk_bytes"] == same["region_bytes"]
        assert other["region_bytes"] <= other["chunk_bytes"] \
            <= other["leaf_bytes"]
    assert results[1]["resumed"]["step"] == 3
    assert results[0]["resumed"]["history"][0]["step"] == 3
