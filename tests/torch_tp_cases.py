"""The gloo runs of ``tests/test_torch_tp.py`` and
``tests/test_torch_tp_families.py``: their cases, the ranks, and the
references they are held against (a helper module, not a test module).

:func:`run_ranks` starts the ranks of every case once, one world a mesh
shape, all at once, each rank a process of ``tests/torch_tp_worker.py``
joined through a file store under ``tmp_path``, with an
``init_process_group`` timeout and a join timeout; the single-process and
JAX references (:func:`single`) are computed while they run.  A case is
``name -> (arch, config change, (data, model), frontend frames)``.
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
import torch

from repro.configs import get_config as jget_config
from repro.models import build as jbuild
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_shapes)
from repro_torch.models import build
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_grads_fn

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_tp_worker.py"
F32 = dict(rtol=3e-5, atol=3e-5)
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)  # tests/test_torch_train.py
LR = 1e-3
BATCH, SEQ = 4, 32
JOIN_TIMEOUT_S = 240
HEADS_6_2 = {"num_heads": 6, "num_kv_heads": 2, "head_dim": 16}
HEADS_6_6 = {"num_heads": 6, "num_kv_heads": 6, "head_dim": 16}
SEQPAR = {"sequence_parallel": True}


def cfgs(arch, change):
    change = dict(dtype="float32", **change)
    return (dataclasses.replace(jget_config(arch, "smoke"), **change),
            dataclasses.replace(get_config(arch, "smoke"), **change))


@functools.lru_cache(maxsize=None)
def inputs(arch, change_items, frames):
    """The JAX initial parameters, tokens and frontend of a config (the
    same for every mesh of it)."""
    jcfg, _ = cfgs(arch, dict(change_items))
    jparams = jax.jit(jbuild(jcfg).init)(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
    front = None
    if frames:
        front = np.random.default_rng(2).standard_normal(
            (BATCH, frames, jcfg.frontend_dim), dtype=np.float32)
    return jparams, tokens, front


def key(case):
    """A case's config, tokens and frontend: sequence parallelism changes
    none of its numbers (the stream's layout is not the values), so its
    references are those of the config without it."""
    arch, change, _, frames = case
    return arch, tuple(sorted((k, v) for k, v in change.items()
                              if k != "sequence_parallel")), frames


def run_ranks(tmp, cases: dict, others: dict = None, options: dict = None,
              while_running=None) -> dict:
    """Every case run once on its mesh (``others``: name -> (kind, case),
    a prefill, gather or decode case; ``options``: name -> more of its
    spec's keys) -> {case: [each rank's result]}.  ``while_running()`` is
    called while the ranks run (the references of ``others``)."""
    others, options = others or {}, options or {}
    specs = []
    kinds = {name: kind for name, (kind, _) in others.items()}
    for name, case in {**cases, **{n: c for n, (_, c) in
                                   others.items()}}.items():
        # the ranks run the case's own config, sequence parallel or not
        arch, change, (d, m), _ = case
        jparams, tokens, front = inputs(*key(case))
        specs.append({"name": name,
                      "kind": kinds.get(name, "step"),
                      "arch": arch, "change": change, "data": d, "model": m,
                      "lr": LR, "tokens": tokens, "frontend": front,
                      "params": jax.tree.map(np.asarray, jparams),
                      **options.get(name, {})})
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for shape in sorted({(c["data"], c["model"]) for c in specs}):
        world = shape[0] * shape[1]
        tag = f"{shape[0]}x{shape[1]}"
        (tmp / f"cases{tag}.pkl").write_bytes(pickle.dumps(
            [c for c in specs if (c["data"], c["model"]) == shape]))
        for r in range(world):
            with open(tmp / f"log{tag}.{r}", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, str(WORKER), str(r), str(world),
                     str(tmp / f"init{tag}"), str(tmp / f"cases{tag}.pkl"),
                     str(tmp)], env=env, stdout=log,
                    stderr=subprocess.STDOUT))
    try:
        for case in cases.values():  # the references, while the ranks run
            single(*key(case))
        if while_running is not None:
            while_running()
        for p in procs:
            p.wait(timeout=JOIN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        path.read_text()[-3000:] for path in sorted(tmp.glob("log*")))
    out = {}
    for case in specs:
        world = case["data"] * case["model"]
        out[case["name"]] = [pickle.loads(
            (tmp / f"{case['name']}.{r}.pkl").read_bytes())
            for r in range(world)]
    return out


def batch_of(tokens, front):
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)}
    if front is not None:
        batch["frontend"] = torch.from_numpy(front)
    return batch


@functools.lru_cache(maxsize=None)
def single(arch, change_items, frames):
    """The port's single-process gradients and step, and the JAX
    package's jitted step, on a config's parameters and batch (sequence
    parallelism changes neither: the stream's layout is not the
    numbers)."""
    change = {k: v for k, v in change_items if k != "sequence_parallel"}
    jcfg, cfg = cfgs(arch, change)
    jparams, tokens, front = inputs(arch, change_items, frames)
    opt_cfg = opt.OptimizerConfig(learning_rate=LR, warmup_steps=1)
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu", torch.float32)
    batch = batch_of(tokens, front)
    grads, gm = make_grads_fn(model)(params, batch)
    port = {"grads": params_to_numpy(grads, cfg),
            "grad_metrics": {k: float(v) for k, v in gm.items()}}
    # the update make_train_step applies, on these gradients
    shapes = reference_shapes(cfg)
    state = opt.init(params, opt_cfg, shapes)
    new, _, m = opt.update(grads, state, params, opt_cfg, shapes)
    port["metrics"] = {**port["grad_metrics"],
                       **{k: float(v) for k, v in m.items()}}
    port["params"] = params_to_numpy(new, cfg)
    jopt_cfg = jopt.OptimizerConfig(**dataclasses.asdict(opt_cfg))
    jstep = jax.jit(jmake_train_step(jbuild(jcfg), jopt_cfg))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jnew, _, jm = jstep(jparams, jopt.init(jparams, jopt_cfg), jbatch)
    want = {"params": jax.tree.map(np.asarray, jnew),
            "metrics": {k: float(v) for k, v in jm.items()}}
    return port, want


def hold_params(got, want, lr=LR):
    """tests/test_torch_train.py's hold of a step's parameters."""
    close = total = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        diff = np.abs(a - b)
        ok = diff <= PARAMS_TOL["atol"] + PARAMS_TOL["rtol"] * np.abs(b)
        close, total = close + int(ok.sum()), total + ok.size
        assert diff.max() <= 2 * lr, (jax.tree_util.keystr(path), diff.max())
    assert close / total > 0.999, (close, total)




def hold_against_single(results: list, port: dict, data: int) -> None:
    """The ranks' step against the port's single-process one: every rank
    ends with the same parameters; the metrics and every gradient to f32
    3e-5, the parameters as ``tests/test_torch_mesh.py`` holds them."""
    for r in results[1:]:
        for a, b in zip(jax.tree.leaves(r["params"]),
                        jax.tree.leaves(results[0]["params"])):
            np.testing.assert_array_equal(a, b)
    got = results[0]
    assert got["axes"] == ("data",) and got["rows"] == BATCH // data
    for k, v in port["grad_metrics"].items():
        np.testing.assert_allclose(got["grad_metrics"][k], v, rtol=3e-5,
                                   err_msg=k)
    for k, v in port["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=3e-5,
                                   err_msg=k)
    assert jax.tree.structure(got["grads"]) == \
        jax.tree.structure(port["grads"])
    for (path, a), b in zip(
            jax.tree_util.tree_flatten_with_path(got["grads"])[0],
            jax.tree.leaves(port["grads"])):
        np.testing.assert_allclose(a, b, **F32,
                                   err_msg=jax.tree_util.keystr(path))
    hold_params(got["params"], port["params"])


def hold_against_jax(got: dict, want: dict) -> None:
    """A rank's step against the JAX package's, under
    ``tests/test_torch_train.py``'s tolerances."""
    for k in ("loss", "nll", "z_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    hold_params(got["params"], want["params"])
