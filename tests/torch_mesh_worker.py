"""One rank of the gloo runs in ``tests/test_torch_mesh.py`` (not a test
module: it imports no JAX, so that a rank starts in a few seconds).

    python tests/torch_mesh_worker.py RANK WORLD INIT_FILE CASES OUT_DIR

Joins a gloo process group of WORLD ranks through the file store
INIT_FILE, runs each case of the pickled CASES list whose mesh fits the
world, and writes what it measured as ``OUT_DIR/<case>.<rank>.pkl``.  A
case is a dict: ``name``, ``kind`` ("step" or "restore"), the mesh
(``data``, ``model``), the config (``arch``, ``change``), ``moments``,
``micro``, ``steps``, the initial parameters in the JAX layout
(``params``, numpy), the ``tokens`` and, optionally, ``update_part``: the
optimizer's ``UPDATE_PART`` for the case (int8 leaves in smaller parts).
A step case also writes how many ``all_reduce`` calls each step's
optimizer update made on the rank.
"""

import argparse
import contextlib
import dataclasses
import datetime
import pickle
import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train import OptimizerConfig  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=120)


def _config(case):
    return dataclasses.replace(get_config(case["arch"], "smoke"),
                               dtype="float32", **case.get("change", {}))


def _full(x):
    """A DTensor (or a QTensor of them) gathered, as numpy."""
    if isinstance(x, opt.QTensor):
        return opt.QTensor(q=_full(x.q), scale=_full(x.scale), shape=x.shape)
    return shd.gather(x).detach().numpy().copy()


def _moments(tree, cfg):
    full = opt.tree_map(lambda m: opt.QTensor(
        q=torch.from_numpy(_full(m).q), scale=torch.from_numpy(
            _full(m).scale), shape=m.shape)
        if isinstance(m, opt.QTensor) else torch.from_numpy(_full(m)), tree)
    return convert.params_to_numpy(full, cfg)


@contextlib.contextmanager
def counted_updates(counts):
    """``opt.update`` appending, at each call, the ``dist.all_reduce``
    calls it made (the global norm's, each part's row maxima)."""
    update, all_reduce = opt.update, dist.all_reduce

    def counting(*args, **kwargs):
        calls = [0]

        def reduce(*a, **kw):
            calls[0] += 1
            return all_reduce(*a, **kw)

        dist.all_reduce = reduce
        try:
            return update(*args, **kwargs)
        finally:
            dist.all_reduce = all_reduce
            counts.append(calls[0])

    opt.update = counting
    try:
        yield
    finally:
        opt.update = update


@contextlib.contextmanager
def update_part(elements):
    """``opt.UPDATE_PART`` set to ``elements`` (None: as it is)."""
    saved = opt.UPDATE_PART
    opt.UPDATE_PART = elements or saved
    try:
        yield
    finally:
        opt.UPDATE_PART = saved


def run_step_case(case, mesh):
    cfg = _config(case)
    model = build(cfg, device="cpu")
    opt_cfg = OptimizerConfig(learning_rate=case["lr"], warmup_steps=1,
                              moments_dtype=case["moments"])
    params = convert.params_from_numpy(case["params"], cfg, "cpu",
                                       torch.float32)
    state = opt.init(params, opt_cfg, convert.reference_shapes(cfg))
    sh = ptrain.state_shardings(mesh, {"params": params, "opt": state})
    params = opt.tree_map(shd.distribute, params, sh["params"])
    state = opt.AdamState(
        step=state.step,
        mu=ptrain._moment_map(shd.distribute, state.mu, sh["opt"].mu),
        nu=ptrain._moment_map(shd.distribute, state.nu, sh["opt"].nu))
    tokens = case["tokens"]
    axes = ptrain.rows_axes(mesh, len(tokens))
    rows = ptrain.rank_rows({"tokens": tokens, "labels": tokens}, mesh, axes,
                            case["micro"])
    batch = {k: torch.from_numpy(v) for k, v in rows.items()}
    step = ptrain.make_mesh_train_step(model, opt_cfg, mesh, axes,
                                       num_microbatches=case["micro"])
    grads, gm = step.grads(params, batch)
    full = opt.tree_map(lambda g, p: torch.from_numpy(_full(shd.from_local(
        g, shd.sharding_of(p), tuple(p.shape)))), grads, params)
    out = {"axes": axes, "rows": len(rows["tokens"]),
           "grads": convert.params_to_numpy(full, cfg),
           "grad_metrics": {k: float(v) for k, v in gm.items()},
           "metrics": [], "update_all_reduces": []}
    with update_part(case.get("update_part")), \
            counted_updates(out["update_all_reduces"]):
        for _ in range(case["steps"]):
            params, state, m = step(params, state, batch)
            out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = convert.params_to_numpy(
        opt.tree_map(lambda p: torch.from_numpy(_full(p)), params), cfg)
    out["mu"] = _moments(state.mu, cfg)
    out["nu"] = _moments(state.nu, cfg)
    block = params["blocks"][0]
    out["wq_local"] = (list(block["attn"]["wq"].to_local().shape)
                       if "attn" in block else None)
    return out


def _args(case, store, **kw):
    args = ptrain.parser().parse_args(
        ["--arch", case["arch"], "--device", "cpu", "--batch", "4",
         "--seq", "16", "--lr", "3e-3", "--warmup", "2", "--data-shards",
         "2", "--ckpt-codec", "raw", "--log-every", "1", "--store",
         str(store)])
    return argparse.Namespace(**{**vars(args), **kw})


def run_restore_case(case, out_dir: Path):
    """launch.train on a (2, 1) mesh for 2 steps (a checkpoint at 2), then
    its state restored at (2, 1) and at (1, 2) by each rank region-wise,
    then --resume one step at (1, 2)."""
    cfg = _config(case)
    store = out_dir / "store"
    first = ptrain.run(_args(case, store, mesh_data=2, steps=2,
                             ckpt_every=2), cfg)
    saved = {"params": convert.params_to_numpy(opt.tree_map(
        lambda p: torch.from_numpy(_full(p)), first["params"]), cfg),
        "mu": _moments(first["opt_state"].mu, cfg),
        "nu": _moments(first["opt_state"].nu, cfg)}
    out = {"saved": saved, "history": first["history"]}
    for key, kw in (("same", {"mesh_data": 2}), ("other", {"mesh_model": 2})):
        tr = ptrain.Trainer(_args(case, store, steps=2, **kw), cfg)
        tr.restore(2)
        out[key] = {
            "read": dict(tr.ckpt.read_stats),
            "params": convert.params_to_numpy(opt.tree_map(
                lambda p: torch.from_numpy(_full(p)), tr.params), cfg),
            "mu": _moments(tr.opt_state.mu, cfg),
            "nu": _moments(tr.opt_state.nu, cfg),
            "step": int(tr.opt_state.step),
            "wq_local": list(
                tr.params["blocks"][0]["attn"]["wq"].to_local().shape)}
    resumed = ptrain.run(_args(case, store, mesh_model=2, steps=3,
                               resume=True), cfg)
    out["resumed"] = {"history": resumed["history"],
                      "step": int(resumed["opt_state"].step)}
    return out


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, cases_file, out_dir = sys.argv[3], sys.argv[4], Path(
        sys.argv[5])
    cases = pickle.loads(Path(cases_file).read_bytes())
    pmesh.init_distributed("cpu", init_method=f"file://{init_file}",
                           rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        for case in cases:
            if case["data"] * case["model"] != world:
                continue
            if case["kind"] == "restore":
                out = run_restore_case(case, out_dir / case["name"])
            else:
                mesh = pmesh.make_local_mesh(case["data"], case["model"],
                                             device="cpu")
                out = run_step_case(case, mesh)
            (out_dir / f"{case['name']}.{rank}.pkl").write_bytes(
                pickle.dumps(out))
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
