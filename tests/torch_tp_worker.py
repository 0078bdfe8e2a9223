"""One rank of the gloo runs in ``tests/test_torch_tp.py`` (not a test
module: it imports no JAX, so that a rank starts in a few seconds).

    python tests/torch_tp_worker.py RANK WORLD INIT_FILE CASES OUT_DIR

Joins a gloo process group of WORLD ranks through the file store
INIT_FILE, runs each case of the pickled CASES list whose mesh fits the
world, and writes what it measured as ``OUT_DIR/<case>.<rank>.pkl``.  A
case is a dict: ``name``, ``kind`` ("step", "prefill", "gather" or
"decode"), the mesh
(``data``, ``model``), the config (``arch``, ``change``), ``lr``, the
initial parameters in the JAX layout (``params``, numpy), the ``tokens``
and a ``frontend`` (or None).  A step case records the first step's
gradients gathered whole, its metrics, and the parameters after one
step; a prefill case the logits, this rank's vocabulary columns gathered
over the model axis; a gather case, for every layer, the largest
difference between ``sharding.gather_layer`` and the gather-whole path
(``sharding.gather`` and the compute slice; in the backward, the
gradient padded to the whole leaf and ``sharding.reduce_to``); a decode
case (also ``batch``, ``prompt``, ``steps``, ``max_len``,
``cache_shard``) each step's logits of this rank's rows, the greedy
tokens, and the decode state gathered whole.
"""

import datetime
import pickle
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import build, common  # noqa: E402
from repro_torch.train import OptimizerConfig  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.checkpoint import flatten_with_path  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from torch_mesh_worker import _config, _full  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=120)


def _placed(case, cfg, mesh, opt_cfg=None):
    """The case's parameters (and with ``opt_cfg`` their optimizer state)
    as DTensors in the rule table's placements, and this rank's rows of
    its batch."""
    params = convert.params_from_numpy(case["params"], cfg, "cpu",
                                       torch.float32)
    state = None
    if opt_cfg is not None:
        state = opt.init(params, opt_cfg, convert.reference_shapes(cfg))
    params = opt.tree_map(shd.distribute, params,
                          shd.param_shardings(mesh, params))
    if state is not None:
        sh = shd.opt_state_shardings(mesh, state)
        state = opt.AdamState(
            step=state.step,
            mu=ptrain._moment_map(shd.distribute, state.mu, sh.mu),
            nu=ptrain._moment_map(shd.distribute, state.nu, sh.nu))
    rows = {"tokens": case["tokens"], "labels": case["tokens"]}
    if case["frontend"] is not None:
        rows["frontend"] = case["frontend"]
    axes = ptrain.rows_axes(mesh, len(case["tokens"]))
    rows = ptrain.rank_rows(rows, mesh, axes)
    batch = {k: torch.from_numpy(v) for k, v in rows.items()}
    return params, state, batch, axes


def run_step_case(case, mesh):
    cfg = _config(case)
    model = build(cfg, device="cpu")
    opt_cfg = OptimizerConfig(learning_rate=case["lr"], warmup_steps=1)
    params, state, batch, axes = _placed(case, cfg, mesh, opt_cfg)
    step = ptrain.make_mesh_train_step(model, opt_cfg, mesh, axes)
    grads, gm = step.grads(params, batch)
    full = opt.tree_map(lambda g, p: torch.from_numpy(_full(shd.from_local(
        g, shd.sharding_of(p), tuple(p.shape)))), grads, params)
    out = {"axes": axes, "rows": len(batch["tokens"]),
           "grads": convert.params_to_numpy(full, cfg),
           "grad_metrics": {k: float(v) for k, v in gm.items()}}
    params, state, m = step(params, state, batch)
    out["metrics"] = {k: float(v) for k, v in m.items()}
    out["params"] = convert.params_to_numpy(
        opt.tree_map(lambda p: torch.from_numpy(_full(p)), params), cfg)
    return out


def run_prefill_case(case, mesh):
    cfg = _config(case)
    model = build(cfg, device="cpu")
    params, _, batch, _ = _placed(case, cfg, mesh)
    inputs = {k: v for k, v in batch.items() if k != "labels"}
    mm = ptrain.MeshModel(model, mesh)
    with torch.no_grad():
        logits, _ = mm.forward(params, **inputs)
        whole = common.all_gather_dim(logits, logits.dim() - 1,
                                      mm.tp.group, mm.tp.size)
    return {"columns": logits.shape[-1], "logits": whole.numpy().copy()}


def _upstream(shape, *seed):
    g = torch.Generator().manual_seed(zlib.crc32(repr(seed).encode()))
    return torch.randn(shape, generator=g)


def run_gather_case(case, mesh):
    """Each layer through ``gather_layer`` and back, against the
    gather-whole path.  The upstream gradient of a slice is the rank's own
    (seeded by its mesh coordinate: partial over every axis); that of a
    whole leaf the same on every rank of the model axis, as the layers
    make it (partial over the data axis only, or over both for
    ``PARTIAL_GRAD``)."""
    cfg = _config(case)
    model = build(cfg, device="cpu")
    params, _, _, axes = _placed(case, cfg, mesh)
    mm = ptrain.MeshModel(model, mesh, axes)
    layers = mm.layers(mm.local(params))
    d, m = mesh.get_coordinate()
    worst = {"forward": 0.0, "backward": 0.0}
    entries = [(k, i, v) for k, v in layers.items()
               for i, v in (enumerate(v) if isinstance(v, list)
                            else [(None, v)])]
    for key, i, shards in entries:
        whole = params[key] if i is None else params[key][i]
        local = opt.tree_map(
            lambda t: t.detach().clone().requires_grad_(), shards.local)
        out = mm.tp.gather(common.Shards(local, shards.plan))
        flat = list(zip(flatten_with_path(whole), opt.tree_leaves(out),
                        opt.tree_leaves(shards.plan)))
        grads = []
        for n, ((path, dt), got, plan) in enumerate(flat):
            full = shd.gather(dt)
            want = full if plan.compute is None else shd._take(
                full, *plan.compute)
            worst["forward"] = max(worst["forward"],
                                   float((got - want).abs().max()))
            sliced = plan.compute is not None or plan.sum_model
            grads.append(_upstream(tuple(got.shape), key, i, n, d,
                                   m if sliced else -1))
        back = torch.autograd.grad(opt.tree_leaves(out),
                                   opt.tree_leaves(local), grads)
        for ((path, dt), got, plan), g, b in zip(flat, grads, back):
            padded = g
            if plan.compute is not None:
                dim, ranges = plan.compute
                padded = torch.zeros(plan.shape)
                at = 0
                for a, z in ranges:
                    padded.narrow(dim, a, z - a).copy_(g.narrow(dim, at,
                                                                z - a))
                    at += z - a
            sliced = plan.compute is not None or plan.sum_model
            want = shd.reduce_to(padded, shd.sharding_of(dt),
                                 axes + (("model",) if sliced else ()))
            worst["backward"] = max(worst["backward"],
                                    float((b - want).abs().max()))
    return worst


def _cache_leaves(state):
    """A decode state's tensors gathered whole, by path (lists and
    NamedTuples), as numpy."""
    out = {}
    for path, t in flatten_with_path(state):
        if isinstance(t, torch.Tensor):
            key = "/".join(str(k) for k in path)
            out[key] = shd.gather(t).float().numpy().copy()
    return out


def run_decode_case(case, mesh):
    """The case's prompt fed token by token through ``make_mesh_decode_step``
    on its cache layout, then ``steps`` greedy tokens: this rank's rows,
    each step's logits, the tokens, and the state gathered whole."""
    cfg = _config(case)
    model = build(cfg, device="cpu")
    params, _, _, _ = _placed(case, cfg, mesh)
    prompt = case["tokens"][:case["batch"], :case["prompt"]]
    axes = ptrain.rows_axes(mesh, len(prompt))
    index = ptrain.rank_rows({"i": np.arange(len(prompt))}, mesh,
                             axes)["i"]
    step = ptrain.make_mesh_decode_step(model, mesh, axes,
                                        cache_shard=case["cache_shard"])
    mm = step.model
    memory = None
    if cfg.is_encdec:
        front = torch.from_numpy(case["frontend"][index])
        with torch.no_grad():
            memory = mm.encode(params, front)
    state = mm.init_decode(params, len(index), case["max_len"],
                           memory=memory)
    tokens = torch.from_numpy(prompt[index])
    logits, generated = [], []
    token = tokens[:, :1]
    for t in range(case["prompt"] + case["steps"]):
        if t < case["prompt"]:
            token = tokens[:, t:t + 1]
        else:
            generated.append(token)
        state, out = step(params, state, token)
        logits.append(out.numpy().copy())
        token = out[:, -1:, :cfg.vocab_size].argmax(dim=-1).to(torch.int32)
    with torch.no_grad():
        greedy = greedy_generate(mm, params, tokens, case["steps"],
                                 case["max_len"],
                                 frontend=None if memory is None
                                 else torch.from_numpy(
                                     case["frontend"][index]))
    return {"rows": index, "logits": np.stack(logits, axis=1),
            "tokens": torch.cat(generated, dim=1).numpy(),
            "greedy": greedy.numpy(), "state": _cache_leaves(state),
            "lengths": [c.length for c in (
                state.self_kv if cfg.is_encdec else state)
                if hasattr(c, "length") and isinstance(c.length, int)]}


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
            mesh = pmesh.make_local_mesh(case["data"], case["model"],
                                         device="cpu")
            run = {"prefill": run_prefill_case, "gather": run_gather_case,
                   "step": run_step_case,
                   "decode": run_decode_case}[case["kind"]]
            out = run(case, mesh)
            (out_dir / f"{case['name']}.{rank}.pkl").write_bytes(
                pickle.dumps(out))
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
