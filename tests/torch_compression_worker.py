"""One rank of the gloo runs in ``tests/test_torch_grad_compression.py``
(not a test module: it imports no JAX, so that a rank starts in a few
seconds).

    python tests/torch_compression_worker.py RANK WORLD INIT_FILE IN OUT_DIR

Joins a gloo process group of WORLD ranks through the file store
INIT_FILE and reads the pickled IN: ``grads`` (per rank, a dict of numpy
f32 leaves) and ``steps`` (per step, per rank, the same).  Writes
``OUT_DIR/<WORLD>.<RANK>.pkl``:

* ``wire``: the codes and scales of ``compressed_psum_mean`` over the
  world group on ``grads[RANK]`` (the local codes and scale, the codes
  received from ``all_to_all_single``, the requantized chunk and its
  scale) and its result;
* ``ef``: three steps of ``with_error_feedback`` then
  ``compressed_psum_mean`` from ``init_error_state``, each step's result
  and carried error;
* for a world of 4, ``pod``: the result over the ``pod`` axis of a
  (pod 2, data 2) mesh on ``grads[RANK // 2]`` (ranks r and r + 2 share
  a pod group).
"""

import datetime
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import mesh as pmesh  # noqa: E402
from repro_torch.train import grad_compression as gc  # noqa: E402

TIMEOUT = datetime.timedelta(seconds=120)


def _tree(leaves):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in leaves.items()}


def _numpy(tree):
    return {k: v.numpy().copy() for k, v in tree.items()}


def wire(grads, group, n):
    """compressed_psum_mean with its codes and scales recorded."""
    seen, received = [], []
    quantize, all_to_all = gc.quantize_per_tensor, dist.all_to_all_single

    def record_quantize(x):
        q, s = quantize(x)
        seen.append((q.numpy().copy(), float(s)))
        return q, s

    def record_all_to_all(out, inp, **kw):
        all_to_all(out, inp, **kw)
        received.append(out.numpy().copy())

    gc.quantize_per_tensor = record_quantize
    dist.all_to_all_single = record_all_to_all
    try:
        result = gc.compressed_psum_mean(grads, group, n)
    finally:
        gc.quantize_per_tensor, dist.all_to_all_single = quantize, all_to_all
    (q, scale), (q2, s2) = seen
    return {"q": q, "scale": scale, "q_recv": received[0], "q2": q2,
            "s2": s2, "result": _numpy(result)}


def main():
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_file, inputs, out_dir = sys.argv[3], sys.argv[4], Path(sys.argv[5])
    data = pickle.loads(Path(inputs).read_bytes())
    pmesh.init_distributed("cpu", init_method=f"file://{init_file}",
                           rank=rank, world_size=world, timeout=TIMEOUT)
    try:
        out = {"wire": wire(_tree(data["grads"][rank]), None, world)}
        error = gc.init_error_state(_tree(data["grads"][rank]))
        out["ef"] = []
        for step in data["steps"]:
            g_eff, error = gc.with_error_feedback(_tree(step[rank]), error)
            red = gc.compressed_psum_mean(g_eff, None, world)
            out["ef"].append({"result": _numpy(red),
                              "error": _numpy(error)})
        if world == 4:
            mesh = pmesh._make_mesh((2, 2), ("pod", "data"), "cpu")
            out["pod"] = _numpy(gc.compressed_psum_mean(
                _tree(data["grads"][rank // 2]), mesh.get_group("pod"),
                pmesh.axis_size(mesh, "pod")))
        (out_dir / f"{world}.{rank}.pkl").write_bytes(pickle.dumps(out))
    finally:
        pmesh.shutdown()


if __name__ == "__main__":
    main()
