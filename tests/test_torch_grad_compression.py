"""``train/grad_compression.py`` on gloo ranks against the JAX package's
``shard_map`` of the same functions.

A module fixture starts a world of 2 and a world of 4 ranks once, each rank
a process of ``tests/torch_compression_worker.py`` joined through a file
store, with an ``init_process_group`` timeout and a join timeout (the
``tests/test_torch_mesh.py`` pattern).  The JAX side runs in a subprocess
on 4 host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``),
``repro.train.grad_compression`` inside ``shard_map`` over an axis of 2 or
4 devices.  Both sides take the same per-rank gradient trees, made from a
numpy seed, with a total size that the world does not divide (so the wire
pads).

* n = 2: the result is bit-identical (a two-term f32 sum does not depend
  on its order).
* n = 4: the first hop's int8 codes, sent and received, are equal; the
  result is within f32 3e-5, except where a requantized code differs by
  one (the four-term sum in another order lands on the other side of a
  rounding boundary): those are counted, and each is held within its
  chunk's one step.
* Three steps of the error-feedback carry: the carried error within four
  f32 ulps (XLA fuses g - q·s into one multiply-add), each result within
  one requantization step.
* A ``pod`` axis group of a (2, 2) mesh gives the n = 2 result.
* The JAX package's two invariants (``tests/test_train.py:104-121``) on
  the port alone.
"""

import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.train import grad_compression as gc

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_compression_worker.py"
JOIN_TIMEOUT_S = 240
F32 = 3e-5
WORLDS = (2, 4)
#: leaves of one rank's gradient tree: 651 elements, which neither world
#: divides
SHAPES = {"emb": (16, 24), "w": (13, 20), "b": (7,)}
EF_STEPS = 3


def _tree(rng, rank):
    """Rank ``rank``'s gradients: normal, scaled by 1 + rank so that the
    ranks' scales differ."""
    return {k: (rng.standard_normal(s) * (1.0 + rank)).astype(np.float32)
            for k, s in SHAPES.items()}


def _inputs():
    rng = np.random.default_rng(7)
    grads = [_tree(rng, r) for r in range(4)]
    steps = [[_tree(rng, r) for r in range(4)] for _ in range(EF_STEPS)]
    return {"grads": grads, "steps": steps}


JAX_SIDE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.train import grad_compression as gc

    data = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))

        def stacked(trees):
            return {k: jnp.stack([jnp.asarray(t[k]) for t in trees[:n]])
                    for k in trees[0]}

        def run(fn, *trees):
            f = jax.jit(jax.shard_map(
                lambda *a: jax.tree.map(lambda x: x[None],
                                        fn(*jax.tree.map(lambda x: x[0], a))),
                mesh=mesh, in_specs=P("pod"), out_specs=P("pod")))
            return jax.tree.map(np.asarray, f(*[stacked(t) for t in trees]))

        def wire(tree):
            flat = jnp.concatenate([tree[k].reshape(-1)
                                    for k in sorted(tree)])
            pad = (-flat.size) % n
            xp = jnp.pad(flat, (0, pad)).reshape(n, -1)
            q, scale = gc.quantize_per_tensor(xp)
            q_recv = jax.lax.all_to_all(q, "pod", split_axis=0,
                                        concat_axis=0, tiled=False)
            scales = jax.lax.all_gather(scale, "pod")
            partial = jnp.sum(q_recv.astype(jnp.float32)
                              * scales[:, None], axis=0) / n
            q2, s2 = gc.quantize_per_tensor(partial)
            return {"q": q, "scale": scale, "q_recv": q_recv, "q2": q2,
                    "s2": s2,
                    "result": gc.compressed_psum_mean(tree, "pod", n)}

        res = {"wire": run(wire, data["grads"])}
        ef, error = [], run(gc.init_error_state, data["grads"])
        error = [{k: v[r] for k, v in error.items()} for r in range(n)]
        for step in data["steps"]:
            def one(g, e):
                g_eff, new = gc.with_error_feedback(g, e)
                return {"result": gc.compressed_psum_mean(g_eff, "pod", n),
                        "error": new}
            got = run(one, step, error)
            ef.append(got)
            error = [{k: v[r] for k, v in got["error"].items()}
                     for r in range(n)]
        res["ef"] = ef
        out[n] = res
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """-> (port: {world: [each rank's output]}, jax: {n: outputs stacked
    over the ranks})."""
    tmp = tmp_path_factory.mktemp("compression")
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(_inputs()))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        init = tmp / f"init{world}"
        procs += [subprocess.Popen(
            [sys.executable, str(WORKER), str(r), str(world), str(init),
             str(inputs), str(tmp)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
    jax_env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_out = tmp / "jax.pkl"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(inputs), str(jax_out)],
        env=jax_env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    logs = []
    try:
        for p in procs + [jax_proc]:
            out, _ = p.communicate(timeout=JOIN_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs + [jax_proc]:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs + [jax_proc]), "\n".join(
        log[-3000:] for log in logs)
    port = {w: [pickle.loads((tmp / f"{w}.{r}.pkl").read_bytes())
                for r in range(w)] for w in WORLDS}
    return port, pickle.loads(jax_out.read_bytes())


@pytest.mark.parametrize("n", WORLDS)
def test_first_hop_codes_equal_jax(sides, n):
    """Each rank's local codes and scale, and the codes all_to_all hands
    it (row j: rank j's row for this rank), equal the JAX side's."""
    port, jax_side = sides
    want = jax_side[n]["wire"]
    for r, got in enumerate(port[n]):
        w = got["wire"]
        np.testing.assert_array_equal(w["q"], want["q"][r])
        assert np.float32(w["scale"]) == want["scale"][r]
        np.testing.assert_array_equal(w["q_recv"], want["q_recv"][r])


def test_two_ranks_bit_identical(sides):
    port, jax_side = sides
    want = jax_side[2]["wire"]
    for r, got in enumerate(port[2]):
        np.testing.assert_array_equal(got["wire"]["q2"], want["q2"][r])
        for k in SHAPES:
            np.testing.assert_array_equal(got["wire"]["result"][k],
                                          want["result"][k][r])


def _split(flat_chunks):
    """[n, chunk] rows of the wire -> the leaves of the unpadded tree."""
    flat = np.concatenate([np.asarray(c).reshape(-1) for c in flat_chunks])
    out, off = {}, 0
    for k in sorted(SHAPES):
        size = int(np.prod(SHAPES[k]))
        out[k] = flat[off:off + size].reshape(SHAPES[k])
        off += size
    return out


def test_four_ranks_within_one_requantization_step(sides):
    """The result within f32 3e-5, except where a requantized code differs
    by one: those elements are counted, each within its chunk's step."""
    port, jax_side = sides
    want = jax_side[4]["wire"]
    n = 4
    q2_port = np.stack([got["wire"]["q2"] for got in port[n]])
    q2_jax = np.asarray(want["q2"])
    code_diff = np.abs(q2_port.astype(np.int32) - q2_jax.astype(np.int32))
    assert code_diff.max() <= 1
    s2 = np.asarray(want["s2"], np.float32)
    steps = _split([np.full(q2_jax.shape[1], s2[j]) for j in range(n)])
    flipped = _split(code_diff == 1)
    count = 0
    for r, got in enumerate(port[n]):
        for k in SHAPES:
            a, b = got["wire"]["result"][k], want["result"][k][r]
            diff = np.abs(a - b)
            flip = flipped[k].astype(bool)
            assert (diff[~flip] <= F32 * np.maximum(1.0, np.abs(b[~flip]))
                    ).all(), k
            assert (diff[flip] <= steps[k][flip] * (1 + F32)).all(), k
            count += int(flip.sum())
    # every rank gathers the same chunks: a flipped code shows on each
    assert count == n * int((code_diff == 1).sum())


@pytest.mark.parametrize("n", WORLDS)
def test_error_feedback_carry_matches_jax(sides, n):
    """Three steps of with_error_feedback then compressed_psum_mean.  The
    carried error within four f32 ulps of the step's largest |g_eff|: XLA
    contracts g - q·s into one fused multiply-add on the CPU where PyTorch
    rounds the product first, and the next step's g_eff, scale and codes
    inherit that last bit.  The reduced result within one requantization
    step of its chunk's scale: compiled with the carry, XLA also fuses the
    peers' sum (q0·s0 + q1·s1) into a multiply-add, so even at n = 2 a
    requantized code may land one step over (the wire alone is held bit
    for bit at n = 2 above)."""
    port, jax_side = sides
    data = _inputs()
    for step in range(EF_STEPS):
        want = jax_side[n]["ef"][step]
        for r, got in enumerate(port[n]):
            g_max = max(np.abs(v).max() for v in data["steps"][step][r].values())
            prev = (port[n][r]["ef"][step - 1]["error"] if step else None)
            if prev is not None:
                g_max += max(np.abs(v).max() for v in prev.values())
            ulps = 4 * np.spacing(np.float32(g_max))
            for k in SHAPES:
                e = np.abs(got["ef"][step]["error"][k] - want["error"][k][r])
                assert e.max() <= ulps, (step, k, e.max(), ulps)
                a, b = got["ef"][step]["result"][k], want["result"][k][r]
                limit = np.abs(b).max() / 127.0 * (1 + F32)
                assert np.abs(a - b).max() <= limit, (step, k)


def test_pod_axis_group_gives_the_two_rank_result(sides):
    port, _ = sides
    for r, got in enumerate(port[4]):
        for k in SHAPES:
            np.testing.assert_array_equal(got["pod"][k],
                                          port[2][r % 2]["wire"]["result"][k])


def test_ranks_agree_on_the_result(sides):
    port, _ = sides
    for w in WORLDS:
        for got in port[w][1:]:
            for k in SHAPES:
                np.testing.assert_array_equal(
                    got["wire"]["result"][k],
                    port[w][0]["wire"]["result"][k])


def test_compression_error_feedback_invariant():
    """INVARIANT: g_eff - residual == dequant(quant(g_eff))."""
    rng = np.random.default_rng(1)
    grads = {"w": torch.from_numpy(
        rng.standard_normal((16, 16)).astype(np.float32))}
    err0 = gc.init_error_state(grads)
    g_eff, new_err = gc.with_error_feedback(grads, err0)
    q, s = gc.quantize_per_tensor(g_eff["w"])
    recon = gc.dequantize_per_tensor(q, s)
    np.testing.assert_allclose((g_eff["w"] - new_err["w"]).numpy(),
                               recon.numpy(), rtol=1e-6, atol=1e-6)


def test_compression_roundtrip_error_small():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    q, s = gc.quantize_per_tensor(x)
    err = (gc.dequantize_per_tensor(q, s) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-9


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_jax(dtype):
    """quantize_per_tensor's codes and scale equal the JAX function's,
    ties at .5 included (both round half to even)."""
    import jax.numpy as jnp

    from repro.train import grad_compression as jgc

    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, 127.0],
                     np.float32) * (x[8:].__abs__().max() / 127.0)
    xt = torch.from_numpy(x).to(dtype)
    q, s = gc.quantize_per_tensor(xt.float())
    jq, js = jgc.quantize_per_tensor(jnp.asarray(xt.float().numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
