"""The port's composite kernel module (repro_torch.kernels) against the JAX
package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  The
JAX side runs its Pallas kernel in interpret mode and its jnp oracle; the
port is given CPU tensors, so it runs its plain PyTorch version (the CUDA
kernel itself is held against that version on the card, in
tests/test_torch_cuda.py and chip_smoke.py).  Tolerances are those of
tests/test_kernels.py: f32 3e-5, bf16 2e-2.
"""

import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import composite as japp
from repro.configs.festivus_imagery import SMOKE as J_SMOKE
from repro.data import imagery as jimagery
from repro.kernels import ref as jref
from repro.kernels.composite import composite_fwd
from repro_torch.apps import composite as papp
from repro_torch.configs.festivus_imagery import SMOKE
from repro_torch.kernels import backend, build, ops, ref
from repro_torch.kernels import composite as kcomposite

TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _stack(shape, seed):
    rng = np.random.default_rng(seed)
    T, H, W, _ = shape
    return (rng.random(shape, dtype=np.float32),
            rng.random((T, H, W), dtype=np.float32))


def _same_values(jx, dtype):
    """The JAX array's values as a torch tensor of the same dtype."""
    return torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))


@pytest.mark.parametrize("shape", [(4, 16, 24, 3), (7, 32, 48, 4),
                                   (1, 8, 128, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_composite_matches_jax_kernel_and_oracle(shape, dtype):
    x, w = _stack(shape, seed=7)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    got = ref.composite(_same_values(jx, dtype), _same_values(jw, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == shape[1:]
    tol = TOL[dtype]
    pallas = composite_fwd(jx, jw, block_h=min(8, shape[1]), interpret=True)
    for want in (pallas, jref.composite(jx, jw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_composite_zero_weights_finite():
    x = torch.ones((3, 8, 8, 2))
    w = torch.zeros((3, 8, 8))
    out = ops.composite(x, w)
    assert torch.isfinite(out).all()
    assert float(out.abs().max()) == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_composite_weights_match_jax(seed):
    rng = np.random.default_rng(seed)
    score, nir, red = (rng.random((3, 16, 24), dtype=np.float32)
                       for _ in range(3))
    want = jref.composite_weights(None, jnp.asarray(score), nir=jnp.asarray(nir),
                                  red=jnp.asarray(red))
    got = ref.composite_weights(torch.from_numpy(score),
                                nir=torch.from_numpy(nir),
                                red=torch.from_numpy(red))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_cloud_score_matches_jax(seed):
    imgs, _ = jimagery.scene_stack(jimagery.SceneSpec(
        tile_px=32, temporal_depth=4, cloud_cover=0.6, seed=seed))
    want = japp.cloud_score(imgs, J_SMOKE)
    got = papp.cloud_score(torch.from_numpy(imgs), SMOKE)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
    assert (want > 0).any(), "the stack should hold some cloud"


def test_ops_on_cpu_runs_plain_version_without_launching():
    x, w = (torch.from_numpy(a) for a in _stack((4, 8, 16, 4), seed=2))
    backend.reset_launch_counts()
    auto = ops.composite(x, w)
    plain = ops.composite(x, w, impl="ref")
    assert torch.equal(auto, plain)
    assert torch.equal(auto, ref.composite(x, w))
    with pytest.raises(ValueError, match="CUDA"):
        ops.composite(x, w, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.composite(x, w, impl="pallas")
    assert backend.launch_counts()["composite"] == 0
    assert kcomposite.launches.count == 0


def _bad_inputs(case):
    x = torch.rand((3, 8, 16, 4))
    w = torch.rand((3, 8, 16))
    if case == "weights_shape":
        return x, w[:, :4]
    if case == "too_many_channels":
        return torch.rand((3, 8, 16, 9)), w
    if case == "images_dtype":
        return x.to(torch.float16), w
    if case == "weights_dtype":
        return x, w.to(torch.bfloat16)
    if case == "not_4d":
        return x[0], w
    if case == "non_contiguous":
        return x.transpose(1, 2), w.transpose(1, 2)
    if case == "cpu_tensors":
        return x, w
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["weights_shape", "too_many_channels",
                                  "images_dtype", "weights_dtype", "not_4d",
                                  "non_contiguous", "cpu_tensors"])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w = _bad_inputs(case)
    before = kcomposite.launches.count
    with pytest.raises((ValueError, TypeError)):
        kcomposite.composite(x, w)
    assert kcomposite.launches.count == before


def test_nvcc_command_targets_sm90a_without_fast_math():
    cmd = build.nvcc_command(Path("k.cu"), Path("libk.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    for flag in ("-O3", "-shared", "-std=c++17", "-fPIC"):
        assert flag in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert "composite" in build.source_names()
    path = build.library_path("composite")
    assert path == build.library_path("composite")  # stable hash
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libcomposite-") and path.suffix == ".so"


def test_resolve_device_has_no_cpu_fallback(monkeypatch):
    assert backend.resolve_device("cpu") == torch.device("cpu")
    assert backend.resolve_device(torch.device("cpu")) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        backend.resolve_device("cuda")
    with pytest.raises(ValueError):
        backend.resolve_device("meta")


def test_launch_counter_is_thread_safe():
    """The campaign's worker threads launch concurrently: no lost update."""
    counter = backend.LaunchCounter("test_counter")
    interval = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert backend.launch_counts()["test_counter"] == 64000
        backend.reset_launch_counts()
        assert counter.count == 0
    finally:
        sys.setswitchinterval(interval)
        backend.LaunchCounter._registry.pop("test_counter", None)
