"""The flash-attention backward's plain version and the kernel wrappers
under autograd, on the CPU.

``repro_torch.kernels.ref.attention_bwd`` (the backward kernel's plain
version) is held against two references on the same numpy inputs:
autograd of the port's ``ref.attention`` and ``jax.vjp`` of the JAX
package's ``repro.kernels.ref.attention``.  f32 within 3e-5 (rtol and
atol, tests/test_kernels.py:45-47): both sides compute in f32 and differ
only in the order of their sums.  bf16 inputs within 2e-2: the two
frameworks round the bf16 gradients at other places (JAX rounds the
cotangent of the output's cast, the port once at the end).

The wrappers' refusals (the backward kernel on CPU tensors; the kernels
without a backward under autograd) are seen through their input checks,
whose device check comes last.  The backward kernel itself is held
against ``ref.attention_bwd`` on the card (tests/test_torch_cuda.py,
chip_smoke.py's ``flash_bwd`` phase).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import composite as kcomposite
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import grad_mag as kgrad
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd

# B, Hq, Hkv, Sq, Sk, D, causal: tests/test_kernels.py:53-60 (the D = 256
# case at a shorter length), then ragged lengths, Sq < Sk causal and full,
# one query row
CASES = [
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 8, 64, 64, 128, True),
    (1, 4, 1, 128, 384, 64, True),
    (2, 2, 2, 128, 128, 32, False),
    (1, 4, 2, 32, 32, 256, True),
    (2, 4, 2, 33, 33, 16, True),
    (1, 4, 4, 20, 60, 32, False),
    (1, 6, 2, 17, 45, 16, True),
    (3, 2, 1, 1, 40, 32, True),
]
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(case, seed=11):
    B, Hq, Hkv, Sq, Sk, D, _ = case
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                      (B, Hq, Sq, D))]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32), np.float32)


def _ids(case):
    return "x".join(map(str, case[:-1])) + ("_causal" if case[-1] else "_full")


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_bwd_matches_autograd_of_the_plain_attention(case):
    causal = case[-1]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    got = ref.attention_bwd(q, k, v, do, causal=causal, chunk=16)
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    ref.attention(qa, ka, va, causal=causal).backward(do)
    for g, want in zip(got, (qa.grad, ka.grad, va.grad)):
        assert g.dtype == torch.float32 and g.shape == want.shape
        np.testing.assert_allclose(_f32(g), _f32(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_bwd_matches_jax_grad_of_the_jax_oracle(case, dtype):
    causal = case[-1]
    arrays = _inputs(case)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(DTYPES[dtype][0])
                       for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jref.attention(q, k, v, causal=causal),
                     jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = (torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrays)
    got = ref.attention_bwd(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == DTYPES[dtype][1]
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL[dtype])


def test_attention_bwd_chunks_agree_and_causal_sq_gt_sk_raises():
    case = (1, 4, 2, 50, 50, 32, True)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    whole = ref.attention_bwd(q, k, v, do, causal=True, chunk=1024)
    parts = ref.attention_bwd(q, k, v, do, causal=True, chunk=7)
    for a, b in zip(whole, parts):
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ref.attention_bwd(q, k[:, :, :20], v[:, :, :20], do, causal=True)


def test_flash_attention_on_cpu_tensors_is_differentiable_plain_version():
    """ops.flash_attention takes the plain version for CPU tensors; autograd
    differentiates it to the same gradients as ref.attention_bwd."""
    case = (2, 4, 2, 40, 40, 32, True)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = ops.flash_attention(qa, ka, va, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qa, ka, va), do)
    for g, w in zip(got, ref.attention_bwd(q, k, v, do, causal=True)):
        np.testing.assert_allclose(_f32(g), _f32(w), **TOL["float32"])


def test_backward_kernel_and_its_function_refuse_cpu_tensors():
    case = (1, 2, 1, 16, 16, 32, True)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    lse = torch.zeros((1, 2, 16))
    before = kflash.bwd_launches.count
    with pytest.raises(ValueError, match="CUDA device"):
        kflash.flash_attention_bwd(q, k, v, q, lse, do, causal=True)
    with pytest.raises(ValueError, match="CUDA device"):
        kflash.FlashAttentionFn.apply(q.requires_grad_(), k, v, True)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention(q, k, v, impl="pallas")
    assert kflash.bwd_launches.count == before


def _ssd_inputs(requires_grad):
    rng = np.random.default_rng(3)
    B, L, H, P, N = 1, 16, 2, 16, 8
    x = torch.from_numpy(rng.standard_normal((B, L, H, P), dtype=np.float32))
    dt = torch.from_numpy(rng.random((B, L, H), dtype=np.float32))
    a = -torch.ones(H)
    b = torch.from_numpy(rng.standard_normal((B, L, H, N), dtype=np.float32))
    c = torch.from_numpy(rng.standard_normal((B, L, H, N), dtype=np.float32))
    return x.requires_grad_(requires_grad), dt, a, b, c, torch.ones(H)


def test_ssd_kernel_refuses_autograd_and_names_the_roadmap_item():
    with pytest.raises(RuntimeError, match="ROADMAP.md queue 2 item 1"):
        kssd.check_inputs(*_ssd_inputs(True))
    with torch.no_grad():  # grad mode off: on to the device check
        with pytest.raises(ValueError, match="CUDA device"):
            kssd.check_inputs(*_ssd_inputs(True))
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.check_inputs(*_ssd_inputs(False))


def test_ssd_on_cpu_tensors_is_differentiable_plain_version():
    x, dt, a, b, c, d = _ssd_inputs(True)
    y = ops.ssd(x, dt, a, b, c, d_skip=d, chunk=8)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert g.shape == x.shape and bool(torch.isfinite(g).all())
    assert float(g.abs().sum()) > 0


@pytest.mark.parametrize("kernel", ["composite", "grad_mag"])
def test_imagery_kernels_refuse_autograd(kernel):
    images = torch.rand((2, 8, 8, 3), requires_grad=True)
    other = (torch.rand((2, 8, 8)) if kernel == "composite"
             else torch.ones((2, 8, 8), dtype=torch.bool))
    check = (kcomposite if kernel == "composite" else kgrad).check_inputs
    with pytest.raises(RuntimeError, match="no backward"):
        check(images, other)
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA device"):
            check(images, other)
