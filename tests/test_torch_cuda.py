"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no sm_90 card or no nvcc, and
run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  chip_smoke.py holds the same kernels against
the same plain versions at the main path's full sizes.
"""

import pytest
import torch

from repro_torch.kernels import backend, build, ops, ref
from repro_torch.kernels import composite as kcomposite
from repro_torch.kernels import grad_mag as kgrad

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != backend.REQUIRED_CAPABILITY:
        pytest.skip("needs an sm_90 card")
    try:
        build.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    return backend.resolve_device()


@pytest.mark.parametrize("shape,xdt,wdt", [
    ((4, 16, 24, 3), torch.float32, torch.float32),
    ((7, 37, 53, 4), torch.float32, torch.float32),
    ((1, 8, 128, 1), torch.float32, torch.float32),
    ((3, 17, 33, 8), torch.float32, torch.float32),
    ((7, 32, 48, 4), torch.bfloat16, torch.bfloat16),
    ((5, 9, 40, 4), torch.bfloat16, torch.float32),
])
def test_composite_kernel_matches_plain_version(card, shape, xdt, wdt):
    g = torch.Generator(device=card).manual_seed(0)
    T, H, W, _ = shape
    x = torch.rand(shape, generator=g, device=card, dtype=xdt)
    w = torch.rand((T, H, W), generator=g, device=card, dtype=wdt)
    before = kcomposite.launches.count
    got = ops.composite(x, w)
    torch.cuda.synchronize()
    assert kcomposite.launches.count == before + 1
    torch.testing.assert_close(got.float(), ref.composite(x, w).float(),
                               rtol=TOL[xdt], atol=TOL[xdt])


def test_composite_kernel_zero_weights_and_misaligned_view(card):
    x = torch.rand(4 * 8 * 16 * 4 + 1, device=card)[1:].view(4, 8, 16, 4)
    w = torch.zeros((4, 8, 16), device=card)
    out = kcomposite.composite(x, w)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and float(out.abs().max()) == 0.0
    w = torch.rand((4, 8, 16), device=card)
    torch.testing.assert_close(kcomposite.composite(x, w),
                               ref.composite(x, w), rtol=3e-5, atol=3e-5)


def test_composite_kernel_is_deterministic(card):
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.rand((16, 64, 96, 4), generator=g, device=card)
    w = torch.rand((16, 64, 96), generator=g, device=card)
    assert torch.equal(kcomposite.composite(x, w), kcomposite.composite(x, w))


def _grad_inputs(card, shape, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    T, H, W, _ = shape
    x = torch.rand(shape, generator=g, device=card, dtype=dtype)
    v = torch.rand((T, H, W), generator=g, device=card) < 0.7
    return x, v


@pytest.mark.parametrize("shape,dtype", [
    ((3, 16, 16, 2), torch.float32),
    ((5, 24, 40, 4), torch.float32),
    ((7, 37, 53, 3), torch.float32),
    ((1, 8, 128, 1), torch.float32),
    ((3, 1, 40, 2), torch.float32),
    ((3, 40, 1, 2), torch.float32),
    ((3, 17, 33, 8), torch.float32),
    ((7, 32, 48, 4), torch.bfloat16),
])
def test_grad_mag_kernel_matches_plain_version(card, shape, dtype):
    x, v = _grad_inputs(card, shape, dtype)
    before = kgrad.launches.count
    g, c = ops.grad_mag(x, v)
    torch.cuda.synchronize()
    assert kgrad.launches.count == before + 1
    want_g, want_c = ref.grad_mag(x, v)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(g, want_g, rtol=tol, atol=tol)
    assert torch.equal(c, want_c)  # the count is exact


def test_grad_mag_kernel_misaligned_view_and_one_valid_pixel(card):
    shape = (4, 16, 24, 4)
    x = torch.rand(4 * 16 * 24 * 4 + 1, device=card)[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    v = torch.rand((4, 16, 24), device=card) < 0.7
    g, c = kgrad.grad_mag(x, v)
    want_g, want_c = ref.grad_mag(x, v)
    torch.testing.assert_close(g, want_g, rtol=1e-5, atol=1e-5)
    assert torch.equal(c, want_c)
    v = torch.zeros_like(v)
    g, c = kgrad.grad_mag(x, v)
    assert float(g.abs().max()) == 0.0 and float(c.abs().max()) == 0.0
    v[2, 5, 7] = True
    g, c = kgrad.grad_mag(x, v)
    assert float(g[5, 7]) == float(torch.sqrt(torch.tensor(1e-6)))
    assert float(c.sum()) == 1.0 and float(g.sum()) == float(g[5, 7])


def test_grad_mag_kernel_is_deterministic(card):
    x, v = _grad_inputs(card, (16, 64, 96, 4), torch.float32, seed=1)
    a = kgrad.grad_mag(x, v)
    b = kgrad.grad_mag(x, v)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
