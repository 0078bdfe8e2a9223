"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no sm_90 card or no nvcc, and
run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  chip_smoke.py holds the same kernels against
the same plain versions at the main path's full sizes.
"""

import dataclasses

import pytest
import torch

from repro_torch.kernels import backend, build, ops, ref
from repro_torch.kernels import composite as kcomposite
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import grad_mag as kgrad
from repro_torch.kernels import ssd_scan as kssd

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


# B, Hq, Hkv, Sq, Sk, D, causal: tests/test_kernels.py:53-60, then ragged
# lengths and the llama3-8b layer's heads at a short length, then shapes
# across the bf16 kernel's tile edges (128 query rows; 128 keys, 64 at
# D = 256)
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 8, 256, 256, 128, True),
    (1, 4, 1, 128, 384, 64, True),
    (2, 2, 2, 128, 128, 32, False),
    (1, 16, 2, 64, 64, 256, True),
    (1, 4, 2, 1000, 1000, 128, True),
    (3, 5, 5, 1, 777, 64, True),
    (1, 2, 1, 37, 53, 16, False),
    (2, 32, 8, 192, 192, 128, True),
    (1, 16, 2, 1000, 1000, 256, True),
    (2, 32, 8, 200, 328, 128, True),
    (2, 8, 2, 300, 300, 64, True),
]


def _attn_inputs(card, case, dtype, seed=0):
    B, Hq, Hkv, Sq, Sk, D, _ = case
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, Hq, Sq, D), generator=g, device=card, dtype=dtype)
    k = torch.randn((B, Hkv, Sk, D), generator=g, device=card, dtype=dtype)
    # v as the attention layer hands it over: a transposed [B, S, H, D]
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=card,
                    dtype=dtype).transpose(1, 2)
    return q, k, v


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(card, case, dtype):
    causal = case[-1]
    q, k, v = _attn_inputs(card, case, dtype)
    before = kflash.launches.count
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kflash.launches.count == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(
        got.float(), ref.attention(q, k, v, causal=causal).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_transposed_q_k_v(card, dtype):
    """q, k and v all as the attention layer's transposed [B, S, H, D]
    views: both instantiations launch and match the plain version."""
    B, Hq, Hkv, Sq, Sk, D = 2, 8, 2, 300, 300, 64
    g = torch.Generator(device=card).manual_seed(3)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=card,
                           dtype=dtype).transpose(1, 2)
               for H, S in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
    before = kflash.launches.count
    got = kflash.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert kflash.launches.count == before + 1
    torch.testing.assert_close(
        got.float(), ref.attention(q, k, v, causal=True).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_flash_attention_kernel_is_deterministic(card):
    q, k, v = _attn_inputs(card, (2, 8, 2, 300, 300, 128, True),
                           torch.bfloat16, seed=1)
    assert torch.equal(kflash.flash_attention(q, k, v),
                       kflash.flash_attention(q, k, v))


def test_flash_attention_kernel_refuses_what_it_does_not_take(card):
    q, k, v = _attn_inputs(card, (1, 4, 2, 64, 32, 64, True), torch.float32)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        ops.flash_attention(q, k, v, causal=True, impl="pallas")
    q, k, v = _attn_inputs(card, (1, 4, 2, 64, 64, 64, True), torch.float16)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_attention(q, k, v)


def test_prefill_on_the_card_launches_the_kernel_once_per_layer(card):
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    # the smoke config pins attention_impl="ref" for the JAX CPU tests
    cfg = dataclasses.replace(get_config("llama3-8b", "smoke"),
                              attention_impl="auto")
    model = build(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_attention"] == cfg.num_layers
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    want = make_prefill(plain)(params, tokens=tokens)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95


# B, L, H, P, N: tests/test_kernels.py:137-141, ragged lengths, the
# mamba2-2.7b layer's heads at a short length, and P = 128
SSD_CASES = [
    (2, 128, 4, 16, 8),
    (1, 256, 8, 32, 16),
    (2, 64, 2, 64, 128),
    (1, 1, 3, 64, 128),
    (2, 63, 4, 32, 16),
    (1, 1000, 2, 64, 128),
    (2, 160, 80, 64, 128),
    (1, 96, 2, 128, 8),
]
SSD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}


def _ssd_inputs(card, case, dtype, seed=0, grouped=True):
    """dt = softplus(normal), a = -exp(normal), b and c (with ``grouped``)
    one group expanded to every head with stride 0, as the model hands
    them over."""
    B, L, H, P, N = case
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=g, device=card, dtype=dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), generator=g, device=card))
    a = -torch.exp(torch.randn((H,), generator=g, device=card))
    heads = 1 if grouped else H
    b = torch.randn((B, L, heads, N), generator=g, device=card, dtype=dtype)
    c = torch.randn((B, L, heads, N), generator=g, device=card, dtype=dtype)
    d = torch.randn((H,), generator=g, device=card)
    return x, dt, a, b.expand(B, L, H, N), c.expand(B, L, H, N), d


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain_version(card, case, dtype):
    x, dt, a, b, c, d = _ssd_inputs(card, case, dtype)
    before = kssd.launches.count
    got = ops.ssd(x, dt, a, b, c, d_skip=d)
    torch.cuda.synchronize()
    assert kssd.launches.count == before + 1
    assert got.dtype == dtype and got.is_contiguous()
    tol = SSD_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.ssd_scan(x, dt, a, b, c, d_skip=d).float(),
        rtol=tol, atol=tol)


def test_ssd_scan_kernel_contiguous_b_c_and_no_d_skip(card):
    x, dt, a, b, c, _ = _ssd_inputs(card, (2, 200, 4, 64, 128),
                                    torch.float32, seed=1, grouped=False)
    got = kssd.ssd_scan(x, dt, a, b, c)
    torch.testing.assert_close(got, ref.ssd_scan(x, dt, a, b, c),
                               rtol=5e-4, atol=5e-4)


def test_ssd_scan_kernel_strongly_decaying_head_gives_no_nan(card):
    x, dt, a, b, c, d = _ssd_inputs(card, (1, 300, 2, 32, 16),
                                    torch.float32, seed=2)
    a = torch.full_like(a, -float(torch.exp(torch.tensor(3.0))))
    dt = 1.0 + 4.0 * torch.rand(dt.shape, device=card)
    got = kssd.ssd_scan(x, dt, a, b, c, d_skip=d)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref.ssd_scan(x, dt, a, b, c, d_skip=d),
                               rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("skip", [True, False], ids=["d_skip", "no_d"])
@pytest.mark.parametrize("grouped", [True, False], ids=["stride0", "contig"])
@pytest.mark.parametrize("P,N", [(16, 8), (64, 16), (64, 128), (128, 128)])
@pytest.mark.parametrize("L", [1, 127, 128, 129, 2049])
def test_ssd_scan_bf16_kernel_across_chunk_and_tile_edges(card, L, P, N,
                                                          grouped, skip):
    """The bf16 tensor-core path at the edges of its 64-token chunks and
    16x16 tiles: a chunk of one token, one short of two, exactly two, one
    past, and one past 32; b and c shared by every head (stride 0, one c·b
    a chunk) or one per head; with and without the D-skip.  Elementwise
    2e-2 and relative L2 5e-3 (chip_smoke.py's SSD_TOL / SSD_REL_L2)."""
    x, dt, a, b, c, d = _ssd_inputs(card, (1, L, 3, P, N), torch.bfloat16,
                                    seed=L + P + N, grouped=grouped)
    d = d if skip else None
    got = kssd.ssd_scan(x, dt, a, b, c, d_skip=d)
    want = ref.ssd_scan(x, dt, a, b, c, d_skip=d)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    diff = (got.float() - want.float()).norm()
    assert float(diff / want.float().norm()) < 5e-3


def test_ssd_scan_kernel_is_deterministic(card):
    x, dt, a, b, c, d = _ssd_inputs(card, (2, 512, 8, 64, 128),
                                    torch.bfloat16, seed=3)
    assert torch.equal(kssd.ssd_scan(x, dt, a, b, c, d),
                       kssd.ssd_scan(x, dt, a, b, c, d))


def test_ssd_scan_kernel_refuses_what_it_does_not_take(card):
    x, dt, a, b, c, d = _ssd_inputs(card, (1, 64, 2, 64, 16),
                                    torch.float32)
    with pytest.raises(TypeError, match="dtypes"):
        ops.ssd(x.half(), dt, a, b.half(), c.half())
    with pytest.raises(ValueError, match="not in"):
        ops.ssd(x[..., :48], dt, a, b, c)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd(x, dt, a.cpu(), b, c, impl="pallas")


def test_mamba_prefill_on_the_card_launches_the_kernel_once_per_layer(card):
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    cfg = get_config("mamba2-2.7b", "smoke")
    model = build(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens)
    torch.cuda.synchronize()
    assert backend.launch_counts()["ssd_scan"] == cfg.num_layers
    want = make_prefill(model)(params, tokens=tokens, ssd_impl="chunked")
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95
