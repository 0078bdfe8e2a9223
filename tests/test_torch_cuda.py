"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they skip where there is no sm_90 card or no nvcc, and
run on the card with ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``.  chip_smoke.py holds the same kernels against
the same plain versions at the main path's full sizes.
"""

import dataclasses

import pytest
import torch

from repro_torch.apps import calibration as pcal
from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore
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


# the enc-dec and VLM paths' shapes (B, Hq, Hkv, Sq, Sk, D, causal), as
# chip_smoke.py's FLASH_CASES names them: seamless's encoder, decoder self-
# and cross-attention (prefill and one decode step), an internvl2-1b layer,
# a gemma-7b layer; batch cut to 1-2
MODEL_ATTN_CASES = [
    ("seamless_enc", (2, 16, 16, 512, 512, 64, False)),
    ("seamless_dec_self", (1, 16, 16, 2048, 2048, 64, True)),
    ("seamless_cross", (2, 16, 16, 2048, 512, 64, False)),
    ("seamless_cross_decode", (4, 16, 16, 1, 512, 64, False)),
    ("internvl_layer", (1, 14, 2, 2048, 2048, 64, True)),
    ("gemma_layer", (1, 16, 16, 2048, 2048, 256, True)),
]


@pytest.mark.parametrize("name,case", MODEL_ATTN_CASES,
                         ids=[n for n, _ in MODEL_ATTN_CASES])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_the_model_paths_shapes(card, name, case,
                                                          dtype):
    """q, k and v as the attention layers hand them over: transposed
    [B, S, H, D] views of the projections (the cross K/V of
    ``encode_memory_kv`` too, sequence stride Hkv * D)."""
    B, Hq, Hkv, Sq, Sk, D, causal = case
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=card,
                           dtype=dtype).transpose(1, 2)
               for H, S in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
    before = kflash.launches.count
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kflash.launches.count == before + 1
    assert got.shape == (B, Hq, Sq, D) and got.is_contiguous()
    torch.testing.assert_close(
        got.float(), ref.attention_chunked(q, k, v, causal=causal).float(),
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


@pytest.mark.parametrize("shards", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_lse_kernel_on_shards_of_a_decode_memory(card, shards, dtype):
    """A decode step's cross-attention over 512 frames split into shards of
    64 or 32 keys (under the kernel's key tile): the kernel with its
    log-sum-exp on each shard (one launch each, the tail masked), merged
    by ``ops.combine_lse``, against the plain version over the whole
    memory; each shard's log-sum-exp against ``ref.attention_lse``."""
    g = torch.Generator(device=card).manual_seed(shards)
    q = torch.randn((4, 16, 1, 64), generator=g, device=card, dtype=dtype)
    k = torch.randn((4, 16, 512, 64), generator=g, device=card, dtype=dtype)
    v = torch.randn((4, 16, 512, 64), generator=g, device=card, dtype=dtype)
    n = 512 // shards
    before = kflash.launches.count
    pieces = [ops.flash_attention_lse(q, k[:, :, i:i + n], v[:, :, i:i + n],
                                      causal=False)
              for i in range(0, 512, n)]
    torch.cuda.synchronize()
    assert kflash.launches.count == before + shards
    for i, (_, lse) in zip(range(0, 512, n), pieces):
        torch.testing.assert_close(
            lse, ref.attention_lse(q, k[:, :, i:i + n], causal=False),
            rtol=TOL[dtype], atol=TOL[dtype])
    got = ops.combine_lse(torch.stack([o for o, _ in pieces]),
                          torch.stack([lse for _, lse in pieces]))
    torch.testing.assert_close(got.float(), ref.attention(
        q, k, v, causal=False).float(), rtol=TOL[dtype], atol=TOL[dtype])


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


def test_moe_prefill_on_the_card_launches_flash_once_per_layer(card):
    """dbrx-smoke: flash once per attention layer, none in decode; the
    logits against the plain run (attention_impl="chunked"), greedy
    tokens identical twice."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import greedy_generate, make_prefill

    cfg = dataclasses.replace(get_config("dbrx-132b", "smoke"),
                              attention_impl="auto")
    model = build(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_attention"] == cfg.num_layers
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    want = make_prefill(plain)(params, tokens=tokens)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95
    backend.reset_launch_counts()
    a = greedy_generate(model, params, tokens[:, :8], 8, max_len=17)
    b = greedy_generate(model, params, tokens[:, :8], 8, max_len=17)
    assert torch.equal(a, b)
    assert backend.launch_counts()["flash_attention"] == 0


def test_jamba_prefill_on_the_card_launches_each_kernel_per_sublayer(card):
    """jamba-smoke: flash once per attention sublayer (2), the SSD once per
    mamba sublayer (6); the logits against the plain run (both kernels'
    plain versions), greedy tokens identical twice."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import greedy_generate, make_prefill

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b", "smoke"),
                              attention_impl="auto")
    model = build(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens)
    torch.cuda.synchronize()
    counts = backend.launch_counts()
    assert counts["flash_attention"] == 2 and counts["ssd_scan"] == 6
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    want = make_prefill(plain)(params, tokens=tokens, ssd_impl="chunked")
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95
    backend.reset_launch_counts()
    a = greedy_generate(model, params, tokens[:, :8], 8, max_len=17)
    b = greedy_generate(model, params, tokens[:, :8], 8, max_len=17)
    assert torch.equal(a, b)
    assert backend.launch_counts() == {k: 0 for k in counts}


def test_seamless_on_the_card_launches_flash_in_every_attention(card):
    """seamless-smoke: flash once per encoder layer and twice per decoder
    layer (self and cross) in a prefill; in generation once per encoder
    layer and once per decoder layer and step (cross-attention, one query
    row).  The logits against the plain run, greedy tokens identical
    twice."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import greedy_generate, make_prefill

    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2", "smoke"),
                              attention_impl="auto")
    model = build(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    frames = torch.randn((2, 48, cfg.frontend_dim), device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens, frontend=frames)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_attention"] == (
        cfg.enc_layers + 2 * cfg.num_layers)
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    want = make_prefill(plain)(params, tokens=tokens, frontend=frames)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95
    backend.reset_launch_counts()
    a = greedy_generate(model, params, tokens[:, :8], 8, max_len=17,
                        frontend=frames)
    b = greedy_generate(model, params, tokens[:, :8], 8, max_len=17,
                        frontend=frames)
    assert torch.equal(a, b)
    assert backend.launch_counts()["flash_attention"] == 2 * (
        cfg.enc_layers + 16 * cfg.num_layers)


def test_internvl_prefill_with_prefix_on_the_card(card):
    """internvl-smoke with its 8 patch embeddings before 56 tokens: flash
    once per layer, logits over F + S positions against the plain run."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    cfg = dataclasses.replace(get_config("internvl2-1b", "smoke"),
                              attention_impl="auto")
    model = build(cfg)
    params = model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 56), device=card)
    patches = torch.randn((2, cfg.frontend_tokens, cfg.frontend_dim),
                          device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens, frontend=patches)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_attention"] == cfg.num_layers
    assert logits.shape[1] == cfg.frontend_tokens + 56
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    want = make_prefill(plain)(params, tokens=tokens, frontend=patches)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95


def test_qwen_prefill_on_the_card_launches_flash_once_per_layer(card):
    """qwen1.5-4b-smoke (QKV biases, as many KV heads as query heads):
    flash once per layer in a prefill, the logits against the plain
    run's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    cfg = dataclasses.replace(get_config("qwen1.5-4b", "smoke"),
                              attention_impl="auto")
    assert cfg.qkv_bias and cfg.num_heads == cfg.num_kv_heads
    model = build(cfg)
    params = model.init(0)
    for layer in params["blocks"]:  # biases that move the scores
        for name in ("bq", "bk", "bv"):
            layer["attn"][name].normal_(0.0, 0.5)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    backend.reset_launch_counts()
    logits = make_prefill(model)(params, tokens=tokens)
    torch.cuda.synchronize()
    assert backend.launch_counts()["flash_attention"] == cfg.num_layers
    plain = build(dataclasses.replace(cfg, attention_impl="chunked"))
    want = make_prefill(plain)(params, tokens=tokens)
    agree = (logits.argmax(-1) == want.argmax(-1)).float().mean()
    assert float(agree) > 0.95


def test_calibration_on_the_card_is_bit_identical_to_the_cpu(card):
    cs = ChunkStore(Festivus(InMemoryObjectStore()), "raw")
    pcal.make_raw_scene(cs, "s", 1024, 1024, seed=4)
    raw = cs.open("s/dn").read_all()
    meta = pcal.SceneMeta.from_json(cs.fs.read("raw/s/meta.json").decode())
    rect, got = pcal.calibrate_scene(raw, meta, card)
    want_rect, want = pcal.calibrate_scene(raw, meta, "cpu")
    assert rect == want_rect == (64, 64, 960, 960)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    out_card = ChunkStore(cs.fs, "card")
    out_cpu = ChunkStore(cs.fs, "cpu")
    assert (pcal.process_scene(cs, out_card, "s", tile_px=256, device=card)
            == pcal.process_scene(cs, out_cpu, "s", tile_px=256,
                                  device="cpu"))
    for name in out_cpu.list_arrays():
        assert (out_card.open(name).read_all().tobytes()
                == out_cpu.open(name).read_all().tobytes()), name


# ---------------------------------------------------------------------------
# training: the flash backward, autograd through the wrappers, the pipeline
# ---------------------------------------------------------------------------
#: the backward kernel's outputs against ref.attention_bwd: max-abs error
#: within BWD_TOL times max(1, the largest |value|), and relative L2.  bf16
#: rounds P and dS to bf16 as the products' operands and dq, dk, dv once
#: (2^-8 relative each); f32 differs from the plain version's f32 only in
#: the order of its sums and in expf
BWD_TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}
BWD_REL_L2 = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

# the forward's cases plus the backward's own: D = 16 and 32, Sq < Sk
# causal and full, one query row; D = 256 with GQA at a ragged length (the
# warpgroups split D); causal Sq < Sk crossing the 128-key tile edge
BWD_CASES = ATTN_CASES + [
    (2, 4, 2, 333, 333, 16, True),
    (1, 4, 4, 100, 300, 32, False),
    (1, 6, 2, 70, 130, 64, True),
    (1, 8, 2, 333, 333, 256, True),
    (1, 8, 2, 190, 260, 128, True),
]
#: two runs of the bf16 backward: dk and dv bit-identical (each block sums
#: its keys' gradients in a fixed order); dq within this many times
#: max(1, max |dq|) of the other run (its steps' f32 adds into dq_acc land
#: in the order the blocks reach them, then dq is rounded to bf16 once: two
#: runs may round a value to neighbouring bf16 numbers, 2^-8 apart)
BWD_DQ_RUN_SPREAD = 2 ** -7


def _rel_l2(got, want):
    d = (got.float() - want.float()).double().norm()
    return float(d / want.float().double().norm().clamp_min(1e-30))


def _hold_bwd(got, want, dtype, what):
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == w.shape and a.is_contiguous()
        scale = max(1.0, float(w.float().abs().max()))
        err = float((a.float() - w.float()).abs().max())
        assert err <= BWD_TOL[dtype] * scale, (what, name, err, scale)
        assert _rel_l2(a, w) <= BWD_REL_L2[dtype], (what, name, _rel_l2(a, w))


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_kernel_matches_plain_version(card, case, dtype):
    causal = case[-1]
    q, k, v = _attn_inputs(card, case, dtype)
    g = torch.Generator(device=card).manual_seed(9)
    do = torch.randn(q.shape, generator=g, device=card, dtype=dtype)
    out, lse = kflash.flash_attention_with_lse(q, k, v, causal=causal)
    before = kflash.bwd_launches.count
    got = kflash.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert kflash.bwd_launches.count == before + 1
    _hold_bwd(got, ref.attention_bwd(q, k, v, do, causal=causal), dtype,
              case)


@pytest.mark.parametrize("case", [(2, 32, 8, 512, 512, 128, True),
                                  (1, 8, 2, 333, 333, 256, True),
                                  (2, 8, 2, 300, 300, 64, False)])
def test_flash_attention_bwd_kernel_runs_agree(card, case):
    """dk and dv are bit-identical from run to run; dq agrees within
    BWD_DQ_RUN_SPREAD (the order of its f32 adds varies)."""
    causal = case[-1]
    q, k, v = _attn_inputs(card, case, torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(9)
    do = torch.randn(q.shape, generator=g, device=card, dtype=torch.bfloat16)
    out, lse = kflash.flash_attention_with_lse(q, k, v, causal=causal)
    first = kflash.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    second = kflash.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2],
                                                            second[2])
    spread = float((first[0].float() - second[0].float()).abs().max())
    scale = max(1.0, float(first[0].float().abs().max()))
    assert spread <= BWD_DQ_RUN_SPREAD * scale, (spread, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_lse_matches_plain_log_sum_exp(card, dtype):
    q, k, v = _attn_inputs(card, (2, 8, 2, 300, 330, 128, True), dtype)
    out, lse = kflash.flash_attention_with_lse(q, k, v, causal=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                     k.float().repeat_interleave(4, dim=1)) * 128 ** -0.5
    hidden = torch.arange(330, device=card)[None, :] > (
        torch.arange(300, device=card)[:, None] + 30)
    want = torch.logsumexp(s.masked_fill(hidden, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(out, kflash.flash_attention(q, k, v, causal=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_autograd_matches_the_plain_versions_autograd(
        card, dtype):
    """ops.flash_attention under autograd goes through FlashAttentionFn:
    one forward and one backward launch, and the gradients of a loss of
    the output equal autograd's through the plain version."""
    B, Hq, Hkv, S, D = 2, 8, 2, 200, 64
    g = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn((B, S, H, D), generator=g, device=card,
                           dtype=dtype).transpose(1, 2).requires_grad_()
               for H in (Hq, Hkv, Hkv))
    w = torch.randn((B, Hq, S, D), generator=g, device=card, dtype=dtype)
    before = (kflash.launches.count, kflash.bwd_launches.count)
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out.float() * w.float()).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert (kflash.launches.count, kflash.bwd_launches.count) == (
        before[0] + 1, before[1] + 1)
    want_out = ops.flash_attention(q, k, v, causal=True, impl="ref")
    want = torch.autograd.grad((want_out.float() * w.float()).sum(),
                               (q, k, v))
    _hold_bwd([t.contiguous() for t in got], want, dtype, "autograd")


def test_kernels_without_a_backward_raise_under_autograd(card):
    """composite and grad_mag have no backward: they refuse autograd (the
    SSD has one now: test_ssd_under_autograd_launches_forward_and_backward)."""
    images = torch.rand((2, 8, 8, 3), device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.composite(images, torch.rand((2, 8, 8), device=card))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.grad_mag(images, torch.ones((2, 8, 8), dtype=torch.bool,
                                        device=card))


def test_prefetch_loader_places_batches_on_the_card(card):
    import numpy as np

    from repro_torch.data import PrefetchLoader

    batches = ({"tokens": np.full((2, 8), i, dtype=np.int32)}
               for i in range(5))
    got = list(PrefetchLoader(batches, depth=2, device=card))
    assert [int(b["tokens"][0, 0]) for b in got] == list(range(5))
    assert all(b["tokens"].device.type == "cuda" for b in got)


def test_train_step_on_the_card_launches_forward_and_backward(card):
    """A llama3-8b-smoke train step with the kernel and remat: per layer
    one forward, one recompute and one backward launch; loss and updated
    parameters near the plain-attention step's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt

    cfg = dataclasses.replace(get_config("llama3-8b", "smoke"),
                              attention_impl="auto", remat=True,
                              dtype="float32")
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    batch = {"tokens": tokens, "labels": tokens}
    results = []
    for impl in ("auto", "chunked"):
        model = build(dataclasses.replace(cfg, attention_impl=impl))
        params = model.init(0, param_dtype=torch.float32)
        state = opt.init(params, opt_cfg)
        backend.reset_launch_counts()
        params, state, m = make_train_step(model, opt_cfg)(params, state,
                                                           batch)
        torch.cuda.synchronize()
        results.append((params, m, backend.launch_counts()))
    (p_k, m_k, n_k), (p_p, m_p, n_p) = results
    assert n_k["flash_attention"] == 2 * cfg.num_layers
    assert n_k["flash_attention_bwd"] == cfg.num_layers
    assert n_p["flash_attention"] == n_p["flash_attention_bwd"] == 0
    assert abs(float(m_k["loss"]) - float(m_p["loss"])) < 1e-4
    torch.testing.assert_close(p_k["blocks"][0]["attn"]["wq"],
                               p_p["blocks"][0]["attn"]["wq"],
                               rtol=1e-4, atol=1e-5)


def _train_step_launches(cfg, batch):
    """One f32 train step with remat through the kernels and one through
    the plain versions -> (each step's metrics and launches)."""
    from repro_torch.models import build
    from repro_torch.train import OptimizerConfig, make_train_step
    from repro_torch.train import optimizer as opt

    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=1)
    results = []
    for impl in ("auto", "chunked"):
        model = build(dataclasses.replace(cfg, attention_impl=impl))
        params = model.init(0, param_dtype=torch.float32)
        backend.reset_launch_counts()
        _, _, m = make_train_step(model, opt_cfg)(
            params, opt.init(params, opt_cfg), batch)
        torch.cuda.synchronize()
        results.append((m, backend.launch_counts()))
    return results


def test_seamless_train_step_with_frames_launches_forward_and_backward(card):
    """seamless-smoke trained on 32 frames under 64 decoder tokens: per
    step 2 (enc_layers + 2 num_layers) forward launches (forward and remat
    recompute; the cross-attention's 64 queries on 32 frames, no mask) and
    enc_layers + 2 num_layers backward; the loss near the plain step's."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("seamless-m4t-large-v2", "smoke"),
                              attention_impl="auto", remat=True,
                              dtype="float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=card)
    batch = {"tokens": tokens, "labels": tokens,
             "frontend": torch.randn((2, 32, cfg.frontend_dim),
                                     device=card)}
    (m_k, n_k), (m_p, n_p) = _train_step_launches(cfg, batch)
    calls = cfg.enc_layers + 2 * cfg.num_layers
    assert n_k["flash_attention"] == 2 * calls
    assert n_k["flash_attention_bwd"] == calls
    assert n_p["flash_attention"] == n_p["flash_attention_bwd"] == 0
    assert abs(float(m_k["loss"]) - float(m_p["loss"])) < 1e-4
    assert abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"])) < 1e-3 * \
        float(m_p["grad_norm"])


def test_gemma_train_step_at_head_dim_256_launches_forward_and_backward(
        card):
    """gemma-smoke widened to head_dim 256 (the kernels' D = 256
    instantiations, forward and backward) in one train step."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("gemma-7b", "smoke"), head_dim=256,
                              attention_impl="auto", remat=True,
                              dtype="float32")
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=card)
    (m_k, n_k), (m_p, n_p) = _train_step_launches(
        cfg, {"tokens": tokens, "labels": tokens})
    assert n_k["flash_attention"] == 2 * cfg.num_layers
    assert n_k["flash_attention_bwd"] == cfg.num_layers
    assert n_p["flash_attention"] == n_p["flash_attention_bwd"] == 0
    assert abs(float(m_k["loss"]) - float(m_p["loss"])) < 1e-4
    assert abs(float(m_k["grad_norm"]) - float(m_p["grad_norm"])) < 1e-3 * \
        float(m_p["grad_norm"])


# ---------------------------------------------------------------------------
# the SSD's backward
# ---------------------------------------------------------------------------
#: the backward kernel's six gradients against ref.ssd_scan_bwd: max-abs
#: error within SSD_BWD_TOL x max(1, the largest |value|) (the forward's
#: SSD_TOL, scaled as the flash backward's BWD_TOL is) and relative L2
#: (over max(1, |ref|)) within SSD_BWD_REL_L2, chip_smoke.py's gates and
#: their reasons: f32 the orders of the sums and of the cumulative sum
#: inside exp(); bf16 the gradients' one rounding and the lo·lo terms the
#: split drops (tests/test_torch_ssd_bwd.py models it)
SSD_BWD_TOL = {torch.float32: 5e-4, torch.bfloat16: 2e-2}
SSD_BWD_REL_L2 = {torch.float32: 1e-4, torch.bfloat16: 2e-3}
SSD_GRADS = ("dx", "ddt", "da", "db", "dc", "dd")
# B, L, H, P, N: tests/test_kernels.py:137-141, ragged L (1, 63, 1000), P
# = 128, a mamba2-like layer; then head tiles of the per-chunk kernels
# (kssd.BWD_HEAD_TILE heads a block) cut short: H = 3 (one tile of 3) and
# H = 81 (ten of 8 and one of 1), each at P = 128, and a last chunk of 8
# tokens across a tile of 8 heads and one of 4
SSD_BWD_CASES = [(2, 128, 4, 16, 8), (1, 256, 8, 32, 16), (2, 64, 2, 64, 128),
                 (1, 1, 3, 64, 128), (2, 63, 4, 32, 16), (1, 1000, 2, 64, 128),
                 (1, 192, 2, 128, 128), (1, 200, 3, 128, 16),
                 (2, 512, 16, 64, 128), (1, 256, 3, 128, 128),
                 (1, 130, 81, 128, 16), (2, 200, 12, 64, 128)]


def _ssd_bwd_inputs(card, case, dtype, seed=0, grouped=True):
    """x, dt, a, b, c, d and dy; b and c [B, L, 1, N] (one group) with
    ``grouped``, else [B, L, H, N]."""
    x, dt, a, b, c, d = _ssd_inputs(card, case, dtype, seed, grouped)
    if grouped:
        b, c = b[:, :, :1], c[:, :, :1]
    g = torch.Generator(device=card).manual_seed(seed + 100)
    dy = torch.randn(x.shape, generator=g, device=card, dtype=dtype)
    return x, dt, a, b, c, d, dy


def _hold_ssd_bwd(got, want, dtype, what):
    for name, g, w in zip(SSD_GRADS, got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        assert g.is_contiguous() and bool(torch.isfinite(g).all()), (what,
                                                                     name)
        scale = max(1.0, float(w.float().abs().max()))
        err = float((g.float() - w.float()).abs().max())
        assert err <= SSD_BWD_TOL[dtype] * scale, (what, name, err, scale)
        l2 = float((g.double() - w.double()).norm()) / max(
            1.0, float(w.double().norm()))
        assert l2 <= SSD_BWD_REL_L2[dtype], (what, name, l2)


@pytest.mark.parametrize("grouped", [True, False], ids=["group", "per_head"])
@pytest.mark.parametrize("skip", [True, False], ids=["d_skip", "no_d"])
@pytest.mark.parametrize("case", SSD_BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_matches_plain_version(card, case, dtype, skip,
                                              grouped):
    x, dt, a, b, c, d, dy = _ssd_bwd_inputs(card, case, dtype,
                                            grouped=grouped)
    d = d if skip else None
    before = kssd.bwd_launches.count
    got = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    torch.cuda.synchronize()
    assert kssd.bwd_launches.count == before + 1
    _hold_ssd_bwd(got, ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d),
                  dtype, case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_strongly_decaying_head_gives_no_nan(card, dtype):
    x, dt, a, b, c, d, dy = _ssd_bwd_inputs(card, (1, 300, 2, 64, 128),
                                            dtype)
    a = torch.full_like(a, -20.0)
    dt = 1.0 + 4.0 * torch.rand(dt.shape, device=card)
    got = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _hold_ssd_bwd(got, ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d),
                  dtype, "strong decay")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_takes_dy_rows_off_16_bytes(card, dtype):
    """dy as a view whose rows do not start on 16 bytes (the wrapper asks
    only for stride 1 along P): bf16 rows are read 2 bytes at a time in
    place of cp.async, and the six gradients equal those of a contiguous
    copy, bit for bit."""
    x, dt, a, b, c, d, dy = _ssd_bwd_inputs(card, (2, 200, 12, 64, 128),
                                            dtype)
    wide = torch.zeros(dy.shape[:3] + (dy.shape[3] + 1,), device=card,
                       dtype=dtype)
    wide[..., 1:] = dy
    view = wide[..., 1:]
    assert view.data_ptr() % 16 and view.stride(3) == 1
    got = kssd.ssd_scan_bwd(x, dt, a, b, c, view, d_skip=d)
    want = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_bwd_kernel_runs_are_bit_identical(card, dtype):
    """No atomics: two runs give the same six gradients, bit for bit."""
    x, dt, a, b, c, d, dy = _ssd_bwd_inputs(card, (2, 700, 8, 128, 128),
                                            dtype)
    first = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    second = kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_under_autograd_launches_forward_and_backward(card, dtype):
    """ops.ssd under autograd goes through SsdScanFn: one forward and one
    backward launch, and the gradients of a loss of the output equal
    autograd's through the plain chunked version, b and c summed over the
    heads of their group.  (This replaces the test that the SSD kernel
    refused autograd, before it had a backward.)"""
    x, dt, a, b, c, d, _ = _ssd_bwd_inputs(card, (2, 256, 4, 64, 16), dtype)
    leaves = [t.detach().requires_grad_() for t in (x, dt, a, b, c, d)]
    g = torch.Generator(device=card).manual_seed(5)
    w = torch.randn(x.shape, generator=g, device=card)
    before = (kssd.launches.count, kssd.bwd_launches.count)
    y = ops.ssd(*leaves[:5], d_skip=leaves[5])
    assert y.grad_fn is not None
    got = torch.autograd.grad((y.float() * w).sum(), leaves)
    torch.cuda.synchronize()
    assert (kssd.launches.count, kssd.bwd_launches.count) == (
        before[0] + 1, before[1] + 1)
    # the reference in f32 on the same numbers, rounded once: autograd on
    # bf16 leaves rounds each head's db and dc (and x's two cotangents) to
    # bf16 before summing them (tests/test_torch_ssd_bwd.py)
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    want_y = ops.ssd(*ref_leaves[:5], d_skip=ref_leaves[5], impl="chunked")
    want = torch.autograd.grad((want_y * w.to(dtype).float()).sum(),
                               ref_leaves)
    _hold_ssd_bwd(got, [u.to(t.dtype) for u, t in zip(want, leaves)], dtype,
                  "autograd")  # x, dt, a, b, c, d


def test_launch_train_runs_an_ssm_arch_on_the_card(card):
    """launch.train trains mamba2-2.7b-smoke on the card: every step
    launches the SSD's forward (and its remat recompute) and backward in
    each layer; the nll stays finite."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train as ptrain

    cfg = get_config("mamba2-2.7b", "smoke")
    args = ptrain.parser().parse_args([
        "--arch", "mamba2-2.7b", "--steps", "3", "--batch", "2", "--seq",
        "128", "--ckpt-every", "3", "--log-every", "1"])
    backend.reset_launch_counts()
    out = ptrain.run(args)
    counts = backend.launch_counts()
    L = cfg.num_layers
    per_step = 2 * L if cfg.remat else L
    assert counts["ssd_scan"] == 3 * per_step, counts
    assert counts["ssd_scan_bwd"] == 3 * L, counts
    assert all(torch.isfinite(torch.tensor(h["nll"])) for h in out["history"])
