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

The wrappers' refusals (the backward kernel on CPU tensors and on o, do
or lse it does not take; the kernels without a backward under autograd)
are seen through their input checks, whose device check comes last.  The
bf16 backward kernel's design is modelled here: its walk over (key tile,
query tile) pairs covers every visible pair once, heavy tiles first, and
its tiled arithmetic (padded query rows with lse2 = +inf, the mask applied
only where a tile crosses the causal diagonal or the Sk edge, dQ added
step by step into an f32 accumulator) gives ``ref.attention_bwd``'s
gradients.  The kernel itself is held against ``ref.attention_bwd`` on the
card (tests/test_torch_cuda.py, chip_smoke.py's ``flash_bwd`` phase).
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


@pytest.mark.parametrize("what", ["o_shape", "do_strided", "do_dtype",
                                  "lse_dtype", "lse_shape"])
def test_backward_kernel_refuses_o_do_lse_it_does_not_take(what):
    case = (1, 2, 1, 16, 16, 32, True)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    o, lse = q.clone(), torch.zeros((1, 2, 16))
    if what == "o_shape":
        o = o[:, :, :8]
    elif what == "do_strided":
        do = do.transpose(1, 2).contiguous().transpose(1, 2)
    elif what == "do_dtype":
        do = do.double()
    elif what == "lse_dtype":
        lse = lse.double()
    else:
        lse = lse[:, :, :8]
    before = kflash.bwd_launches.count
    with pytest.raises(ValueError, match="must be contiguous"):
        kflash.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert kflash.bwd_launches.count == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 64, 100, 4096])
def test_backward_workspace_shapes_and_dtypes(dtype, Sq):
    """delta (and, for bf16, lse2 and dq_acc's rows) padded to whole
    64-row steps; f32 needs neither lse2 nor dq_acc."""
    q = torch.empty((2, 3, Sq, 32), dtype=dtype)
    delta, lse2, dq_acc = kflash.bwd_workspace(q)
    pad = -(-Sq // kflash.BWD_BLOCK_M) * kflash.BWD_BLOCK_M
    assert kflash.BWD_BLOCK_M == 64
    assert delta.shape == (2, 3, pad) and delta.dtype == torch.float32
    if dtype == torch.float32:
        assert lse2 is None and dq_acc is None
    else:
        assert lse2.shape == (2, 3, pad) and lse2.dtype == torch.float32
        assert dq_acc.shape == (2, 3, pad, 32)
        assert dq_acc.dtype == torch.float32 and dq_acc.is_contiguous()


# ---------------------------------------------------------------------------
# the bf16 backward kernel's design, modelled on the CPU
# (csrc/flash_attention_bwd.cu: BwdTile, flash_bwd_kernel_bf16)
# ---------------------------------------------------------------------------
BLOCK_M = kflash.BWD_BLOCK_M


def _block_n(D):
    """Keys of a block: 128, split 64 / 64 between the two consumer
    warpgroups; 64 at D = 256, where the warpgroups split D."""
    return 64 if D == 256 else 128


def _walk(Sq, Sk, causal, D):
    """The kernel's walk in launch order (grid.y is the key tile): each key
    tile's first key and the query tiles its producer streams (for each
    query head of the group)."""
    bn, offset = _block_n(D), Sk - Sq
    m_tiles = -(-Sq // BLOCK_M)
    for n0 in range(0, Sk, bn):
        m_first = max(0, n0 - offset) // BLOCK_M if causal else 0
        yield n0, range(m_first, m_tiles)


def _warpgroup_keys(n0, D):
    return [n0] if D == 256 else [n0, n0 + 64]


WALK_CASES = [
    (4096, 4096, True, 128), (2048, 2048, True, 256), (2048, 512, False, 64),
    (200, 328, True, 128), (190, 260, True, 128), (333, 333, True, 256),
    (333, 333, True, 16), (100, 300, False, 32), (1, 777, True, 64),
    (70, 130, True, 64), (129, 129, False, 256),
]


@pytest.mark.parametrize("case", WALK_CASES,
                         ids=lambda c: "x".join(map(str, c[:2]))
                         + ("_causal" if c[2] else "_full") + f"_d{c[3]}")
def test_backward_walk_covers_every_visible_pair_once_heavy_first(case):
    Sq, Sk, causal, D = case
    bn = _block_n(D)
    seen = np.zeros((Sq, Sk), np.uint8)
    lengths = []
    for n0, tiles in _walk(Sq, Sk, causal, D):
        lengths.append(len(tiles))
        for m in tiles:
            block = seen[m * BLOCK_M:(m + 1) * BLOCK_M, n0:n0 + bn]
            assert block.size
            block += 1
    rows = np.arange(Sq)[:, None]
    keys = np.arange(Sk)[None, :]
    visible = (keys <= rows + Sk - Sq) if causal else np.ones((Sq, Sk), bool)
    assert (seen[visible] == 1).all()
    # every visited (query tile, key tile) has a visible pair: the walk
    # skips what the mask hides
    for n0, tiles in _walk(Sq, Sk, causal, D):
        for m in tiles:
            assert visible[m * BLOCK_M:(m + 1) * BLOCK_M, n0:n0 + bn].any()
    assert lengths == sorted(lengths, reverse=True)


def _tiled_bwd(q, k, v, do, causal):
    """The bf16 kernel's arithmetic in f64: P from lse2 (the log-sum-exp
    times log2 e, +inf on the padded query rows, whose Q and dO rows TMA
    fills with zeros), the mask applied only on tiles that cross the causal
    diagonal or the Sk edge, dV and dK summed in the block over the group,
    dQ added into an f32 accumulator step by step."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group, scale, offset = Hq // Hkv, D ** -0.5, Sk - Sq
    bn = _block_n(D)
    log2e = 1.0 / np.log(2.0)
    q, k, v, do = (t.double() for t in (q, k, v, do))
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(group, dim=1)) * scale
    if causal:
        hidden = torch.arange(Sk)[None, :] > torch.arange(Sq)[:, None] + offset
        s = s.masked_fill(hidden, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1),
                     v.repeat_interleave(group, dim=1))
    pad = -(-Sq // BLOCK_M) * BLOCK_M
    kpad = -(-Sk // bn) * bn
    lse2 = torch.full((B, Hq, pad), float("inf"), dtype=torch.float64)
    lse2[..., :Sq] = lse * log2e
    delta = torch.zeros((B, Hq, pad), dtype=torch.float64)
    delta[..., :Sq] = (do * o).sum(-1)
    qp, dop = (torch.zeros((B, Hq, pad, D), dtype=torch.float64)
               for _ in range(2))
    qp[:, :, :Sq], dop[:, :, :Sq] = q, do
    kp, vp = (torch.zeros((B, Hkv, kpad, D), dtype=torch.float64)
              for _ in range(2))
    kp[:, :, :Sk], vp[:, :, :Sk] = k, v
    dq_acc = torch.zeros((B, Hq, Sq, D), dtype=torch.float64)
    dk, dv = torch.zeros_like(kp), torch.zeros_like(vp)
    for n0, tiles in _walk(Sq, Sk, causal, D):
        for nw in _warpgroup_keys(n0, D):
            keys = slice(nw, nw + 64)
            for hh in range(group):
                for m in tiles:
                    m0 = m * BLOCK_M
                    rows = slice(m0, m0 + BLOCK_M)
                    for b in range(B):
                        for hk in range(Hkv):
                            h = hk * group + hh
                            st = kp[b, hk, keys] @ qp[b, h, rows].T
                            dpt = vp[b, hk, keys] @ dop[b, h, rows].T
                            pt = torch.exp2(st * scale * log2e
                                            - lse2[b, h, rows][None, :])
                            if nw + 64 > Sk or (causal
                                                and nw + 63 > m0 + offset):
                                key = nw + torch.arange(64)[:, None]
                                qq = m0 + torch.arange(BLOCK_M)[None, :]
                                hid = (key >= Sk) | (causal
                                                     & (key > qq + offset))
                                pt = pt.masked_fill(hid, 0.0)
                            dst = pt * (dpt - delta[b, h, rows][None, :])
                            dv[b, hk, keys] += pt @ dop[b, h, rows]
                            dk[b, hk, keys] += dst @ qp[b, h, rows]
                            n = min(BLOCK_M, Sq - m0)
                            dq_acc[b, h, m0:m0 + n] += (
                                dst.T @ kp[b, hk, keys])[:n]
    return (dq_acc * scale, dk[:, :, :Sk] * scale, dv[:, :, :Sk])


@pytest.mark.parametrize("case", [
    (1, 4, 2, 190, 260, 128, True),
    (1, 2, 1, 150, 150, 256, True),
    (2, 2, 2, 100, 300, 32, False),
    (1, 4, 1, 1, 130, 64, True),
    (1, 2, 2, 70, 130, 16, True),
    (1, 2, 1, 129, 129, 64, False),
], ids=_ids)
def test_backward_kernel_arithmetic_model_matches_the_plain_version(case):
    causal = case[-1]
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    got = _tiled_bwd(q, k, v, do, causal)
    want = ref.attention_bwd(q, k, v, do, causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _f32(w), **TOL["float32"])


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
    """The SSD kernel has a backward now (SsdScanFn): under autograd its
    checks no longer refuse, they go on to the device check, with grad mode
    on or off, as for inputs that need no gradient."""
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.check_inputs(*_ssd_inputs(True))
    with torch.no_grad():
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
