"""The port's SSD scan (repro_torch.kernels: ref.ssd_scan,
ref.ssd_scan_chunked, ops.ssd and the ssd_scan kernel's wrapper checks)
against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages (bf16
inputs are the same f32 numbers rounded to bf16 on each side; dt and a are
f32, as the model hands them over).  The JAX side runs its Pallas kernel in
interpret mode and its jnp oracles; the port is given CPU tensors, so it
runs its plain PyTorch versions (the CUDA kernel is held against those on
the card, in tests/test_torch_cuda.py and chip_smoke.py).  Tolerances: f32
5e-4 (tests/test_kernels.py:150), bf16 2e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_scan_fwd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd

# B, L, H, P, N, chunk: tests/test_kernels.py:137-141
SSD_CASES = [
    (2, 128, 4, 16, 8, 32),
    (1, 256, 8, 32, 16, 64),
    (2, 64, 2, 64, 128, 64),  # mamba2-like wide state
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(B, L, H, P, N, seed=0, a_scale=None, dt_max=None):
    """x, dt, a, b, c, d as numpy f32: dt = softplus(normal), a =
    -exp(normal), as tests/test_kernels.py:146-149 draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32)
    a = -np.exp(rng.standard_normal(H)).astype(np.float32)
    if a_scale is not None:
        a = np.full(H, a_scale, np.float32)
    if dt_max is not None:
        dt = rng.uniform(1.0, dt_max, (B, L, H)).astype(np.float32)
    b = rng.standard_normal((B, L, H, N), dtype=np.float32)
    c = rng.standard_normal((B, L, H, N), dtype=np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    return x, dt, a, b, c, d


def _jax(arrays, dtype):
    x, dt, a, b, c, d = arrays
    cast = DTYPES[dtype][0]
    return (jnp.asarray(x).astype(cast), jnp.asarray(dt), jnp.asarray(a),
            jnp.asarray(b).astype(cast), jnp.asarray(c).astype(cast),
            jnp.asarray(d))


def _torch(arrays, dtype):
    x, dt, a, b, c, d = arrays
    cast = DTYPES[dtype][1]
    return (torch.from_numpy(x).to(cast), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(b).to(cast),
            torch.from_numpy(c).to(cast), torch.from_numpy(d))


def _f32(v):
    return np.asarray(v.float() if isinstance(v, torch.Tensor) else v,
                      np.float32)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernel (interpret) and the jnp oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("skip", [False, True], ids=["no_d", "d_skip"])
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_ssd_scan_matches_jax_kernel_and_oracle(case, dtype, skip):
    B, L, H, P, N, chunk = case
    arrays = _inputs(B, L, H, P, N)
    jx, jdt, ja, jb, jc, jd = _jax(arrays, dtype)
    x, dt, a, b, c, d = _torch(arrays, dtype)
    jd, d = (jd, d) if skip else (None, None)
    kernel = ssd_scan_fwd(jx, jdt, ja, jb, jc, chunk=chunk, d_skip=jd,
                          interpret=True)
    oracle = jref.ssd_scan(jx, jdt, ja, jb, jc, d_skip=jd)
    got = ref.ssd_scan(x, dt, a, b, c, d_skip=d)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == (B, L, H, P)
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("skip", [False, True], ids=["no_d", "d_skip"])
@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_ssd_scan_chunked_matches_jax_chunked_and_sequential(
        case, dtype, skip):
    B, L, H, P, N, chunk = case
    arrays = _inputs(B, L, H, P, N, seed=1)
    jx, jdt, ja, jb, jc, jd = _jax(arrays, dtype)
    x, dt, a, b, c, d = _torch(arrays, dtype)
    jd, d = (jd, d) if skip else (None, None)
    want = jref.ssd_scan_chunked(jx, jdt, ja, jb, jc, chunk=chunk, d_skip=jd)
    got = ref.ssd_scan_chunked(x, dt, a, b, c, chunk=chunk, d_skip=d)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(
        _f32(got), _f32(ref.ssd_scan(x, dt, a, b, c, d_skip=d)),
        **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expanded_b_and_c_with_stride_0_along_heads(dtype):
    """b and c as the model hands them over: [B, L, N] expanded to every
    head, stride 0 along H, not copied (ngroups 1)."""
    B, L, H, P, N = 2, 128, 4, 16, 16
    x, dt, a, b, c, d = _inputs(B, L, H, P, N, seed=2)
    b, c = b[:, :, :1], c[:, :, :1]  # one group
    jx, jdt, ja, jb, jc, jd = _jax((x, dt, a, b, c, d), dtype)
    tx, tdt, ta, tb, tc, td = _torch((x, dt, a, b, c, d), dtype)
    tb, tc = tb.expand(B, L, H, N), tc.expand(B, L, H, N)
    assert tb.stride(2) == 0 and tc.stride(2) == 0
    want = jref.ssd_scan(jx, jdt, ja, jnp.broadcast_to(jb, (B, L, H, N)),
                         jnp.broadcast_to(jc, (B, L, H, N)), d_skip=jd)
    for got in (ref.ssd_scan(tx, tdt, ta, tb, tc, d_skip=td),
                ref.ssd_scan_chunked(tx, tdt, ta, tb, tc, chunk=32,
                                     d_skip=td),
                ops.ssd(tx, tdt, ta, tb, tc, d_skip=td)):
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("chunk", [32, 128])
def test_strongly_decaying_head_gives_no_nan(chunk):
    """a = -e^3 with dt up to 5: a dt reaches -100 a token, the cumulative
    sums of a chunk reach -1e4, and exp(cum_i - cum_j) above the diagonal
    would be inf; the plain versions select, as the TPU kernel does."""
    B, L, H, P, N = 1, 256, 2, 16, 8
    arrays = _inputs(B, L, H, P, N, seed=3, a_scale=-np.exp(3.0), dt_max=5.0)
    jx, jdt, ja, jb, jc, jd = _jax(arrays, "float32")
    x, dt, a, b, c, d = _torch(arrays, "float32")
    kernel = ssd_scan_fwd(jx, jdt, ja, jb, jc, chunk=chunk, d_skip=jd,
                          interpret=True)
    got_seq = ref.ssd_scan(x, dt, a, b, c, d_skip=d)
    got_chunked = ref.ssd_scan_chunked(x, dt, a, b, c, chunk=chunk, d_skip=d)
    for got in (got_seq, got_chunked):
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL["float32"])
    # each token forgets the past: y_t = (c_t . b_t) dt_t x_t + d x_t
    diag = (np.einsum("blhn,blhn->blh", arrays[4], arrays[3])
            * arrays[1])[..., None] * arrays[0] + arrays[5][:, None] * arrays[0]
    np.testing.assert_allclose(_f32(got_seq), diag, rtol=5e-4, atol=5e-4)


def test_chunked_raises_where_chunk_does_not_divide_l():
    x, dt, a, b, c, _ = _torch(_inputs(1, 100, 2, 16, 8), "float32")
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ref.ssd_scan_chunked(x, dt, a, b, c, chunk=64)
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        ops.ssd(x, dt, a, b, c, impl="chunked", chunk=64)


# ---------------------------------------------------------------------------
# ops.ssd: the dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("L", [64, 100, 128, 256])
def test_auto_on_cpu_takes_the_path_jax_takes_off_the_tpu(L, monkeypatch):
    """impl="auto" on CPU tensors runs chunked (chunk 128) where 128
    divides L and the sequential recurrence otherwise, exactly where the
    JAX package's ops.ssd does off the TPU (traced eagerly, so its calls can
    be seen)."""
    arrays = _inputs(1, L, 2, 16, 8, seed=4)
    calls = {"port": [], "jax": []}

    def spy(side, name, fn):
        def wrapped(*args, **kwargs):
            calls[side].append((name, kwargs.get("chunk")))
            return fn(*args, **kwargs)
        return wrapped

    for name in ("ssd_scan", "ssd_scan_chunked"):
        monkeypatch.setattr(ref, name, spy("port", name, getattr(ref, name)))
        monkeypatch.setattr(jref, name, spy("jax", name, getattr(jref, name)))
    x, dt, a, b, c, d = _torch(arrays, "float32")
    got = ops.ssd(x, dt, a, b, c, d_skip=d)
    with jax.disable_jit():
        want = jops.ssd(*_jax(arrays, "float32")[:5],
                        d_skip=jnp.asarray(arrays[5]))
    expected = ([("ssd_scan_chunked", 128)] if L % 128 == 0
                else [("ssd_scan", None)])
    assert calls["port"] == calls["jax"] == expected
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


def test_impls_agree_on_cpu():
    x, dt, a, b, c, d = _torch(_inputs(2, 128, 4, 32, 16, seed=5), "float32")
    out = {impl: ops.ssd(x, dt, a, b, c, d_skip=d, impl=impl)
           for impl in ("auto", "ref", "chunked")}
    assert torch.equal(out["auto"], out["chunked"])
    torch.testing.assert_close(out["chunked"], out["ref"], rtol=5e-4,
                               atol=5e-4)


def test_unknown_impl_raises():
    x, dt, a, b, c, _ = _torch(_inputs(1, 8, 2, 16, 8), "float32")
    with pytest.raises(ValueError, match="impl="):
        ops.ssd(x, dt, a, b, c, impl="kernel")


def test_cpu_tensors_under_pallas_raise_and_nothing_falls_back():
    x, dt, a, b, c, d = _torch(_inputs(1, 64, 2, 16, 8), "float32")
    before = kssd.launches.count
    with pytest.raises(ValueError, match="CUDA device"):
        ops.ssd(x, dt, a, b, c, d_skip=d, impl="pallas")
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.ssd_scan(x, dt, a, b, c)
    assert kssd.launches.count == before


# ---------------------------------------------------------------------------
# the kernel wrapper's checks, seen on CPU tensors (the device is checked
# last)
# ---------------------------------------------------------------------------
def _wrapper_inputs(B=1, L=16, H=2, P=16, N=8, dtype=torch.float32):
    x, dt, a, b, c, d = _torch(_inputs(B, L, H, P, N), "float32")
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype), d


@pytest.mark.parametrize("change,error,match", [
    (lambda t: {**t, "x": t["x"][0]}, ValueError, "must be"),
    (lambda t: {**t, "dt": t["dt"][..., None]}, ValueError, "must be"),
    (lambda t: {**t, "a": t["a"][:, None]}, ValueError, "must be"),
    (lambda t: {**t, "b": t["b"][:, :-1]}, ValueError, "do not fit"),
    (lambda t: {**t, "c": t["c"][..., :4]}, ValueError, "do not fit"),
    (lambda t: {**t, "dt": t["dt"][:, :, :1]}, ValueError, "do not fit"),
    (lambda t: {**t, "a": t["a"][:1]}, ValueError, "do not fit"),
    (lambda t: {**t, "d_skip": t["d_skip"][:1]}, ValueError, "d_skip"),
    (lambda t: {**t, "x": t["x"].half()}, TypeError, "dtypes"),
    (lambda t: {**t, "b": t["b"].bfloat16()}, TypeError, "dtypes"),
    (lambda t: {**t, "dt": t["dt"].double()}, TypeError, "dt must be"),
    (lambda t: {**t, "a": t["a"].bfloat16()}, TypeError, "a must be"),
    (lambda t: {**t, "d_skip": t["d_skip"].half()}, TypeError, "d_skip must"),
    (lambda t: {**t, "x": t["x"][..., ::2]}, ValueError, "head dim P=8"),
    (lambda t: {**t, "x": t["x"].transpose(2, 3).contiguous()
                .transpose(2, 3)}, ValueError, "stride 1"),
], ids=["x_rank", "dt_rank", "a_rank", "b_length", "c_state", "dt_heads",
        "a_heads", "d_heads", "x_f16", "b_bf16", "dt_f64", "a_bf16",
        "d_f16", "p_8", "x_strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, error, match):
    x, dt, a, b, c, d = _wrapper_inputs()
    t = change({"x": x, "dt": dt, "a": a, "b": b, "c": c, "d_skip": d})
    with pytest.raises(error, match=match):
        kssd.check_inputs(**t)


@pytest.mark.parametrize("P,N,ok", [
    (16, 8, True), (32, 16, True), (64, 128, True), (128, 128, True),
    (48, 16, False), (256, 16, False), (64, 12, False), (64, 64, False),
])
def test_wrapper_head_and_state_dims(P, N, ok):
    x, dt, a, b, c, d = _wrapper_inputs(P=P, N=N)
    if ok:  # every check but the device passes
        with pytest.raises(ValueError, match="CUDA device"):
            kssd.check_inputs(x, dt, a, b, c, d)
    else:
        with pytest.raises(ValueError, match="not in"):
            kssd.check_inputs(x, dt, a, b, c, d)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("variant", ["full", "smoke"])
def test_every_ssm_config_fits_the_kernel(arch, variant):
    from repro_torch.configs import get_config

    cfg = get_config(arch, variant)
    assert cfg.ssm_head_dim in kssd.HEAD_DIMS
    assert cfg.ssm_state in kssd.STATE_DIMS


def test_wrapper_takes_stride_0_views_and_bf16():
    x, dt, a, b, c, d = _wrapper_inputs(H=4, dtype=torch.bfloat16)
    b = b[:, :, :1].expand_as(b)
    c = c[:, :, :1].expand_as(c)
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.check_inputs(x, dt, a, b, c, d)


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _bf16_terms(v, split):
    """v (f32) as the tensor cores take it: bf16(v), plus bf16(v - hi) where
    the kernel splits the operand into two MMAs; in f64."""
    hi = v.to(torch.bfloat16).double()
    return hi + (v.double() - hi).to(torch.bfloat16).double() if split else hi


def kernel_arithmetic(x, dt, a, b, c, d_skip=None, split=True):
    """A plain model of the bf16 kernel's rounding (csrc/ssd_scan.cu,
    ssd_scan_kernel_cb and ssd_scan_kernel_bf16), chunks of 64 tokens: c·b
    in f32; W = c·b exp(cum_i - cum_j) dt_j in f32, then bf16; the state S
    (f32 across chunks) in bf16 where it enters c·S; x exp(cum_Q - cum_j)
    dt_j in bf16 in the state update.  With ``split`` each of the three is
    bf16 hi + lo, as the kernel takes them; without, one rounding.  x, b
    and c are bf16 inputs and enter as they are; the products are summed
    in f64 here and in f32 on the card."""
    B, L, H, P = x.shape
    xd, bd, cd = x.double(), b.double(), c.double()
    S = torch.zeros((B, H, P, b.shape[-1]), dtype=torch.float32)
    y = torch.empty((B, L, H, P), dtype=torch.float64)
    for l0 in range(0, L, kssd.CHUNK):
        sl = slice(l0, min(L, l0 + kssd.CHUNK))
        q = sl.stop - l0
        cum = torch.cumsum(a[None, None] * dt[:, sl], 1)          # [B,q,H]
        total = cum[:, -1]
        cb = torch.einsum("bihn,bjhn->bhij", cd[:, sl], bd[:, sl]).float()
        diff = (cum[:, :, None] - cum[:, None, :]).permute(0, 3, 1, 2)
        w = torch.where(torch.ones(q, q, dtype=torch.bool).tril(),
                        cb * torch.exp(diff)
                        * dt[:, sl].permute(0, 2, 1)[:, :, None, :],
                        torch.zeros(()))
        inter = torch.einsum("bihn,bhpn->bhip", cd[:, sl],
                             _bf16_terms(S, split))
        yy = (inter * torch.exp(cum).permute(0, 2, 1)[..., None].double()
              + torch.einsum("bhij,bjhp->bhip", _bf16_terms(w, split),
                             xd[:, sl])).permute(0, 2, 1, 3)
        if d_skip is not None:
            yy = yy + d_skip.double()[None, None, :, None] * xd[:, sl]
        y[:, sl] = yy
        f = torch.exp(total[:, None] - cum) * dt[:, sl]            # [B,q,H]
        xf = _bf16_terms(x[:, sl].float() * f[..., None], split)
        S = torch.exp(total)[..., None, None] * S + torch.einsum(
            "bjhp,bjhn->bhpn", xf, bd[:, sl]).float()
    return y.float().to(x.dtype)


def _model_like(B, L, H, P, N, seed):
    """mamba2's SSD inputs at a layer: a = -(1..H) (A_log = log(1..H)),
    dt = softplus(normal + dt_bias) with dt_bias from dt in [1e-3, 1e-1],
    one group of b and c; x, b, c unit normal."""
    rng = np.random.default_rng(seed)
    x, _, _, b, c, d = _inputs(B, L, H, P, N, seed=seed)
    a = -np.arange(1, H + 1, dtype=np.float32)
    dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
    bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.logaddexp(rng.standard_normal((B, L, H)) + bias,
                      0).astype(np.float32)
    return x, dt, a, b[:, :, :1], c[:, :, :1], d


def _gate_ratio(got, want, tol=2e-2):
    """max |got - want| / (tol + tol |want|): at most 1 passes
    assert_allclose(rtol=tol, atol=tol); and the relative L2."""
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    err = np.abs(got - want)
    return (float((err / (tol + tol * np.abs(want))).max()),
            float(np.linalg.norm(got - want) / np.linalg.norm(want)))


# name, B, L, H, P, N, inputs
ROUNDING_CASES = [
    ("mamba2_heads", 1, 512, 4, 64, 128, "model"),
    ("mamba2_ragged", 2, 300, 3, 64, 128, "model"),
    ("unit_normal_n128", 1, 256, 4, 64, 128, "normal"),
    ("n8", 2, 256, 4, 16, 8, "normal"),
    ("n16", 1, 320, 8, 32, 16, "normal"),
    ("p128", 1, 192, 2, 128, 128, "normal"),
    ("strong_decay", 1, 256, 2, 64, 128, "strong"),
]


def _case_arrays(case):
    _, B, L, H, P, N, kind = case
    if kind == "model":
        arrays = _model_like(B, L, H, P, N, seed=11)
        return arrays[:3] + tuple(np.broadcast_to(v, (B, L, H, N)).copy()
                                  for v in arrays[3:5]) + arrays[5:]
    return _inputs(B, L, H, P, N, seed=12, **(
        dict(a_scale=-np.exp(3.0), dt_max=5.0) if kind == "strong" else {}))


@pytest.mark.parametrize("case", ROUNDING_CASES, ids=lambda c: c[0])
def test_kernel_arithmetic_meets_the_bf16_gates(case):
    """The bf16 kernel's rounding, hi + lo where it splits, held against
    the sequential recurrence and against the Pallas kernel in interpret
    mode, to the card's bf16 gates: 2e-2 elementwise, 5e-3 relative L2
    (tools/ssd_rounding.py prints the margins)."""
    L = case[2]
    arrays = _case_arrays(case)
    x, dt, a, b, c, d = _torch(arrays, "bfloat16")
    got = kernel_arithmetic(x, dt, a, b, c, d_skip=d)
    assert torch.isfinite(got).all()
    ratio, l2 = _gate_ratio(got, ref.ssd_scan(x, dt, a, b, c, d_skip=d))
    assert ratio <= 1.0 and l2 < 5e-3, (ratio, l2)
    if L % 64 == 0:
        jx, jdt, ja, jb, jc, jd = _jax(arrays, "bfloat16")
        pallas = ssd_scan_fwd(jx, jdt, ja, jb, jc, chunk=64, d_skip=jd,
                              interpret=True)
        ratio, l2 = _gate_ratio(got, pallas)
        assert ratio <= 1.0 and l2 < 5e-3, (ratio, l2)


def test_one_bf16_rounding_would_miss_the_elementwise_gate():
    """Why the kernel splits S, W and the scaled x into hi + lo: rounded
    once to bf16, unit-normal inputs at N = 128 (tests/test_torch_cuda.py's
    draws) miss the 2e-2 elementwise gate, while the relative L2 stays
    under 5e-3."""
    x, dt, a, b, c, d = _torch(_inputs(1, 256, 4, 64, 128, seed=12),
                               "bfloat16")
    want = ref.ssd_scan(x, dt, a, b, c, d_skip=d)
    ratio, l2 = _gate_ratio(
        kernel_arithmetic(x, dt, a, b, c, d_skip=d, split=False), want)
    assert ratio > 1.0 and l2 < 5e-3, (ratio, l2)
    ratio, _ = _gate_ratio(kernel_arithmetic(x, dt, a, b, c, d_skip=d), want)
    assert ratio <= 1.0


@pytest.mark.parametrize("change", ["x_offset", "b_seq_stride", "c_base"])
def test_cp_async_alignment_is_checked_for_bf16_only(change):
    """bf16 x, b and c are copied with 16-byte cp.async: a base pointer or a
    stride that is not a multiple of 16 bytes is refused before any launch;
    the same views in f32 pass every check but the device (the f32 kernel
    reads through plain loads)."""
    def views(dtype):
        x, dt, a, b, c, d = _wrapper_inputs(L=16, H=2, P=16, N=16, dtype=dtype)
        if change == "x_offset":
            x = torch.zeros((1, 16, 2, 20), dtype=dtype)[..., 4:]
        elif change == "b_seq_stride":
            b = torch.zeros((1, 16, 2, 20), dtype=dtype)[..., :16]
        else:
            c = torch.zeros((1, 16, 2, 17), dtype=dtype)[..., 1:]
        return x, dt, a, b, c, d

    with pytest.raises(ValueError, match="16 bytes"):
        kssd.check_inputs(*views(torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.check_inputs(*views(torch.float32))


def test_cb_groups_is_one_only_where_b_and_c_are_shared():
    x, dt, a, b, c, d = _wrapper_inputs(H=4, dtype=torch.bfloat16)
    shared_b, shared_c = b[:, :, :1].expand_as(b), c[:, :, :1].expand_as(c)
    assert kssd.cb_groups(shared_b, shared_c) == 1
    assert kssd.cb_groups(shared_b, c) == 4
    assert kssd.cb_groups(b, c) == 4
    assert kssd.cb_groups(b[:, :, :1], c[:, :, :1]) == 1
