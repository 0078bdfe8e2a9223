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
