"""The SSD's backward in the port (repro_torch.kernels: ref.ssd_scan_bwd,
the ssd_scan_bwd wrapper's checks and SsdScanFn) against the JAX package,
on the CPU.

The JAX package has no backward kernel for the SSD: it differentiates its
plain ``ref.ssd_scan`` / ``ref.ssd_scan_chunked`` with ``jax.vjp`` (what
``jax.value_and_grad`` runs in its train step), and the port's plain
backward is held against both.  Inputs are made from a seed with numpy and
handed to both packages (bf16 inputs are the same f32 numbers rounded to
bf16 on each side).  b and c come as one group [B, L, 1, N] (the JAX side
broadcasts it to every head, so its gradient is the sum over the heads) or
per head.  The CUDA kernel is held against ``ref.ssd_scan_bwd`` on the card
(tests/test_torch_cuda.py, chip_smoke.py); here a plain model of its bf16
arithmetic is held to the same gates.

Gates, per gradient: f32 5e-4 x max(1, max |ref|) elementwise and 1e-4
relative L2 (over max(1, |ref|)); bf16 2e-2 x max(1, max |ref|) and 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.checkpoint

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as kssd

GRADS = ("dx", "ddt", "da", "db", "dc", "dd")
TOL = {"float32": 5e-4, "bfloat16": 2e-2}
REL_L2 = {"float32": 1e-4, "bfloat16": 2e-3}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, L, H, P, N, groups=1, kind="normal", seed=0):
    """x, dt, a, b, c, d, dy as numpy f32.  "normal": dt = softplus(normal),
    a = -exp(normal) (tests/test_kernels.py:146-149); "model": mamba2's a =
    -(1..H) and dt = softplus(normal + dt_bias), dt_bias from dt in [1e-3,
    1e-1]; "strong": a = -e^3, dt in [1, 5]; "mild": "normal" with a / 8,
    so that exp(cum_i - cum_j) stays finite above the diagonal of a chunk
    of 64 (where it overflows, jax.vjp of the JAX package's chunked oracle
    is NaN: see test_plain_chunked_gradient_is_finite_where_jaxs_is_nan)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, P), dtype=np.float32)
    dy = rng.standard_normal((B, L, H, P), dtype=np.float32)
    b = rng.standard_normal((B, L, groups, N), dtype=np.float32)
    c = rng.standard_normal((B, L, groups, N), dtype=np.float32)
    d = rng.standard_normal(H).astype(np.float32)
    if kind == "model":
        a = -np.arange(1, H + 1, dtype=np.float32)
        dt0 = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), H))
        bias = dt0 + np.log(-np.expm1(-dt0))
        dt = np.logaddexp(rng.standard_normal((B, L, H)) + bias,
                          0).astype(np.float32)
    elif kind == "strong":
        a = np.full(H, -np.exp(3.0), np.float32)
        dt = rng.uniform(1.0, 5.0, (B, L, H)).astype(np.float32)
    else:
        dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(
            np.float32)
        a = -np.exp(rng.standard_normal(H)).astype(np.float32)
        if kind == "mild":
            a = a / 8
    return x, dt, a, b, c, d, dy


def _torch(arrays, dtype):
    x, dt, a, b, c, d, dy = arrays
    cast = DTYPES[dtype][1]
    return (torch.from_numpy(x).to(cast), torch.from_numpy(dt),
            torch.from_numpy(a), torch.from_numpy(b).to(cast),
            torch.from_numpy(c).to(cast), torch.from_numpy(d),
            torch.from_numpy(dy).to(cast))


def _jax_grads(arrays, dtype, skip, oracle, chunk=64):
    """jax.vjp of the JAX package's oracle, b and c broadcast to every
    head inside the differentiated function.  For bf16 it runs in f32 on
    the bf16 numbers and rounds dx, db and dc to bf16 once: jax.vjp on bf16
    inputs rounds each head's db and dc to bf16 before broadcast_to's
    transpose sums them, and (with the D-skip, in the chunked oracle) x's
    two cotangents before adding them, which alone puts dx, db and dc past
    the 2e-3 relative L2 gate here."""
    x, dt, a, b, c, d, dy = arrays
    if dtype == "bfloat16":
        x, b, c, dy = (np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                                  .astype(jnp.float32)) for v in (x, b, c, dy))
        grads = _jax_grads((x, dt, a, b, c, d, dy), "float32", skip, oracle,
                           chunk)
        return tuple(g if g is None or i in (1, 2, 5)
                     else g.astype(jnp.bfloat16) for i, g in enumerate(grads))
    cast = DTYPES[dtype][0]
    B, L, H, _ = x.shape
    N = b.shape[-1]

    def f(x, dt, a, b, c, d):
        bh = jnp.broadcast_to(b, (B, L, H, N))
        ch = jnp.broadcast_to(c, (B, L, H, N))
        dd = d if skip else None
        if oracle == "chunked":
            return jref.ssd_scan_chunked(x, dt, a, bh, ch, chunk=chunk,
                                         d_skip=dd)
        return jref.ssd_scan(x, dt, a, bh, ch, d_skip=dd)

    primals = (jnp.asarray(x).astype(cast), jnp.asarray(dt), jnp.asarray(a),
               jnp.asarray(b).astype(cast), jnp.asarray(c).astype(cast),
               jnp.asarray(d))
    _, vjp = jax.vjp(f, *primals)
    grads = vjp(jnp.asarray(dy).astype(cast))
    return grads if skip else grads[:5] + (None,)


def _f64(v):
    if isinstance(v, torch.Tensor):
        return v.detach().double().numpy()
    return np.asarray(jnp.asarray(v, jnp.float32), np.float64)


def _gate(got, want, dtype):
    """(max |got - want| / (tol max(1, max |want|)), |got - want| /
    max(1, |want|)): the first at most 1 and the second within REL_L2
    pass."""
    g, w = _f64(got), _f64(want)
    ratio = np.abs(g - w).max() / (TOL[dtype] * max(1.0, np.abs(w).max()))
    l2 = np.linalg.norm(g - w) / max(1.0, np.linalg.norm(w))
    return float(ratio), float(l2)


def _hold(got, want, dtype, what=""):
    for name, g, w in zip(GRADS, got, want):
        if w is None:
            assert g is None, (what, name)
            continue
        assert tuple(g.shape) == tuple(w.shape), (what, name)
        assert bool(np.isfinite(_f64(g)).all()), (what, name)
        ratio, l2 = _gate(g, w, dtype)
        assert ratio <= 1.0 and l2 <= REL_L2[dtype], (what, name, ratio, l2)


# ---------------------------------------------------------------------------
# the plain backward against jax.vjp of the JAX package's oracles
# ---------------------------------------------------------------------------
# B, L, H, P, N, groups, inputs
VJP_CASES = [
    (2, 128, 4, 16, 8, 1, "normal"),    # tests/test_kernels.py:137-141
    (1, 256, 8, 32, 16, 8, "normal"),
    (2, 64, 2, 64, 128, 1, "normal"),
    (1, 1, 3, 64, 128, 1, "normal"),    # ragged L
    (2, 63, 4, 32, 16, 4, "normal"),
    (1, 100, 2, 16, 8, 1, "normal"),
    (1, 256, 4, 64, 128, 1, "model"),   # mamba2's a and dt
    (1, 128, 2, 64, 128, 1, "strong"),  # exp(cum_i - cum_j) overflows
]


@pytest.mark.parametrize("skip", [True, False], ids=["d_skip", "no_d"])
@pytest.mark.parametrize("case", VJP_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_ssd_scan_bwd_matches_jax_vjp_of_the_sequential_oracle(
        case, dtype, skip):
    B, L, H, P, N, groups, kind = case
    arrays = _inputs(B, L, H, P, N, groups, kind, seed=L + H)
    x, dt, a, b, c, d, dy = _torch(arrays, dtype)
    got = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d if skip else None)
    assert [t.dtype for t in got if t is not None] == [
        x.dtype, torch.float32, torch.float32, x.dtype, x.dtype] + (
            [torch.float32] if skip else [])
    _hold(got, _jax_grads(arrays, dtype, skip, "sequential"), dtype, case)


@pytest.mark.parametrize("N", kssd.STATE_DIMS)
@pytest.mark.parametrize("P", kssd.HEAD_DIMS)
def test_ref_ssd_scan_bwd_over_the_kernels_head_and_state_dims(P, N):
    """Every (P, N) the kernels take, against jax.vjp of the JAX chunked
    oracle at its own chunk (and so at a chunk other than the backward's)."""
    arrays = _inputs(1, 128, 2, P, N, kind="mild", seed=P + N)
    x, dt, a, b, c, d, dy = _torch(arrays, "float32")
    got = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    _hold(got, _jax_grads(arrays, "float32", True, "chunked", chunk=32),
          "float32", (P, N))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 4], ids=["group", "per_head"])
def test_ref_ssd_scan_bwd_matches_jax_vjp_of_the_chunked_oracle(groups,
                                                                  dtype):
    arrays = _inputs(2, 256, 4, 32, 16, groups, kind="mild", seed=3)
    x, dt, a, b, c, d, dy = _torch(arrays, dtype)
    got = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    _hold(got, _jax_grads(arrays, dtype, True, "chunked"), dtype)


def test_plain_chunked_gradient_is_finite_where_jaxs_is_nan():
    """At mamba2's decays (a = -(1..H)) exp(cum_i - cum_j) overflows above
    the diagonal of a chunk: jax.vjp of the JAX package's
    ssd_scan_chunked, where(mask, exp(diff), 0), multiplies that inf by 0
    and gives NaN in ddt and da.  The port's plain chunked scan selects the
    exponent first: its gradient is finite and equals the plain backward's
    and jax.vjp of the sequential oracle's."""
    arrays = _inputs(1, 128, 32, 16, 16, kind="model", seed=2)
    jgrads = _jax_grads(arrays, "float32", True, "chunked")
    assert bool(jnp.isnan(jgrads[1]).any())
    x, dt, a, b, c, d, dy = _torch(arrays, "float32")
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c, d)]
    y = ops.ssd(*leaves[:5], d_skip=leaves[5], impl="chunked", chunk=64)
    got = torch.autograd.grad(y, leaves, dy)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _hold(got, ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d), "float32")
    _hold(got, _jax_grads(arrays, "float32", True, "sequential"), "float32")


def test_strongly_decaying_heads_give_finite_gradients():
    """exp(cum_i - cum_j) overflows above the diagonal at a = -e^3, dt up
    to 5: it is selected away, never multiplied by a 0/1 mask."""
    x, dt, a, b, c, d, dy = _torch(_inputs(1, 256, 2, 64, 128,
                                           kind="strong"), "float32")
    got = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("groups", [1, 3], ids=["group", "per_head"])
def test_ref_ssd_scan_bwd_matches_autograd_of_the_ports_chunked_scan(
        groups, chunk):
    """The plain backward at any chunk against autograd through the
    port's own ssd_scan_chunked (b and c expanded to every head inside, as
    ops.ssd does)."""
    x, dt, a, b, c, d, dy = _torch(_inputs(2, 256, 3, 32, 16, groups,
                                           seed=9), "float32")
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c, d)]
    B, L, H, _ = x.shape
    y = ref.ssd_scan_chunked(leaves[0], leaves[1], leaves[2],
                             kssd.expand_heads(leaves[3], H),
                             kssd.expand_heads(leaves[4], H), chunk=64,
                             d_skip=leaves[5])
    want = torch.autograd.grad(y, leaves, dy)
    got = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d, chunk=chunk)
    _hold(got, want, "float32", chunk)


def test_ref_ssd_scan_bwd_refuses_other_group_counts():
    x, dt, a, b, c, d, dy = _torch(_inputs(1, 16, 4, 16, 8, groups=2),
                                   "float32")
    with pytest.raises(ValueError, match="1 or H=4"):
        ref.ssd_scan_bwd(x, dt, a, b, c, dy)


# ---------------------------------------------------------------------------
# the bf16 kernel's arithmetic, rehearsed on the CPU
# ---------------------------------------------------------------------------
def _bf16_terms(v, split):
    """v (f32) as the tensor cores take it: bf16(v), plus bf16(v - hi) where
    the kernel splits the operand into two MMAs; in f64."""
    hi = v.to(torch.bfloat16).double()
    return hi + (v.double() - hi).to(torch.bfloat16).double() if split else hi


def kernel_arithmetic_bwd(x, dt, a, b, c, dy, d_skip=None, split=True):
    """A plain model of the bf16 backward kernel's rounding
    (csrc/ssd_scan_bwd.cu), chunks of 64 tokens: cum, the decays, c·b
    (once per (batch, chunk) where b and c are one group: the same numbers
    for every head), dW = dy·xᵀ, W and dCB in f32; each chunk's local
    state Σ_j (b_j f_j) x_jᵀ and local adjoint Σ_i (c_i e_i) dy_iᵀ in f32,
    then the f32 state pass: S_in by the forward walk S ← exp(T) S +
    S_loc, dS by the backward walk over the local adjoints (one rounding a
    step, as the card's fused multiply-add).  The operands that are not
    inputs enter their products in bf16, hi + lo with ``split`` (as the
    kernel takes them) or rounded once without: W (in Wᵀ dy), dCB (in dCB b
    and dCBᵀ c), dS (in b dS and x dSᵀ), S_in (in dy S_inᵀ), c e (in the
    local adjoint) and b f (in the local state).  x, dy, b and c are bf16
    inputs and enter as they are; products are summed in f64 here and in
    f32 on the card."""
    Q = kssd.CHUNK
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t, dtype=torch.float64):
        t = torch.nn.functional.pad(t.to(dtype), (0, 0) * (t.dim() - 2)
                                    + (0, pad))
        return t.reshape(B, nc, Q, *t.shape[2:])

    xd, dyd = chunks(x), chunks(dy)
    bd = chunks(b).expand(B, nc, Q, H, N)
    cd = chunks(c).expand(B, nc, Q, H, N)
    dtq = chunks(dt, torch.float32)
    cum = torch.cumsum(a[None, None, None] * dtq, 2)
    total = cum[:, :, -1]
    e = torch.exp(cum)
    g = torch.exp(total[:, :, None] - cum)
    f = g * dtq
    mask = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    zero = torch.zeros(())
    lm = torch.where(mask, torch.exp(cum[:, :, :, None] - cum[:, :, None]),
                     zero)
    cb = torch.einsum("bzihn,bzjhn->bzijh", cd, bd).float()
    dw = torch.einsum("bzihp,bzjhp->bzijh", dyd, xd).float()
    cbl = cb * lm
    w = torch.where(mask, cbl * dtq[:, :, None], zero)
    dcb = torch.where(mask, dw * lm * dtq[:, :, None], zero)
    m = (dw * w).double()
    gt = torch.where(mask, dw * cbl, zero).double()
    decay = torch.exp(total).double()[..., None, None]

    s_loc = [torch.einsum("bjhn,bjhp->bhnp", _bf16_terms(
        bd[:, z].float() * f[:, z, ..., None], split), xd[:, z]).float()
        for z in range(nc)]
    c_loc = [torch.einsum("bihn,bihp->bhnp", _bf16_terms(
        cd[:, z].float() * e[:, z, ..., None], split), dyd[:, z]).float()
        for z in range(nc)]
    s_in, d_s = [None] * nc, [None] * nc
    S = torch.zeros(B, H, N, P)
    for z in range(nc):
        s_in[z] = S
        S = (decay[:, z] * S.double() + s_loc[z].double()).float()
    S = torch.zeros(B, H, N, P)
    for z in reversed(range(nc)):
        d_s[z] = S
        S = (decay[:, z] * S.double() + c_loc[z].double()).float()
    dx = torch.empty(B, nc, Q, H, P, dtype=torch.float64)
    db, dc = (torch.empty(B, nc, Q, H, N, dtype=torch.float64)
              for _ in range(2))
    ddt = torch.empty(B, nc, Q, H, dtype=torch.float64)
    da = torch.zeros(H, dtype=torch.float64)
    for z in range(nc):
        fz, ez = f[:, z].double(), e[:, z].double()
        dS = d_s[z]
        wt, dcbt = _bf16_terms(w[:, z], split), _bf16_terms(dcb[:, z], split)
        dst, sint = _bf16_terms(dS, split), _bf16_terms(s_in[z], split)
        bds = torch.einsum("bjhn,bhnp->bjhp", bd[:, z], dst).float().double()
        dx[:, z] = (torch.einsum("bijh,bihp->bjhp", wt, dyd[:, z])
                    + fz[..., None] * bds)
        df = (xd[:, z] * bds).sum(-1)
        v = torch.einsum("bihp,bhnp->bihn", dyd[:, z], sint).float().double()
        dc[:, z] = (torch.einsum("bijh,bjhn->bihn", dcbt, bd[:, z])
                    + ez[..., None] * v)
        vin = (cd[:, z] * v).sum(-1)
        db[:, z] = (torch.einsum("bijh,bihn->bjhn", dcbt, cd[:, z])
                    + fz[..., None] * torch.einsum(
                        "bjhp,bhnp->bjhn", xd[:, z], dst))
        sds = (s_in[z].double() * dS.double()).sum((-2, -1))
        dcum = (m[:, z].sum(2) - m[:, z].sum(1) + ez * vin - fz * df)
        dcum[:, -1] += decay[:, z, :, 0, 0] * sds + (fz * df).sum(1)
        ds = dcum.flip(1).cumsum(1).flip(1)
        ddt[:, z] = a.double() * ds + g[:, z].double() * df + gt[:, z].sum(1)
        da += (dtq[:, z].double() * ds).sum((0, 1))

    def unchunk(t):
        return t.reshape(B, nc * Q, *t.shape[3:])[:, :L]

    dx, db, dc = unchunk(dx), unchunk(db), unchunk(dc)
    dd = None
    if d_skip is not None:
        dx = dx + d_skip.double()[None, None, :, None] * dy.double()
        dd = (dy.double() * x.double()).sum((0, 1, 3)).float()
    if G == 1:
        db, dc = db.sum(2, keepdim=True), dc.sum(2, keepdim=True)
    return (dx.to(x.dtype), unchunk(ddt).float(), da.float(),
            db.to(b.dtype), dc.to(c.dtype), dd)


# name, B, L, H, P, N, groups, inputs
ROUNDING_CASES = [
    ("mamba2_train_heads", 1, 4096, 4, 64, 128, 1, "model"),
    ("mamba2_80_heads", 1, 512, 80, 64, 128, 1, "model"),
    ("jamba_heads", 1, 1024, 8, 64, 16, 1, "model"),
    ("ragged_1000", 1, 1000, 2, 64, 128, 1, "normal"),
    ("n8_per_head", 2, 256, 4, 16, 8, 4, "normal"),
    ("p128", 1, 192, 2, 128, 128, 1, "normal"),
    ("strong_decay", 1, 256, 2, 64, 128, 1, "strong"),
]


@pytest.mark.parametrize("case", ROUNDING_CASES, ids=lambda c: c[0])
def test_kernel_arithmetic_meets_the_bf16_gates(case):
    """The bf16 backward kernel's rounding, hi + lo where it splits, held
    against the plain backward and (at the smaller cases) against jax.vjp
    of the JAX sequential oracle, to the card's bf16 gates."""
    _, B, L, H, P, N, groups, kind = case
    arrays = _inputs(B, L, H, P, N, groups, kind, seed=11)
    x, dt, a, b, c, d, dy = _torch(arrays, "bfloat16")
    got = kernel_arithmetic_bwd(x, dt, a, b, c, dy, d_skip=d)
    _hold(got, ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d), "bfloat16",
          "plain")
    if H * L <= 8192:
        _hold(got, _jax_grads(arrays, "bfloat16", True, "sequential"),
              "bfloat16", "jax")


def test_one_bf16_rounding_would_miss_the_relative_l2_gate():
    """Why the kernel splits W, dCB, S_in, dS, c e and b f into hi + lo:
    rounded once to bf16, they put dx, db and dc at the mamba training
    layer's heads past the 2e-3 relative L2 gate (the elementwise gate
    alone would pass); split, they stay under a fifth of it."""
    x, dt, a, b, c, d, dy = _torch(_inputs(1, 4096, 4, 64, 128,
                                           kind="model", seed=11),
                                   "bfloat16")
    want = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d)
    once = kernel_arithmetic_bwd(x, dt, a, b, c, dy, d_skip=d, split=False)
    split = kernel_arithmetic_bwd(x, dt, a, b, c, dy, d_skip=d)
    for i in (0, 3, 4):  # dx, db, dc
        ratio, l2 = _gate(once[i], want[i], "bfloat16")
        assert ratio <= 1.0 and l2 > REL_L2["bfloat16"], (GRADS[i], l2)
        assert _gate(split[i], want[i], "bfloat16")[1] < REL_L2[
            "bfloat16"] / 5, GRADS[i]


# ---------------------------------------------------------------------------
# the wrapper's checks and SsdScanFn's wiring
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("change,match", [
    ("groups_2", "G = 1 or H"),
    ("dy_shape", "must match x"),
    ("dy_dtype", "must match x"),
    ("dy_stride", "stride 1 along P"),
    ("p_24", "head dim"),
    ("n_32", "state dim"),
])
def test_bwd_wrapper_rejects_what_the_kernel_does_not_take(change, match):
    H = 4
    x, dt, a, b, c, d, dy = _torch(_inputs(1, 16, H, 16, 8), "float32")
    if change == "groups_2":
        b = c = torch.zeros((1, 16, 2, 8))
    elif change == "dy_shape":
        dy = dy[:, :8]
    elif change == "dy_dtype":
        dy = dy.double()
    elif change == "dy_stride":
        dy = torch.zeros((1, 16, H, 32))[..., ::2]
    elif change == "p_24":
        x = dy = torch.zeros((1, 16, H, 24))
    else:
        b = c = torch.zeros((1, 16, 1, 32))
    with pytest.raises(ValueError, match=match):
        kssd.check_bwd_inputs(x, dt, a, b, c, dy, d)


def test_bwd_wrapper_checks_the_device_last():
    x, dt, a, b, c, d, dy = _torch(_inputs(1, 16, 4, 16, 8), "bfloat16")
    x.requires_grad_()
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.check_bwd_inputs(x, dt, a, b, c, dy, d)
    with pytest.raises(ValueError, match="CUDA device"):
        kssd.ssd_scan_bwd(x, dt, a, b, c, dy, d)


@pytest.mark.parametrize("groups", [1, 3], ids=["group", "per_head"])
@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_bwd_workspace_shapes(P, groups):
    """The chunk-parallel backward's scratch: the local states and
    adjoints (then S_in and dS) [B, H, Z, N, P], cum_Q [B, H, Z], the
    per-tile sums of db and dc [B, L, tiles, N] (none for per-head b and
    c, whose db and dc the kernel writes itself), the per-chunk da and dd
    [B, Z, H]; all f32."""
    x = torch.zeros((2, 130, 3, P), dtype=torch.bfloat16)
    work = kssd.bwd_workspace(x, 16, groups)
    states, adj, totals, part_b, part_c, part_a, part_d = work
    assert tuple(states.shape) == tuple(adj.shape) == (2, 3, 3, 16, P)
    assert tuple(totals.shape) == (2, 3, 3)
    tiles = 1 if groups == 1 else 0
    assert tuple(part_b.shape) == tuple(part_c.shape) == (2, 130, tiles, 16)
    assert tuple(part_a.shape) == tuple(part_d.shape) == (2, 3, 3)
    assert all(t.dtype == torch.float32 for t in work)


def test_bwd_workspace_does_not_grow_at_the_training_layer():
    """At the mamba2-2.7b training layer (x [2, 4096, 80, 64], N 128, one
    group) the scratch, counted from its shapes on the meta device, is
    below the 1.01e9 bytes of the slice-by-slice design it replaces (its
    states 3.4e8 and per-head db and dc partials 6.7e8)."""
    x = torch.empty((2, 4096, 80, 64), dtype=torch.bfloat16, device="meta")
    work = kssd.bwd_workspace(x, 128, 1)
    nbytes = sum(t.numel() * t.element_size() for t in work)
    assert nbytes < 2 * 4096 * 80 * 128 * 4 * 2 + 2 * 80 * 64 * 128 * 64 * 4
    assert tuple(work[3].shape) == (2, 4096, 10, 128)  # 8 heads a tile


@pytest.mark.parametrize("groups", ["one", "per_head"])
@pytest.mark.parametrize("H", [1, 3, 80, 128])
def test_bwd_head_tiles_count_every_head_once(H, groups):
    """The head tiles the wrapper hands the per-chunk kernels (the tile
    size in the C call, the tile count in the partials' shape): in order,
    each at most BWD_HEAD_TILE heads, every head in exactly one; with one
    group the per-tile db and dc sums have one slot per tile, with b and c
    per head none."""
    G = 1 if groups == "one" else H
    tiles = kssd.bwd_head_tiles(H)
    heads = [h for t in tiles for h in t]
    assert heads == list(range(H))
    assert all(0 < len(t) <= kssd.BWD_HEAD_TILE for t in tiles)
    assert len(tiles) == -(-H // kssd.BWD_HEAD_TILE)
    x, dt, a, b, c, d, dy = _torch(_inputs(1, 70, H, 16, 8, G), "float32")
    work = kssd.bwd_workspace(x, 8, G)
    assert tuple(work[3].shape) == (1, 70, len(tiles) if G == 1 else 0, 8)
    outs = (torch.empty_like(x), torch.empty((1, 70, H)), torch.empty(H),
            torch.empty_like(b), torch.empty_like(c), torch.empty(H))
    args = kssd.bwd_call_args(x, dt, a, b, c, dy, d, outs, work)
    assert len(args) == len(kssd._ARGTYPES["ssd_scan_bwd"]) + 2
    # batch, seq, heads, groups, P, N, then the head tile
    assert args[20:27] == (1, 70, H, G, 16, 8, kssd.BWD_HEAD_TILE)


class _Kernels:
    """The two kernel calls of SsdScanFn, stood in by the plain versions
    on CPU tensors and counted (the CUDA kernels run on the card only)."""

    def __init__(self, monkeypatch):
        self.forward = self.backward = 0
        self.saved = []
        monkeypatch.setattr(kssd, "ssd_scan", self._forward)
        monkeypatch.setattr(kssd, "ssd_scan_bwd", self._backward)

    def _forward(self, x, dt, a, b, c, d_skip=None):
        assert b.shape == x.shape[:3] + b.shape[3:]  # expanded to every head
        self.forward += 1
        return ref.ssd_scan_chunked(x, dt, a, b, c, chunk=16, d_skip=d_skip)

    def _backward(self, x, dt, a, b, c, dy, d_skip=None):
        self.backward += 1
        self.saved.append((x, b, dy))
        return ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d_skip)


def _leaves(dtype, groups):
    x, dt, a, b, c, d, dy = _torch(_inputs(2, 64, 4, 16, 8, groups, seed=5),
                                   dtype)
    leaves = [t.clone().requires_grad_() for t in (x, dt, a, b, c, d)]
    return leaves, dy


@pytest.mark.parametrize("groups", [1, 4], ids=["group", "per_head"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_scan_fn_gradients_match_autograd_of_the_plain_version(
        monkeypatch, dtype, groups):
    """ops.ssd with impl="pallas" under autograd goes through SsdScanFn;
    its gradients (b and c summed over the group's heads where they are
    one group) equal autograd's through the plain chunked version, in the
    leaves' dtypes.  For bf16 that reference runs in f32 on the same bf16
    numbers and is rounded once: autograd on the bf16 leaves rounds each
    head's db and dc, and x's two cotangents, to bf16 before summing them
    (as jax.vjp does, _jax_grads)."""
    kernels = _Kernels(monkeypatch)
    leaves, dy = _leaves(dtype, groups)
    y = ops.ssd(*leaves[:5], d_skip=leaves[5], impl="pallas")
    assert isinstance(y.grad_fn, torch.autograd.function.BackwardCFunction)
    got = torch.autograd.grad(y, leaves, dy)
    assert (kernels.forward, kernels.backward) == (1, 1)
    assert [g.dtype for g in got] == [t.dtype for t in leaves]
    assert tuple(got[3].shape) == (2, 64, groups, 8)
    ref_leaves = [t.detach().float().requires_grad_() for t in leaves]
    want_y = ops.ssd(*ref_leaves[:5], d_skip=ref_leaves[5], impl="chunked",
                     chunk=16)
    want = torch.autograd.grad(want_y, ref_leaves, dy.float())
    _hold(got, [w.to(t.dtype) for w, t in zip(want, leaves)], dtype)


def test_ssd_scan_fn_takes_an_expanded_view_per_head(monkeypatch):
    """Handed b and c already expanded to every head (stride 0), the
    Function returns per-head gradients and expand's backward sums them:
    the same group gradient as the unexpanded form."""
    _Kernels(monkeypatch)
    leaves, dy = _leaves("float32", 1)
    B, L, H, _ = leaves[0].shape
    y = ops.ssd(leaves[0], leaves[1], leaves[2],
                leaves[3].expand(B, L, H, 8), leaves[4].expand(B, L, H, 8),
                d_skip=leaves[5], impl="pallas")
    got = torch.autograd.grad(y, leaves, dy)
    y1 = ops.ssd(*leaves[:5], d_skip=leaves[5], impl="pallas")
    want = torch.autograd.grad(y1, leaves, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_ssd_scan_fn_under_checkpoint_saves_the_recomputes_inputs(
        monkeypatch):
    """Under torch.utils.checkpoint the forward runs twice (the step and
    the recompute) and the backward once, on the recompute's saved inputs;
    the gradients equal those without remat."""
    kernels = _Kernels(monkeypatch)
    leaves, dy = _leaves("float32", 1)

    def layer(*t):
        return ops.ssd(*t[:5], d_skip=t[5], impl="pallas") * 2.0

    y = torch.utils.checkpoint.checkpoint(layer, *leaves, use_reentrant=False)
    got = torch.autograd.grad(y, leaves, dy)
    assert (kernels.forward, kernels.backward) == (2, 1)
    x_saved, b_saved, dy_saved = kernels.saved[0]
    assert torch.equal(x_saved, leaves[0]) and b_saved.shape[2] == 1
    assert torch.equal(dy_saved, dy * 2.0)
    want = torch.autograd.grad(layer(*leaves), leaves, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssd_without_autograd_launches_the_forward_alone(monkeypatch):
    kernels = _Kernels(monkeypatch)
    leaves, _ = _leaves("float32", 1)
    with torch.no_grad():
        y = ops.ssd(*leaves[:5], d_skip=leaves[5], impl="pallas")
    assert y.grad_fn is None and (kernels.forward, kernels.backward) == (1, 0)


def test_ops_ssd_refuses_other_group_counts():
    x, dt, a, b, c, d, _ = _torch(_inputs(1, 16, 4, 16, 8, groups=2),
                                  "float32")
    with pytest.raises(ValueError, match="H=4 or 1"):
        ops.ssd(x, dt, a, b, c, d_skip=d)

