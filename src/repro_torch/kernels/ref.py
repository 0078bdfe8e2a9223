"""Plain PyTorch versions of the kernels (the port's oracles).

Each function computes what its kernel computes, in the same order of
operations as the JAX package's oracle in ``repro/kernels/ref.py``.  They
run on CPU tensors in the tests and on the card in ``chip_smoke.py``, where
each kernel is held against them; on the main path a CUDA tensor always
goes to the kernel instead.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Attention (GQA, causal / full), the LM hot spot
# ---------------------------------------------------------------------------
def check_causal(seq_q: int, seq_k: int, causal: bool) -> None:
    """Causal attention with more queries than keys is refused: the first
    Sq - Sk rows would see no key, and the JAX package's oracle (NaN) and
    TPU kernel (a finite value) disagree there.  No caller in the dense
    path produces it (a prefill has Sq == Sk)."""
    if causal and seq_q > seq_k:
        raise ValueError(f"causal attention needs Sq <= Sk, got Sq={seq_q} "
                         f"> Sk={seq_k}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention: q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D]
    with Hq % Hkv == 0 -> [B, Hq, Sq, D] in q's dtype.  Scores, softmax and
    the weighted sum are f32 whatever the input dtype.  Queries are
    right-aligned against the keys (query i sees keys <= i + Sk - Sq);
    causal with Sq > Sk raises.  Materialises the [Sq, Sk] scores."""
    B, Hq, Sq, D = q.shape
    probs = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            scale: float | None) -> torch.Tensor:
    """The masked, scaled f32 scores [B, Hkv, group, Sq, Sk]."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    check_causal(Sq, Sk, causal)
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        logits = logits.masked_fill(_causal_hidden(Sq, Sk, 0, Sq, q.device),
                                    float("-inf"))
    return logits


def attention_lse(q: torch.Tensor, k: torch.Tensor, causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """Each query row's log-sum-exp of its scaled, masked scores, f32
    [B, Hq, Sq] (natural log): what the forward kernel writes for its
    backward."""
    B, Hq, Sq, _ = q.shape
    return torch.logsumexp(_scores(q, k, causal, scale),
                           dim=-1).reshape(B, Hq, Sq)


def _causal_hidden(seq_q: int, seq_k: int, row0: int, rows: int,
                   device) -> torch.Tensor:
    """[rows, Sk] bool, True where query row0 + r may not see key j
    (j > row0 + r + Sk - Sq)."""
    q_pos = torch.arange(row0, row0 + rows, device=device)[:, None] + (
        seq_k - seq_q)
    k_pos = torch.arange(seq_k, device=device)[None, :]
    return k_pos > q_pos


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: float | None = None,
                      chunk: int = 512) -> torch.Tensor:
    """Query-chunked attention: the semantics of :func:`attention`, with
    the live scores held at [B, Hq, chunk, Sk].  A length that ``chunk``
    does not divide goes to :func:`attention` whole, as in the JAX
    package."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    check_causal(Sq, Sk, causal)
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    chunk = min(chunk, Sq)
    if chunk == 0 or Sq % chunk:
        return attention(q, k, v, causal=causal, scale=scale)
    kf, vf = k.float(), v.float()
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    for row0 in range(0, Sq, chunk):
        qb = q[:, :, row0:row0 + chunk].float().reshape(B, Hkv, group, chunk, D)
        logits = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf) * scale
        if causal:
            logits = logits.masked_fill(
                _causal_hidden(Sq, Sk, row0, chunk, q.device), float("-inf"))
        probs = torch.softmax(logits, dim=-1)
        ob = torch.einsum("bhgqk,bhkd->bhgqd", probs, vf)
        out[:, :, row0:row0 + chunk] = ob.reshape(B, Hq, chunk, D).to(q.dtype)
    return out


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, causal: bool = True,
                  scale: float | None = None, chunk: int = 1024):
    """The gradients of :func:`attention` with respect to q, k and v for
    the output's gradient ``do`` [B, Hq, Sq, D], written out step by step in
    f32 (the backward kernel's plain version):

        S = scale q kᵀ (masked), P = softmax(S), O = P v,
        Δ_i = Σ_d dO_id O_id, dV = Pᵀ dO, dP = dO vᵀ, dS = P ∘ (dP − Δ),
        dq = scale dS k, dk = scale dSᵀ q,

    with dk and dv summed over each KV head's group of query heads.
    Returns (dq, dk, dv) in q's, k's and v's dtypes.  Query rows are taken
    ``chunk`` at a time, so the [chunk, Sk] f32 intermediates, not the
    whole [Sq, Sk], are live; dk and dv are summed over the chunks."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    check_causal(Sq, Sk, causal)
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Hkv, group, Sq, D), dtype=torch.float32,
                     device=q.device)
    dk = torch.zeros((B, Hkv, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for row0 in range(0, Sq, chunk):
        rows = min(chunk, Sq - row0)
        qb = q[:, :, row0:row0 + rows].float().reshape(B, Hkv, group, rows, D)
        dob = do[:, :, row0:row0 + rows].float().reshape(B, Hkv, group, rows,
                                                          D)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kf) * scale
        if causal:
            s = s.masked_fill(_causal_hidden(Sq, Sk, row0, rows, q.device),
                              float("-inf"))
        p = torch.softmax(s, dim=-1)
        del s
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        delta = (dob * o).sum(dim=-1, keepdim=True)
        del o
        dv += torch.einsum("bhgqk,bhgqd->bhkd", p, dob)
        dp = torch.einsum("bhgqd,bhkd->bhgqk", dob, vf)
        ds = p * (dp - delta)
        del p, dp
        dq[:, :, :, row0:row0 + rows] = torch.einsum(
            "bhgqk,bhkd->bhgqd", ds, kf) * scale
        dk += torch.einsum("bhgqk,bhgqd->bhkd", ds, qb) * scale
        del ds
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_scores(q: torch.Tensor, k_cache: torch.Tensor,
                  cache_len: int) -> torch.Tensor:
    """The f32 scaled scores of one-token decode against the first
    ``cache_len`` positions of a cache: q [B, Hq, 1, D], k_cache [B, Hkv,
    S, D] -> [B, Hkv, Hq / Hkv, cache_len].  q is cast to the cache's
    dtype, and the product accumulates in f32: the JAX oracle's
    ``preferred_element_type``, which upcasting the valid prefix
    reproduces exactly, because a product of two bf16 values is exact in
    f32.  The upcast is one layer's prefix, not a copy of the whole
    cache."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    qf = q.reshape(B, Hkv, Hq // Hkv, D).to(k_cache.dtype).float()
    kf = k_cache[:, :, :cache_len].float()
    return torch.einsum("bhgd,bhkd->bhgk", qf, kf) * (D ** -0.5)


def decode_max(scores: torch.Tensor) -> torch.Tensor:
    """A shard's row maximum of its scores [.., n] -> [..] (-inf where it
    holds no position)."""
    if scores.shape[-1] == 0:
        return scores.new_full(scores.shape[:-1], float("-inf"))
    return scores.amax(dim=-1)


def decode_exp(scores: torch.Tensor, row_max: torch.Tensor) -> torch.Tensor:
    """exp(scores - the global row max): the softmax's numerators."""
    return torch.exp(scores - row_max[..., None])


def decode_pv(numerators: torch.Tensor, row_sum: torch.Tensor,
              v_cache: torch.Tensor) -> torch.Tensor:
    """A shard's part of P·V: its numerators over the global row sum of
    exponentials (the normalised probabilities), cast to the cache's dtype
    as the JAX oracle casts them, times the first ``n`` values, summed in
    f32 -> [B, Hkv, group, D] f32.  The quotient is written straight into
    the cache's dtype (computed in f32, rounded on the store: the same
    numbers as a division and a cast, one op fewer)."""
    n = numerators.shape[-1]
    probs = numerators.new_empty(numerators.shape, dtype=v_cache.dtype)
    torch.div(numerators, row_sum[..., None], out=probs)
    return torch.einsum("bhgk,bhkd->bhgd", probs.float(),
                        v_cache[:, :, :n].float())


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token decode: q [B, Hq, 1, D], caches [B, Hkv, S, D] ->
    [B, Hq, 1, D] in q's dtype.  Only the first ``cache_len`` positions are
    read (the tail may be uninitialised).  The softmax is the JAX oracle's
    (``jax.nn.softmax``: exp(x - max) over its sum), written as the
    split-K pieces a sequence-sharded cache combines over its shards
    (:func:`decode_scores`, :func:`decode_max`, :func:`decode_exp`,
    :func:`decode_pv`; ``models/attention.py``): with one shard they are
    this function, bit for bit.  The probabilities are cast to the
    cache's dtype before the weighted sum, which accumulates in f32."""
    B, Hq, _, D = q.shape
    scores = decode_scores(q, k_cache, cache_len)
    e = decode_exp(scores, decode_max(scores))
    out = decode_pv(e, e.sum(dim=-1), v_cache)
    return out.reshape(B, Hq, 1, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Weighted temporal composite (paper §V.C: cloud-free global base layer)
# ---------------------------------------------------------------------------
def composite(images: torch.Tensor, weights: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    """images [T, H, W, C], weights [T, H, W] (>= 0) -> [H, W, C] =
    sum_t w[t]*x[t] / (sum_t w[t] + eps), all sums in f32, output in the
    images' dtype.  Materialises a [T, H, W, C] f32 product."""
    imf = images.float()
    wf = weights.float()[..., None]
    num = (imf * wf).sum(dim=0)
    den = wf.sum(dim=0)
    return (num / (den + eps)).to(images.dtype)


def composite_weights(cloud_score: torch.Tensor, nir: torch.Tensor,
                      red: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The paper's weighting: favour cloud-free, verdant pixels.

    cloud_score [T, H, W] in [0, 1] (1 = certainly cloud); nir/red
    [T, H, W] reflectances give the NDVI verdancy term.
    """
    ndvi = (nir - red) / (nir + red + eps)
    verdancy = ndvi.clamp(0.0, 1.0)
    return (1.0 - cloud_score) * (0.25 + 0.75 * verdancy)


# ---------------------------------------------------------------------------
# Temporal-mean gradient magnitude (paper §V.B: field segmentation edges)
# ---------------------------------------------------------------------------
def grad_mag(images: torch.Tensor, valid: torch.Tensor,
             eps: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """Accumulated cloud-masked spatial gradient magnitude.

    images [T, H, W, C], valid [T, H, W] bool (False = cloud/missing) ->
    (grad_sum [H, W], count [H, W]), both f32.  East and south forward
    differences; a difference counts only where both pixels are valid, and a
    neighbour outside the frame is invalid.  mag = sqrt(sum_c dx^2 +
    sum_c dy^2 + eps), grad_sum = sum_t mag * v, count = sum_t v.

    The JAX oracle's operations, one timestep at a time with the sums in
    f32, so no [T, H, W, C] temporary is made (at [16, 6144, 6144, 4] each
    one is 9.7 GB)."""
    T, H, W, _ = images.shape
    grad_sum = torch.zeros((H, W), dtype=torch.float32, device=images.device)
    count = torch.zeros_like(grad_sum)
    for t in range(T):
        x = images[t].float()
        v = valid[t].float()
        dx = torch.zeros_like(x)
        dy = torch.zeros_like(x)
        dx[:, :-1] = (x[:, 1:] - x[:, :-1]) * (v[:, 1:] * v[:, :-1])[..., None]
        dy[:-1] = (x[1:] - x[:-1]) * (v[1:] * v[:-1])[..., None]
        mag = torch.sqrt((dx * dx).sum(dim=-1) + (dy * dy).sum(dim=-1) + eps)
        grad_sum += mag * v
        count += v
    return grad_sum, count


def temporal_mean_gradient(images: torch.Tensor,
                           valid: torch.Tensor) -> torch.Tensor:
    g, c = grad_mag(images, valid)
    return g / c.clamp_min(1.0)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality) scan
# ---------------------------------------------------------------------------
def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             d_skip: torch.Tensor | None = None) -> torch.Tensor:
    """Sequential-recurrence oracle for the SSD layer (Mamba-2,
    arXiv:2405.21060).

    x [B, L, H, P], dt [B, L, H] (softplus-activated, > 0), a [H] (negative
    decay rate), b and c [B, L, H, N] (groups pre-broadcast; expanded views
    are fine), d_skip [H] or None -> y [B, L, H, P] in x's dtype.  Per
    (batch, head), with the state S [N, P] in f32:

        S_t = exp(a * dt_t) * S_{t-1} + dt_t * b_t x_t^T
        y_t = c_t^T S_t  (+ d_skip * x_t)

    Everything is f32; the D-skip is added in f32 and y is rounded to x's
    dtype once.  A Python loop over L: for small L (the tests, the card's
    short cases)."""
    xf, dtf = x.float(), dt.float()
    bf, cf = b.float(), c.float()
    B, L, H, P = x.shape
    N = b.shape[-1]
    decay = torch.exp(a.float()[None, None, :] * dtf)  # [B, L, H]
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty((B, L, H, P), dtype=torch.float32, device=x.device)
    for t in range(L):
        S = S * decay[:, t, :, None, None] + (
            dtf[:, t, :, None, None] * bf[:, t, :, :, None]
            * xf[:, t, :, None, :])
        y[:, t] = torch.einsum("bhn,bhnp->bhp", cf[:, t], S)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype)


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
                     d_skip: torch.Tensor | None = None) -> torch.Tensor:
    """Chunked SSD (quadratic within a chunk, linear across chunks): the
    algorithm of the TPU kernel in plain tensor ops, the semantics of
    :func:`ssd_scan`.  Raises ``ValueError`` where ``chunk`` does not divide
    L, as the JAX package's does.  Holds [B, L/chunk, chunk, chunk, H] f32
    intermediates."""
    B, L, H, P = x.shape
    N = b.shape[-1]
    if L % chunk:
        raise ValueError(f"L={L} not a multiple of chunk={chunk}")
    nc = L // chunk
    xf = x.float().reshape(B, nc, chunk, H, P)
    dtf = dt.float().reshape(B, nc, chunk, H)
    bf = b.float().reshape(B, nc, chunk, H, N)
    cf = c.float().reshape(B, nc, chunk, H, N)

    log_dec = a.float()[None, None, None, :] * dtf      # [B, nc, Q, H]
    cum = torch.cumsum(log_dec, dim=2)                   # inclusive
    total = cum[:, :, -1, :]                             # [B, nc, H]

    # intra-chunk: L_ij = exp(cum_i - cum_j) for i >= j, selected (the
    # exponent is positive above the diagonal and may overflow).  The
    # exponent is selected to 0 there first as well: autograd through
    # where(mask, exp(diff), 0) multiplies an inf by 0 (NaN in ddt and da),
    # as jax.vjp of the JAX package's version does
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    zero = torch.zeros((), device=x.device)
    l_mat = torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)
    del diff
    cb = torch.einsum("bzihn,bzjhn->bzijh", cf, bf)     # [B,nc,Q,Q,H]
    w = cb * l_mat * dtf[:, :, None, :, :]
    del cb, l_mat
    y = torch.einsum("bzijh,bzjhp->bzihp", w, xf)
    del w

    # chunk states: S_z = sum_j exp(total - cum_j) dt_j b_j x_j^T
    dec_to_end = torch.exp(total[:, :, None, :] - cum) * dtf  # [B,nc,Q,H]
    s_chunk = torch.einsum("bzjhn,bzjhp->bzhnp",
                           bf * dec_to_end[..., None], xf)

    # the state entering each chunk, in order
    s_in = torch.empty_like(s_chunk)
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    decay = torch.exp(total)                              # [B, nc, H]
    for z in range(nc):
        s_in[:, z] = S
        S = S * decay[:, z, :, None, None] + s_chunk[:, z]

    # inter-chunk: y_i += c_i^T (exp(cum_i) S_in)
    y = y + torch.einsum("bzihn,bzhnp->bzihp", cf, s_in) * torch.exp(
        cum)[..., None]
    y = y.reshape(B, L, H, P)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 d_skip: torch.Tensor | None = None, chunk: int = 64):
    """The gradients of :func:`ssd_scan` for the output's gradient ``dy``
    [B, L, H, P], written out chunk by chunk in f32 (the backward kernel's
    plain version; Mamba-2's own decomposition, arXiv:2405.21060 §7).

    b and c are [B, L, G, N] with G = H (one per head; expanded views are
    taken per head, as autograd takes them) or G = 1 (one group shared by
    every head, whose gradient is the sum over the heads).  Returns (dx,
    ddt, da, db, dc, dd): dx, db and dc in the inputs' dtype, ddt, da and
    dd in f32 (dd None without ``d_skip``).  Any L: the last chunk is
    padded with dt = 0 and x, b, c, dy = 0, which add nothing.

    Per chunk of Q tokens, with cum the inclusive cumulative sum of a·dt,
    T = cum_Q, L_ij = exp(cum_i − cum_j) (selected to 0 for j > i, where
    it may overflow), W_ij = (c_i·b_j) L_ij dt_j, e_i = exp(cum_i) and
    f_j = exp(T − cum_j) dt_j, the forward is
    y_i = Σ_j W_ij x_j + e_i c_iᵀ S_in + d x_i and
    S_out = exp(T) S_in + Σ_j f_j b_j x_jᵀ.  The walk from the last chunk
    to the first carries dS = ∂/∂S_out:

        dS_in  = exp(T) dS + Σ_i e_i c_i dy_iᵀ
        dW_ij  = dy_i·x_j (j <= i),  dCB = dW ∘ L ∘ dt_j
        dx_j   = Σ_i W_ij dy_i + f_j dSᵀ b_j + d dy_j
        dc_i   = Σ_j dCB_ij b_j + e_i S_in dy_i
        db_j   = Σ_i dCB_ij c_i + f_j dS x_j
        df_j   = b_jᵀ dS x_j

    and every exponent adds to d(cum): Σ_j dW_ij W_ij to row i and minus
    that column sum to j, e_i c_iᵀ S_in dy_i, −f_j df_j, and to cum_Q
    exp(T)⟨S_in, dS⟩ + Σ_j f_j df_j.  A reverse cumulative sum over the
    chunk turns d(cum) into d(a·dt_t) = ds_t, so ddt_t = a ds_t +
    exp(T − cum_t) df_t + Σ_i dW_it (c_i·b_t) L_it, and da = Σ dt ds."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    if G not in (1, H) or c.shape[2] != G:
        raise ValueError(f"b and c have {G} and {c.shape[2]} heads; need 1 "
                         f"or H={H}")
    Q = chunk
    nc = -(-L // Q)
    pad = nc * Q - L

    def chunks(t):
        """[B, L, ...] -> [B, nc, Q, ...] f32, zero past L."""
        t = torch.nn.functional.pad(t.float(),
                                    (0, 0) * (t.dim() - 2) + (0, pad))
        return t.reshape(B, nc, Q, *t.shape[2:])

    xf, dyf = chunks(x), chunks(dy)                 # [B,nc,Q,H,P]
    bf = chunks(b).expand(B, nc, Q, H, N)           # [B,nc,Q,H,N]
    cf = chunks(c).expand(B, nc, Q, H, N)
    dtf = chunks(dt)                                # [B,nc,Q,H]
    af = a.float()
    cum = torch.cumsum(af[None, None, None, :] * dtf, dim=2)
    total = cum[:, :, -1, :]                        # [B,nc,H]
    mask = torch.ones((Q, Q), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    zero = torch.zeros((), device=x.device)
    l_mat = torch.where(mask, torch.exp(cum[:, :, :, None, :]
                                        - cum[:, :, None, :, :]), zero)
    cb_l = torch.einsum("bzihn,bzjhn->bzijh", cf, bf) * l_mat  # c·b L
    w = cb_l * dtf[:, :, None, :, :]
    e = torch.exp(cum)                              # [B,nc,Q,H]
    g = torch.exp(total[:, :, None, :] - cum)
    f = g * dtf

    # the states entering each chunk, then the adjoints leaving each
    s_local = torch.einsum("bzjhn,bzjhp->bzhnp", bf * f[..., None], xf)
    c_dy = torch.einsum("bzihn,bzihp->bzhnp", cf * e[..., None], dyf)
    decay = torch.exp(total)[..., None, None]       # [B,nc,H,1,1]
    s_in = torch.empty_like(s_local)
    d_s = torch.empty_like(s_local)
    S = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    for z in range(nc):
        s_in[:, z] = S
        S = S * decay[:, z] + s_local[:, z]
    S.zero_()
    for z in reversed(range(nc)):
        d_s[:, z] = S
        S = S * decay[:, z] + c_dy[:, z]
    del s_local, c_dy, S

    dw = torch.where(mask, torch.einsum("bzihp,bzjhp->bzijh", dyf, xf), zero)
    m = dw * w                                      # dW ∘ W
    dcb = dw * l_mat * dtf[:, :, None, :, :]
    del l_mat
    u = torch.einsum("bzjhp,bzhnp->bzjhn", xf, d_s)  # dS x_j
    v = torch.einsum("bzihp,bzhnp->bzihn", dyf, s_in)  # S_in dy_i
    bs = torch.einsum("bzjhn,bzhnp->bzjhp", bf, d_s)   # dSᵀ b_j
    dx = (torch.einsum("bzijh,bzihp->bzjhp", w, dyf) + f[..., None] * bs)
    df = (bf * u).sum(-1)                           # [B,nc,Q,H]
    dc = torch.einsum("bzijh,bzjhn->bzihn", dcb, bf) + e[..., None] * v
    db = torch.einsum("bzijh,bzihn->bzjhn", dcb, cf) + f[..., None] * u
    d_total = (decay[..., 0, 0] * (s_in * d_s).sum((-2, -1))
               + (f * df).sum(2))                   # [B,nc,H]
    dcum = (m.sum(3) - m.sum(2) + e * (cf * v).sum(-1) - f * df)
    dcum[:, :, -1] += d_total
    ds = dcum.flip(2).cumsum(2).flip(2)            # d(a dt_t)
    ddt = af * ds + g * df + (dw * cb_l).sum(2)
    da = (dtf * ds).sum((0, 1, 2))
    del dw, m, dcb, w, cb_l

    def unchunk(t):
        return t.reshape(B, nc * Q, *t.shape[3:])[:, :L]

    if d_skip is not None:
        dx = dx + d_skip.float()[None, None, None, :, None] * dyf
        dd = (dyf * xf).sum((0, 1, 2, 4))
    else:
        dd = None
    db, dc = unchunk(db), unchunk(dc)
    if G == 1:
        db, dc = db.sum(2, keepdim=True), dc.sum(2, keepdim=True)
    return (unchunk(dx).to(x.dtype), unchunk(ddt), da, db.to(b.dtype),
            dc.to(c.dtype), dd)
