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
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    check_causal(Sq, Sk, causal)
    group = Hq // Hkv
    scale = (D ** -0.5) if scale is None else scale
    qf = q.float().reshape(B, Hkv, group, Sq, D)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        logits = logits.masked_fill(_causal_hidden(Sq, Sk, 0, Sq, q.device),
                                    float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


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


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """One-token decode: q [B, Hq, 1, D], caches [B, Hkv, S, D] ->
    [B, Hq, 1, D] in q's dtype.  Only the first ``cache_len`` positions are
    read (the tail may be uninitialised).  q is cast to the cache's dtype
    and the probabilities too before the weighted sum, both products
    accumulate in f32: the JAX oracle's ``preferred_element_type``, which
    upcasting the valid prefix reproduces exactly, because a product of two
    bf16 values is exact in f32.  The upcast is one layer's prefix, not a
    copy of the whole cache."""
    B, Hq, _, D = q.shape
    Hkv = k_cache.shape[1]
    group = Hq // Hkv
    qf = q.reshape(B, Hkv, group, D).to(k_cache.dtype).float()
    kf = k_cache[:, :, :cache_len].float()
    logits = torch.einsum("bhgd,bhkd->bhgk", qf, kf) * (D ** -0.5)
    probs = torch.softmax(logits, dim=-1)
    vf = v_cache[:, :, :cache_len].float()
    out = torch.einsum("bhgk,bhkd->bhgd",
                       probs.to(v_cache.dtype).float(), vf)
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
    # exponent is positive above the diagonal and may overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # [B,nc,Q,Q,H]
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    l_mat = torch.where(mask, torch.exp(diff), torch.zeros((), device=x.device))
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
