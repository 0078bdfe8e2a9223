"""The least time each hand-written kernel's function could take on the card.

Each ``*_bound`` returns ``(bytes, operations, bound_ms, bound_by)``: the
bytes the function must move (each input read once, each output written
once), the operations it does on these inputs, and the larger of the two
times, bytes at the HBM rate and operations at the peak rate of the
inputs' type (``core/perfmodel.py``'s ``H100_*`` data sheet figures).
``chip_smoke.py`` prints them beside each kernel's measured time, and the
LM kernels' custom ops (``flash_attention.py``, ``ssd_scan.py``) give
their operation counts to ``torch.utils.flop_counter``.
"""

from __future__ import annotations

from repro_torch.core.perfmodel import (H100_HBM_BYTES_PER_S,
                                        H100_PEAK_BF16_OPS_PER_S,
                                        H100_PEAK_F32_OPS_PER_S)

#: the SSD's chunk in :func:`ssd_bound`: the plain chunked version's
SSD_CHUNK = 128


def _bound(nbytes: int, ops: int, x_bytes: int, tensor_cores: bool):
    peak = (H100_PEAK_BF16_OPS_PER_S if tensor_cores and x_bytes == 2
            else H100_PEAK_F32_OPS_PER_S)
    bytes_ms = nbytes / H100_HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def composite_bound(shape, x_bytes: int, w_bytes: int):
    """[T, H, W, C] images and [T, H, W] weights read once, the [H, W, C]
    composite written once; 2TC + T + C operations a pixel, in f32."""
    T, H, W, C = shape
    nbytes = T * H * W * (C * x_bytes + w_bytes) + H * W * C * x_bytes
    ops = 2 * T * H * W * C + T * H * W + H * W * C
    return _bound(nbytes, ops, x_bytes, tensor_cores=False)


def grad_mag_bound(shape, x_bytes: int):
    """Each image and valid byte read once, both [H, W] f32 outputs written
    once; 8C + 8 operations per pixel and timestep, in f32."""
    T, H, W, C = shape
    nbytes = T * H * W * (C * x_bytes + 1) + 2 * 4 * H * W
    ops = (8 * C + 8) * T * H * W
    return _bound(nbytes, ops, x_bytes, tensor_cores=False)


def _pairs(Sq: int, Sk: int, causal: bool) -> int:
    """Visible (query, key) pairs: query i sees min(Sk, i + 1 + Sk - Sq)
    keys when causal."""
    return Sq * (Sk - Sq) + Sq * (Sq + 1) // 2 if causal else Sq * Sk


def flash_bound(shape, causal: bool, x_bytes: int):
    """shape (B, Hq, Hkv, Sq, Sk, D): the scores and the weighted sum, 4·D
    operations per visible (query, key) pair; q, k, v read once and the
    output written once."""
    B, Hq, Hkv, Sq, Sk, D = shape
    ops = 4 * D * B * Hq * _pairs(Sq, Sk, causal)
    nbytes = x_bytes * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    return _bound(nbytes, ops, x_bytes, tensor_cores=True)


def bwd_bound(shape, causal: bool, x_bytes: int):
    """The flash backward: five products (S, dP, dV, dK, dQ) of 2·D
    operations per visible pair, 10·D; q, k, v, o, dO and the f32
    log-sum-exp read once, dq, dk and dv written once."""
    B, Hq, Hkv, Sq, Sk, D = shape
    ops = 10 * D * B * Hq * _pairs(Sq, Sk, causal)
    nbytes = (x_bytes * (4 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
              + 4 * B * Hq * Sq + x_bytes * (B * Hq * Sq * D
                                             + 2 * B * Hkv * Sk * D))
    return _bound(nbytes, ops, x_bytes, tensor_cores=True)


def ssd_bound(shape, x_bytes: int, grouped: bool, chunk: int = SSD_CHUNK):
    """shape (B, L, H, P, N): x, dt, a, d and the distinct elements of b and
    c (one group's when ``grouped``) read once, y written once; the
    operations of the chunked algorithm at ``chunk`` over the causal pairs
    only: per head, W x on the q(q+1)/2 pairs j <= i, then c S and the
    state update, q(q+1)P + 4qNP a chunk of q tokens; c·b once per group,
    q(q+1)N a chunk."""
    B, L, H, P, N = shape
    groups = 1 if grouped else H
    bc = 2 * B * L * N * groups * x_bytes
    nbytes = 2 * B * L * H * P * x_bytes + B * L * H * 4 + 2 * H * 4 + bc
    ops = 0
    for q0 in range(0, L, chunk):
        q = min(chunk, L - q0)
        ops += H * (q * (q + 1) * P + 4 * q * N * P) + groups * q * (q + 1) * N
    return _bound(nbytes, ops * B, x_bytes, tensor_cores=True)


def ssd_bwd_bound(shape, x_bytes: int, grouped: bool, skip: bool,
                  chunk: int):
    """The SSD backward: x, dy, dt, a, d and the distinct b and c read once,
    dx, ddt, da, dd, db and dc written once; the operations at ``chunk``
    (the kernel's, ``kernels/ssd_scan.py:CHUNK``), on the causal pairs
    only, per chunk of q tokens and head 2q(q+1)(P + N) (dW = dy xᵀ,
    Wᵀ dy, dCB b, dCBᵀ c) and 10qNP (the state recompute, dSᵀ b, S_in dy,
    dS x and dS_in), and c·b once per group, q(q+1)N.  A smaller chunk
    needs fewer pair products (down to the 10NP state terms a token), so
    in f32, where the operations bound it, the function's own least time
    is lower still."""
    B, L, H, P, N = shape
    groups = 1 if grouped else H
    bc = 2 * B * L * N * groups * x_bytes
    nbytes = (3 * B * L * H * P * x_bytes + 2 * B * L * H * 4 + 2 * bc
              + (3 if skip else 2) * H * 4 + (H * 4 if skip else 0))
    ops = 0
    for q0 in range(0, L, chunk):
        q = min(chunk, L - q0)
        ops += (H * (2 * q * (q + 1) * (P + N) + 10 * q * N * P)
                + groups * q * (q + 1) * N)
    return _bound(nbytes, ops * B, x_bytes, tensor_cores=True)
