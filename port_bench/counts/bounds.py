"""The least time of an operation on the card: the larger of its bytes at
the HBM rate and its operations at the peak rate of its inputs' type.

A frozen copy of the port's ``kernels/bounds.py`` (``_bound``,
``ssd_bound``, ``ssd_bwd_bound``) with the chunks fixed, and the AdamW
update's bytes.  Each bound counts each input byte read once and each
output byte written once, whatever an implementation reads again, so a
roofline share reads the same work whatever implements the operation.

Hand-worked values (the cells' shapes, bf16 inputs, one group of b and c):

* SSD forward, mamba2-2.7b prefill layer, (B, L, H, P, N) = (4, 2048, 80,
  64, 128): bytes 2·4·2048·80·64·2 (x, y) + 4·2048·80·4 (dt) + 2·80·4 (a,
  d) + 2·4·2048·128·2 (b, c) = 174,588,544; operations 4 rows × 16 chunks
  × [80 (128·129·64 + 4·128·128·64) + 128·129·128] = 27,020,754,944;
  0.052116 ms by bytes (operations 0.027321 ms).
* SSD forward, jamba-v0.1-52b prefill layer, (4, 2048, 128, 64, 16):
  bytes 268,435,456 + 4,194,304 + 1,024 + 524,288 = 273,155,072, 0.081539
  ms by bytes.
* SSD backward, mamba2-2.7b training layer, (2, 4096, 80, 64, 128), chunk
  64: bytes 3·2·4096·80·64·2 + 2·2·4096·80·4 + 2·(2·2·4096·128·2) + 3·80·4
  + 80·4 = 265,291,008; 0.079191 ms by bytes.
* AdamW over n f32 parameters: 32 n bytes (the global norm reads the
  gradient, 4 B; the update reads the parameter, gradient and both
  moments, 16 B, and writes the parameter and both moments, 12 B):
  2,702,968,320 parameters (mamba2-2.7b, its table padded to 50,432
  rows) -> 86.49 GB, 25.819 ms.
"""

from __future__ import annotations

from counts.peaks import BF16_OPS_PER_S, F32_OPS_PER_S, HBM_BYTES_PER_S

#: the SSD forward's chunk in :func:`ssd_bound` (the plain chunked
#: version's), and the backward kernel's chunk in :func:`ssd_bwd_bound`
SSD_FWD_CHUNK = 128
SSD_BWD_CHUNK = 64
#: bytes one f32 parameter's AdamW step with a global-norm clip moves
ADAMW_BYTES_PER_PARAM = 32


def bound(nbytes: int, ops: int, x_bytes: int, tensor_cores: bool):
    """(bytes, operations, bound_ms, "bytes" or "operations")."""
    peak = (BF16_OPS_PER_S if tensor_cores and x_bytes == 2
            else F32_OPS_PER_S)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def ssd_bound(shape, x_bytes: int, grouped: bool):
    """shape (B, L, H, P, N): x, dt, a, d and the distinct elements of b
    and c read once, y written once; per chunk of q tokens and head, W x on
    the q(q+1)/2 causal pairs, c S and the state update, q(q+1)P + 4qNP,
    and c·b once per group, q(q+1)N."""
    B, L, H, P, N = shape
    groups = 1 if grouped else H
    bc = 2 * B * L * N * groups * x_bytes
    nbytes = 2 * B * L * H * P * x_bytes + B * L * H * 4 + 2 * H * 4 + bc
    ops = 0
    for q0 in range(0, L, SSD_FWD_CHUNK):
        q = min(SSD_FWD_CHUNK, L - q0)
        ops += H * (q * (q + 1) * P + 4 * q * N * P) + groups * q * (q + 1) * N
    return bound(nbytes, ops * B, x_bytes, tensor_cores=True)


def ssd_bwd_bound(shape, x_bytes: int, grouped: bool, skip: bool):
    """The SSD backward: x, dy, dt, a, d and the distinct b and c read
    once, dx, ddt, da, dd, db and dc written once; per chunk of q tokens
    and head 2q(q+1)(P + N) + 10qNP operations, and q(q+1)N a group."""
    B, L, H, P, N = shape
    groups = 1 if grouped else H
    bc = 2 * B * L * N * groups * x_bytes
    nbytes = (3 * B * L * H * P * x_bytes + 2 * B * L * H * 4 + 2 * bc
              + (3 if skip else 2) * H * 4 + (H * 4 if skip else 0))
    ops = 0
    for q0 in range(0, L, SSD_BWD_CHUNK):
        q = min(SSD_BWD_CHUNK, L - q0)
        ops += (H * (2 * q * (q + 1) * (P + N) + 10 * q * N * P)
                + groups * q * (q + 1) * N)
    return bound(nbytes, ops * B, x_bytes, tensor_cores=True)


def adamw_bound_ms(n_params: int) -> float:
    """The least time of one f32 AdamW step with a global-norm clip over
    ``n_params`` parameters: 32 bytes each at the HBM rate."""
    return ADAMW_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
