"""A Mamba-2 layer: the in-projection to x, z, B, C and dt and the
out-projection; the SSD's chunked products at a chunk of 128
(``bounds.ssd_bound``'s operations).  The convolution and the gated norm
are not counted."""

from counts.bounds import ssd_bound


def macs_per_token(spec) -> int:
    d, di, N, H = spec.d_model, spec.d_inner, spec.ssm_state, spec.ssm_heads
    return d * (2 * di + 2 * N + H) + di * d


def mixing_flops(spec, batch: int, seq: int) -> int:
    shape = (batch, seq, spec.ssm_heads, spec.ssm_head_dim, spec.ssm_state)
    return ssd_bound(shape, 2, grouped=True)[1]
