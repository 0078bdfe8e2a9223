"""A SwiGLU FFN: its three matrices."""


def macs_per_token(spec) -> int:
    return 3 * spec.d_model * spec.d_ff


def mixing_flops(spec, batch: int, seq: int) -> int:
    return 0
