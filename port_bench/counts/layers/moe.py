"""An MoE: the router and the k active experts' three matrices, with no
capacity padding."""


def macs_per_token(spec) -> int:
    d = spec.d_model
    return d * spec.num_experts + spec.experts_per_token * 3 * d * spec.d_ff


def mixing_flops(spec, batch: int, seq: int) -> int:
    return 0
