"""An attention layer: the four projections; the causal pairs, 4 D FLOPs
a pair and query head."""


def macs_per_token(spec) -> int:
    d = spec.d_model
    q = spec.num_heads * spec.head_dim
    kv = spec.num_kv_heads * spec.head_dim
    return d * (q + 2 * kv) + q * d


def mixing_flops(spec, batch: int, seq: int) -> int:
    pairs = seq * (seq + 1) // 2
    return 4 * spec.head_dim * spec.num_heads * pairs * batch
