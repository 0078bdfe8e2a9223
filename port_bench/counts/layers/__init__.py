"""Each sublayer's model FLOPs, one file a sublayer named as under
``reference/layers/``: ``macs_per_token(spec)``, its matmuls'
multiply-adds a token, and ``mixing_flops(spec, batch, seq)``, the FLOPs
of what mixes positions (attention's causal pairs, the SSD's chunked
products; 0 where nothing does)."""
