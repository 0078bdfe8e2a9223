"""The reference's sublayers, one file each, found by the name a
configuration's layer ``pattern`` gives (``reference.model.sublayer``).

Each file has ``layout(spec)``, the sublayer's leaves as (name, shape,
kind) in the order the benchmark draws them (``harness/weights.py``), and
``forward(p, spec, h, margins=None)``, the sublayer in float32 on its
normed input h [B, S, d].  A new sublayer is a new file here and, for the
model FLOPs, one under ``counts/layers/``.
"""
