"""Device milliseconds a prefill inside the MoE layers: CUDA events around
each layer's ``moe_forward``, summed over the layers (the prefill keeps the
device busy, so a span is its kernels' time)."""

UNIT, SOURCE, LAYER = "ms", "program_span", "MoE"
MOVES = "prefill_tokens_per_s"


def read(run):
    spans = (run.trace.spans.get("moe") if run.kind == "prefill"
             and run.trace is not None else None)
    if not spans:
        return None
    return sum(spans) / run.trace.iterations
