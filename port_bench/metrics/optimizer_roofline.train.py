"""The f32 AdamW update's least time (32 B a parameter at the HBM rate,
``counts.bounds.adamw_bound_ms``) over its device time a step, from CUDA
events around ``train.optimizer.update``."""

from counts import bounds

UNIT, SOURCE, LAYER = "%", "program_span", "optimizer"
MOVES = "train_tokens_per_s"


def read(run):
    spans = (run.trace.spans.get("optimizer") if run.kind == "train"
             and run.trace is not None else None)
    if not spans:
        return None
    return 100.0 * bounds.adamw_bound_ms(run.n_params) / (
        sum(spans) / len(spans))
