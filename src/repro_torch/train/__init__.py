"""Serving steps of the runtime: prefill and greedy decoding.  The
optimizer, training step, checkpointing and gradient compression come with
the training slice."""

from repro_torch.train.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill)

__all__ = ["greedy_generate", "make_decode_step", "make_prefill"]
