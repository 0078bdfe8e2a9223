"""Training and serving runtime of the port: the optimizer, the training
step on autograd, checkpointing (sharded restore too), and the serving
steps.  Gradient compression (``repro/train/grad_compression.py``) is
not ported yet (``ROADMAP.md`` queue 1 item 8 (c))."""

from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.optimizer import AdamState, OptimizerConfig
from repro_torch.train.serve_step import (greedy_generate, make_decode_step,
                                          make_prefill)
from repro_torch.train.train_step import (make_eval_step, make_loss_fn,
                                          make_train_step)

__all__ = [
    "AdamState", "CheckpointManager", "OptimizerConfig", "greedy_generate",
    "make_decode_step", "make_eval_step", "make_loss_fn", "make_prefill",
    "make_train_step",
]
