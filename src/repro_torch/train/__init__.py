"""Training and serving runtime of the port: the optimizer, the training
step on autograd, checkpointing (sharded restore too), int8 gradient
compression with error feedback over a ``torch.distributed`` group
(``grad_compression.py``; no step calls it, as in the JAX package), and
the serving steps."""

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
