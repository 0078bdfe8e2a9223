"""Training step: loss, gradients, optimizer update, microbatching.

The counterpart of ``repro/train/train_step.py`` on autograd: where the
JAX package differentiates its loss with ``jax.value_and_grad`` and scans
its microbatches, the port calls ``torch.autograd.grad`` and loops in
Python.  On the card the attention layers run the hand-written forward and
backward kernels (``kernels.flash_attention.FlashAttentionFn``), and the
mamba layers those of the SSD (``kernels.ssd_scan.SsdScanFn``).

``batch_sum`` (a data-parallel step on a mesh, ``launch/train.py``) sums a
tensor over the ranks that each hold some rows of the batch: the loss is
then this rank's share of the global batch's mean (its token sums over
every rank's token count), the MoE aux loss its share of the global
batch's (``models.moe.global_batch``), so the ranks' gradients add up to
the global batch's gradient; the metrics are the global batch's.

``tp`` (a mesh's model axis, ``models.common.TensorParallel``) runs the
model tensor-parallel: ``layers`` maps the differentiated tree (this
rank's storage shards) to the tree the model takes (each layer's
``Shards``), and the loss is the vocab-parallel cross entropy of this
rank's columns of the logits, the same on every rank of the axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.convert import reference_shapes
from repro_torch.models import Model
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import TensorParallel, cross_entropy, partition
from repro_torch.models.model_zoo import padded_vocab
from repro_torch.train import optimizer as opt_mod


BatchSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def make_loss_fn(model: Model, batch_sum: BatchSum = None,
                 tp: Optional[TensorParallel] = None,
                 layers: Optional[Callable] = None):
    """loss_fn(params, batch) -> (loss, metrics): the next-token cross
    entropy of ``batch["labels"]`` plus the MoE's load-balancing loss; a
    VLM's frontend positions are dropped from the loss.  With
    ``batch_sum``, this rank's share of the global batch's loss (see the
    module's docstring); with ``tp``, the model tensor-parallel on
    ``layers(params)``."""
    cfg = model.cfg
    vocab_start = 0 if tp is None else partition(
        padded_vocab(cfg), tp.size, tp.rank)[0]

    def loss_fn(params, batch: Dict[str, Any]):
        inputs = {k: v for k, v in batch.items() if k != "labels"}
        if layers is not None:
            params = layers(params)
        with moe_mod.global_batch(batch_sum):
            logits, aux = model.forward(params, tp=tp, **inputs)
        labels = batch["labels"]
        if cfg.frontend_tokens and not cfg.is_encdec:
            # drop the vision/audio prefix positions from the LM loss
            logits = logits[:, cfg.frontend_tokens:, :]
        # next-token objective: logits[t] predicts labels[t+1]
        loss, metrics = cross_entropy(logits[:, :-1, :], labels[:, 1:],
                                      tp=tp, vocab_start=vocab_start)
        if batch_sum is not None:
            share = metrics["tokens"] / batch_sum(metrics["tokens"])
            loss = loss * share
            metrics = {"nll": metrics["nll"] * share,
                       "z_loss": metrics["z_loss"] * share,
                       "tokens": metrics["tokens"]}
        total = loss + aux
        metrics = dict(metrics, moe_aux=aux, loss=total)
        if batch_sum is not None:
            metrics = {k: batch_sum(v.detach()) for k, v in metrics.items()}
        return total, metrics

    return loss_fn


def _split_microbatches(batch, num_micro: int):
    """The batch's rows in ``num_micro`` consecutive parts (the JAX
    package's reshape to [num_micro, B / num_micro, ...])."""
    sizes = {v.shape[0] for v in batch.values()}
    for b in sizes:
        if b % num_micro:
            raise ValueError(f"batch {b} not divisible by {num_micro} "
                             f"microbatches")
    return [{k: v[i * (v.shape[0] // num_micro):
                  (i + 1) * (v.shape[0] // num_micro)]
             for k, v in batch.items()} for i in range(num_micro)]


def make_grads_fn(model: Model, num_microbatches: int = 1,
                  grads_dtype: str = "float32", batch_sum: BatchSum = None,
                  tp: Optional[TensorParallel] = None,
                  layers: Optional[Callable] = None):
    """grads_fn(params, batch) -> (gradient tree, metrics): the train
    step's loss and autograd calls, without the update (see
    :func:`make_train_step`).  ``batch_sum``: this rank's share of a
    data-parallel batch (see the module's docstring); it stays set
    through the backward, where remat recomputes the MoE's aux.  ``tp``
    and ``layers``: the model tensor-parallel (the module's docstring)."""
    loss_fn = make_loss_fn(model, batch_sum, tp, layers)
    gdtype = getattr(torch, grads_dtype)

    def grads_of(params, batch):
        leaves = opt_mod.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with moe_mod.global_batch(batch_sum):
            loss, metrics = loss_fn(params, batch)
            flat = torch.autograd.grad(loss, leaves)
        it = iter(flat)
        grads = opt_mod.tree_map(lambda _: next(it), params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return grads, metrics

    def grads_fn(params, batch):
        if num_microbatches == 1:
            grads, metrics = grads_of(params, batch)
            return opt_mod.tree_map(lambda g: g.to(gdtype), grads), metrics
        grads, ms = None, []
        for mb in _split_microbatches(batch, num_microbatches):
            g, m = grads_of(params, mb)
            ms.append(m)
            if grads is None:
                grads = opt_mod.tree_map(lambda x: x.to(gdtype), g)
            else:
                grads = opt_mod.tree_map(
                    lambda a, x: a.add_(x.to(gdtype)), grads, g)
            del g
        grads = opt_mod.tree_map(
            lambda g: (g.float() / num_microbatches).to(gdtype), grads)
        metrics = {k: torch.stack([m[k] for m in ms]).mean() for k in ms[0]}
        return grads, metrics

    return grads_fn


def make_train_step(model: Model, opt_cfg: opt_mod.OptimizerConfig,
                    num_microbatches: int = 1, grads_dtype: str = "float32"):
    """Returns train_step(params, opt_state, batch) -> (params, state,
    metrics).

    ``batch`` holds tensors on the params' device.  num_microbatches > 1
    sums the microbatches' gradients in ``grads_dtype`` and divides by
    their count, as the JAX package's scan does; the metrics are their
    means.  grads_dtype "bfloat16" keeps the gradient tree in bf16 (the
    update's math stays f32).  The update is the optimizer's, in place,
    with weight decay and int8 moments decided on the JAX package's leaf
    shapes (``convert.reference_shapes``)."""
    grads_fn = make_grads_fn(model, num_microbatches, grads_dtype)
    shapes = reference_shapes(model.cfg)

    def train_step(params, opt_state, batch):
        grads, metrics = grads_fn(params, batch)
        new_params, new_state, opt_metrics = opt_mod.update(
            grads, opt_state, params, opt_cfg, shapes)
        return new_params, new_state, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(model: Model):
    loss_fn = make_loss_fn(model)

    @torch.no_grad()
    def eval_step(params, batch):
        _, metrics = loss_fn(params, batch)
        return metrics

    return eval_step
