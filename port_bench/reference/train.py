"""Plain float32 training steps: the loss, its gradients and AdamW.

AdamW as the configuration's training block states it: the gradients'
global norm clipped to ``clip``, bias-corrected moments, decoupled weight
decay on the leaves ``decays`` names, a linear warm-up of the learning
rate (a cosine after it), each parameter's new value rounded once to its
storage type.  ``masters`` picks that storage: float32 is the
configuration's; bfloat16 is the control, the step below it.

The forward runs layer by layer under ``torch.utils.checkpoint``, so that
the reference fits beside nothing but its own state: every layer's
activations are recomputed in the backward.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from reference import model


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    warmup: int
    decay_steps: int
    min_lr_ratio: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip: float = 1.0

    def lr_at(self, step: int) -> float:
        """Learning rate of step ``step`` (counted from 1)."""
        if step < self.warmup:
            return self.lr * step / max(1, self.warmup)
        prog = min(1.0, max(0.0, (step - self.warmup)
                            / max(1, self.decay_steps - self.warmup)))
        return self.lr * (self.min_lr_ratio + (1 - self.min_lr_ratio) * 0.5
                          * (1 + math.cos(math.pi * prog)))


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Path -> tensor over nested dicts and lists ("blocks.3.mamba.w_xz")."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def decays(path: str, t: torch.Tensor) -> bool:
    """Weight decay falls on every leaf of a layer and on every top-level
    matrix: the layers' leaves are stacked over depth in the training
    step's own reckoning, so each is a matrix there (the final norm's
    scale, a top-level vector, is the one leaf without decay)."""
    return path.startswith("blocks.") or t.dim() >= 2


def loss_of(params: dict, spec: model.Spec, tokens: torch.Tensor,
            z_loss_weight: float) -> torch.Tensor:
    """The next-token loss of ``tokens`` [B, S], every layer checkpointed."""
    x = model.embed(params["embed"], tokens)
    for p, (mixer, ff) in zip(params["blocks"], model.layer_plan(spec)):
        x = checkpoint(lambda x, p=p, m=mixer, f=ff:
                       model.block(p, spec, m, f, x), x, use_reentrant=False)
    return model.cross_entropy(model.head(params, spec, x), tokens,
                               z_loss_weight)


def run(make_params: Callable[[], dict], spec: model.Spec,
        batches: List[torch.Tensor], opt: AdamW, z_loss_weight: float,
        masters: torch.dtype = torch.float32) -> dict:
    """Steps 1..len(batches) from ``make_params()`` (float32 leaves, the
    initial parameters; called twice, the second time for the change):
    each step's loss, the per-leaf norm of step 1's clipped gradient, and
    the per-leaf norm of the parameters' change over all the steps."""
    params = make_params()
    named = leaves(params)
    with torch.no_grad():
        for p in named.values():
            p.copy_(p.to(masters).float())
            p.requires_grad_(True)
    mu = {k: torch.zeros_like(v, dtype=masters) for k, v in named.items()}
    nu = {k: torch.zeros_like(v, dtype=masters) for k, v in named.items()}
    losses, grad_norms = [], {}
    with model.no_tf32():
        for step, tokens in enumerate(batches, start=1):
            loss = loss_of(params, spec, tokens, z_loss_weight)
            grads = torch.autograd.grad(loss, list(named.values()))
            losses.append(float(loss.detach()))
            with torch.no_grad():
                norm = torch.sqrt(sum(g.pow(2).sum() for g in grads))
                factor = torch.clamp(opt.clip / (norm + 1e-9), max=1.0)
                lr = opt.lr_at(step)
                bc1 = 1 - opt.beta1 ** step
                bc2 = 1 - opt.beta2 ** step
                for (k, p), g in zip(named.items(), grads):
                    g = g * factor
                    if step == 1:
                        grad_norms[k] = float(g.norm())
                    m = opt.beta1 * mu[k].float() + (1 - opt.beta1) * g
                    v = opt.beta2 * nu[k].float() + (1 - opt.beta2) * g * g
                    upd = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
                    if decays(k, p):
                        upd = upd + opt.weight_decay * p
                    p.copy_((p - lr * upd).to(masters).float())
                    mu[k].copy_(m.to(masters))
                    nu[k].copy_(v.to(masters))
            del grads
    del mu, nu
    change = {}
    with torch.no_grad():
        for k, p0 in leaves(make_params()).items():
            change[k] = float((named[k] - p0.to(masters).float()).norm())
    return {"loss": losses, "grad_norms": grad_norms, "change_norms": change}
