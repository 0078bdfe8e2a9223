"""Faults planted under the timed path, for the tests and the control runs
that show the output check catches them.  A normal run plants none.

* ``frozen_state``: a step that returns its state unchanged (training: the
  optimizer's update does nothing; prefill: each batch is answered with
  the logits of the batch before);
* ``half_batch``: half of the batch left out (training: the step sees the
  first half of the rows, the loss the mean over them; prefill: the second
  half of the rows is answered as the first half);
* ``altered``: an answer altered where it is produced (training: the
  embedding's gradient doubled as the optimizer gets it; prefill: every
  next token moved to the following id).

A run on one card has no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
from typing import Optional

KINDS = ("frozen_state", "half_batch", "altered")


def batch(fault: Optional[str], rows):
    """The rows the program gets: ``rows`` ([B, S] tensor or array, or a
    dict of them)."""
    if fault != "half_batch":
        return rows
    if isinstance(rows, dict):
        return {k: batch(fault, v) for k, v in rows.items()}
    half = rows.shape[0] // 2
    return rows[:half]


def answer(fault: Optional[str], top, vocab: int):
    """The next tokens a prefill serves, [B, S]."""
    if fault == "altered":
        return (top + 1) % vocab
    if fault == "half_batch":
        half = top.shape[0] // 2
        return top[:half].repeat(2, 1)[:top.shape[0]]
    return top


def stale(fault: Optional[str], prefill):
    """The prefill the window calls."""
    if fault != "frozen_state":
        return prefill
    last = []

    def call(params, **inputs):
        out = prefill(params, **inputs)
        last.append(out)
        return last.pop(0) if len(last) > 1 else out
    return call


@contextlib.contextmanager
def optimizer(fault: Optional[str]):
    """The port's optimizer update with the training faults planted."""
    if fault not in ("frozen_state", "altered"):
        yield
        return
    from repro_torch.train import optimizer as opt_mod

    real = opt_mod.update

    def update(grads, state, params, cfg, shapes=None, layouts=None):
        if fault == "frozen_state":
            return params, state, {}
        grads = dict(grads, embed=grads["embed"] * 2)
        return real(grads, state, params, cfg, shapes, layouts)

    opt_mod.update = update
    try:
        yield
    finally:
        opt_mod.update = real
