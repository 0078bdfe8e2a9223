"""Token rows from the seed: the one generator every traffic mix reads.

A frozen copy of the port's corpus generator (``data/tokens.py``), made
to draw many rows at once: every row is an order-1 chain over the whole
vocabulary in which each token follows its predecessor by a seeded shift
(``chain_share`` of the tokens) or is a Zipf draw (the rest).  Rows are
drawn together, one column at a time, so a pool of rows costs as many
NumPy steps as a row has tokens.  Every row differs from every other.
"""

from __future__ import annotations

import numpy as np


def rows(seed: int, stream: int, n_rows: int, length: int, vocab: int,
         chain_share: float) -> np.ndarray:
    """[n_rows, length] int32 ids in [0, vocab), the same for the same
    (seed, stream)."""
    rng = np.random.default_rng([seed % (1 << 64), stream])
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    shift = rng.integers(1, vocab, size=16)
    draws = rng.choice(vocab, size=(n_rows, length), p=probs)
    follow = rng.random((n_rows, length)) < chain_share
    out = np.empty((n_rows, length), dtype=np.int64)
    out[:, 0] = draws[:, 0]
    for i in range(1, length):
        prev = out[:, i - 1]
        out[:, i] = np.where(follow[:, i], (prev + shift[prev % 16]) % vocab,
                             draws[:, i])
    return out.astype(np.int32)
