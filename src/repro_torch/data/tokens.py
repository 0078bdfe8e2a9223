"""Token data plane: synthetic corpus -> chunk store -> sharded reads.

The paper's data discipline applied to LM training: the corpus lives in the
object store as a chunked 2-D array of token shards; each data-parallel
host owns a disjoint shard list (core.tiling.TileAssignment — the same
mapping that assigns UTM tiles to imagery workers) and reads only its
shards through festivus, at the 4 MiB-block sweet spot.

The synthetic corpus is a deterministic mixture ("zipfian ngram chains") so
loss curves are reproducible across runs/pipelines without shipping data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.tiling import TileAssignment


@dataclasses.dataclass(frozen=True)
class TokenDatasetSpec:
    name: str = "corpus"
    num_shards: int = 64
    shard_tokens: int = 65536
    vocab_size: int = 512
    seed: int = 0


def _shard_tokens(spec: TokenDatasetSpec, shard: int) -> np.ndarray:
    """Deterministic zipfian Markov-chain tokens for one shard."""
    rng = np.random.default_rng(spec.seed * 100003 + shard)
    v = spec.vocab_size
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    # order-1 chain: next-token distribution is a seeded rotation of zipf
    out = np.empty(spec.shard_tokens, dtype=np.int32)
    out[0] = rng.choice(v, p=probs)
    shift = rng.integers(1, v, size=16)
    draws = rng.choice(v, size=spec.shard_tokens, p=probs)
    for i in range(1, spec.shard_tokens):
        # mix: 70% chain-following (predictable), 30% zipf draw
        if draws[i] % 10 < 7:
            out[i] = (out[i - 1] + shift[out[i - 1] % 16]) % v
        else:
            out[i] = draws[i]
    return out


def write_corpus(cs: ChunkStore, spec: TokenDatasetSpec) -> None:
    """Materialize the corpus as one chunked [num_shards, shard_tokens] array."""
    arr = cs.create(spec.name, (spec.num_shards, spec.shard_tokens),
                    np.int32, (1, spec.shard_tokens), codec="zlib")
    for s in range(spec.num_shards):
        arr.write_chunk((s, 0), _shard_tokens(spec, s)[None, :])


class TokenDataset:
    """Sharded sequential reader: batches for one data-parallel rank."""

    def __init__(self, cs: ChunkStore, spec: TokenDatasetSpec,
                 rank: int = 0, num_ranks: int = 1):
        self.cs = cs
        self.spec = spec
        self.arr = cs.open(spec.name)
        assignment = TileAssignment(
            [str(i) for i in range(spec.num_shards)], num_ranks,
            mode="contiguous")
        self.my_shards = [int(k) for k in assignment.shard(rank)]
        if not self.my_shards:
            raise ValueError(f"rank {rank}/{num_ranks}: no shards")

    def batches(self, batch_size: int, seq_len: int,
                start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yields {tokens, labels}: deterministic, resumable at any step."""
        need = seq_len + 1  # +1 for the shifted label
        per_shard = self.spec.shard_tokens // need
        total = len(self.my_shards) * per_shard
        idx = (start_step * batch_size) % max(1, total)
        while True:
            rows = []
            for _ in range(batch_size):
                shard = self.my_shards[(idx // per_shard) % len(self.my_shards)]
                off = (idx % per_shard) * need
                row = self.arr.read_region((shard, off), (shard + 1, off + need))
                rows.append(row[0])
                idx = (idx + 1) % total
            block = np.stack(rows)  # [B, seq+1]
            yield {"tokens": block[:, :-1].astype(np.int32),
                   "labels": block[:, :-1].astype(np.int32),
                   "targets_full": block.astype(np.int32)}
