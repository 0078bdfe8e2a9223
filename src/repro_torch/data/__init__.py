"""Data plane of the port: the token corpus (``tokens.py``, a copy of the
JAX package's, numpy only, so both packages write identical bytes),
synthetic imagery (numpy-seeded likewise), and the prefetch pipeline that
copies batches to the card."""

from repro_torch.data.pipeline import PrefetchLoader
from repro_torch.data.tokens import TokenDataset, TokenDatasetSpec, write_corpus

__all__ = ["PrefetchLoader", "TokenDataset", "TokenDatasetSpec",
           "write_corpus"]
