"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches must
see the real single CPU device; only launch/dryrun.py forces 512."""

import jax
import numpy as np
import pytest

from repro.core import ChunkStore, Festivus, InMemoryObjectStore


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA sm_90 card and nvcc; skips "
        "elsewhere (run on the card with `-m cuda`)")


@pytest.fixture
def store():
    return InMemoryObjectStore()


@pytest.fixture
def fs(store):
    return Festivus(store)


@pytest.fixture
def chunkstore(fs):
    return ChunkStore(fs, "arrays")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
