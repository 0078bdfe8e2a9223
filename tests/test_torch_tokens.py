"""The port's token data plane (repro_torch.data.tokens, a copy of the JAX
package's with the import prefix changed, and data.pipeline) against the
JAX package, on the CPU.

The corpus is byte-identical between the packages (the same objects under
the same keys), and so are the batches read back at any step.
``PrefetchLoader`` keeps the order of its source and raises a source's
error on the ``next()`` after its last good batch, as
tests/test_train.py:205 holds the JAX package's; with ``device`` it hands
out tensors there (on the card: tests/test_torch_cuda.py).  The two
examples that train on this data plane (``quickstart``, ``train_lm``) run
on the CPU to their markers.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import ChunkStore as JChunkStore
from repro.core import Festivus as JFestivus
from repro.core import InMemoryObjectStore as JInMemory
from repro.data import tokens as jtokens
from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore
from repro_torch.data import (PrefetchLoader, TokenDataset, TokenDatasetSpec,
                              write_corpus)
from repro_torch.examples import quickstart, train_lm

SPEC = dict(num_shards=4, shard_tokens=2048, vocab_size=96, seed=3)


def _both():
    jstore, store = JInMemory(), InMemoryObjectStore()
    jcs = JChunkStore(JFestivus(jstore), "data")
    cs = ChunkStore(Festivus(store), "data")
    jtokens.write_corpus(jcs, jtokens.TokenDatasetSpec(**SPEC))
    write_corpus(cs, TokenDatasetSpec(**SPEC))
    return (jstore, jcs), (store, cs)


def test_corpus_is_byte_identical_between_the_packages():
    (jstore, _), (store, _) = _both()
    keys = sorted(store.list("data/"))
    assert keys and keys == sorted(jstore.list("data/"))
    for k in keys:
        assert bytes(store.get(k)) == bytes(jstore.get(k)), k


@pytest.mark.parametrize("start_step", [0, 3])
@pytest.mark.parametrize("ranks", [1, 2])
def test_batches_equal_the_jax_packages(start_step, ranks):
    (_, jcs), (_, cs) = _both()
    for rank in range(ranks):
        jds = jtokens.TokenDataset(jcs, jtokens.TokenDatasetSpec(**SPEC),
                                   rank=rank, num_ranks=ranks)
        ds = TokenDataset(cs, TokenDatasetSpec(**SPEC), rank=rank,
                          num_ranks=ranks)
        assert ds.my_shards == jds.my_shards
        for _, a, b in zip(range(4), ds.batches(3, 40, start_step),
                           jds.batches(3, 40, start_step)):
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_order_and_errors():
    loader = PrefetchLoader(iter(range(5)), depth=2)
    assert list(loader) == [0, 1, 2, 3, 4]

    def bad():
        yield 1
        raise ValueError("source died")

    loader = PrefetchLoader(bad(), depth=1)
    assert next(loader) == 1
    with pytest.raises(ValueError, match="source died"):
        next(loader)


def test_prefetch_loader_places_batches_on_its_device_in_order():
    def batches():
        for i in range(6):
            yield {"tokens": np.full((2, 3), i, np.int32),
                   "labels": np.arange(6, dtype=np.int32).reshape(2, 3) + i}
        raise RuntimeError("store went away")

    loader = PrefetchLoader(batches(), depth=2, device="cpu")
    got = [next(loader) for _ in range(6)]
    for i, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor)
        assert b["tokens"].dtype == torch.int32 and int(b["tokens"][0, 0]) == i
        assert int(b["labels"][1, 2]) == 5 + i
    with pytest.raises(RuntimeError, match="store went away"):
        next(loader)


def test_tokens_module_differs_from_the_jax_module_only_in_the_prefix():
    src = Path(__file__).resolve().parents[1] / "src"
    jax_side = (src / "repro" / "data" / "tokens.py").read_text()
    port = (src / "repro_torch" / "data" / "tokens.py").read_text()
    assert port == jax_side.replace("repro.", "repro_torch.")


# ---------------------------------------------------------------------------
# the examples that train on this data plane, on the CPU
# ---------------------------------------------------------------------------
def test_quickstart_example_runs_on_the_cpu(capsys):
    quickstart.main(device="cpu")
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == "QUICKSTART_OK"
    assert "cpu" in out


def test_train_lm_example_runs_on_the_cpu(capsys):
    """A cut run (10 steps of 2 x 32 tokens; the example's defaults are
    the card's 200 of 8 x 256): the nll must still fall."""
    train_lm.main(["--device", "cpu", "--steps", "10", "--batch", "2",
                   "--seq", "32"])
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == "TRAIN_LM_OK"
