"""``models/costs.py``: the analytic traffic model of the port's eager
program, against the bytes ``launch/dryrun.py`` counts.

* The JAX test's orderings (``tests/test_system.py:80-93``) where they
  still hold: decode moves the parameters once (bf16 weights here, 2 bytes
  a parameter, where the JAX model reads f32 masters at 4), decode reads a
  cache, and training's activations outweigh its parameters.
* The model within 25 % of the counted bytes on the smoke configs of
  llama3-8b, dbrx-132b, mamba2-2.7b and jamba-v0.1-52b at train_4k,
  prefill_32k and decode_32k (one device, the cells' own shapes: fake
  tensors cost no memory), and on every arch's full widths at each kind,
  its depth cut to two layers (a jamba super-block) and its batch to a
  few rows, on a (2, 4) mesh, where the state is sharded, and on a (1, 8)
  mesh, where the step is tensor-parallel over eight ranks.  The
  constants are sums of per-op passes read off the port's code (the
  module's docstring), not taken from these cells.
"""

import pytest

from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.models import costs as jcosts
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import costs

from repro_torch.configs.base import list_archs

ARCHS = ["llama3-8b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b"]
CELLS = ["train_4k", "prefill_32k", "decode_32k"]
HOLD = 0.25


def test_traffic_model_orderings():
    """Params are read once per decode step (2 bytes each: bf16 serving
    weights); decode reads a cache; activations dominate training."""
    cfg = get_config("llama3-8b")
    t_train = costs.traffic_bytes(cfg, SHAPES["train_4k"], 8_000_000_000,
                                  128256)
    t_dec = costs.traffic_bytes(cfg, SHAPES["decode_32k"], 8_000_000_000,
                                128256)
    assert t_dec["params"] == pytest.approx(2 * 8e9)
    assert t_dec["cache"] > 0
    assert t_train["activations"] > t_train["params"]
    assert t_train["total"] == pytest.approx(
        sum(v for k, v in t_train.items() if k != "total"))


def test_eager_model_moves_more_than_the_fused_tpu_model():
    """The port's constants are its eager program's, not the TPU's fused
    passes: each cell's total exceeds the JAX model's."""
    for arch in ARCHS:
        for shape in CELLS:
            jcfg, cfg = jget_config(arch), get_config(arch)
            n = cfg.param_count()
            want = jcosts.traffic_bytes(jcfg, JSHAPES[shape], n,
                                        cfg.vocab_size)["total"]
            got = costs.traffic_bytes(cfg, SHAPES[shape], n,
                                      cfg.vocab_size)["total"]
            assert got > want, (arch, shape)


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_within_25_percent_of_counted_bytes(arch, shape):
    rec = dryrun.lower_cell(arch, shape, mesh_shape="none", variant="smoke")
    assert rec["status"] == "ok"
    counted = rec["counted_bytes_global"]
    model = rec["traffic_model_bytes_global"]["total"]
    assert abs(model / counted - 1.0) <= HOLD, (model, counted)


#: a full-width cell's rows, cut to keep the fake step quick
FULL_BATCH = {"train_4k": 8, "prefill_32k": 2, "decode_32k": 16}


@pytest.mark.parametrize("shape", CELLS)
@pytest.mark.parametrize("arch", list_archs())
def test_model_within_25_percent_at_full_width(arch, shape):
    cfg = get_config(arch)
    layers = cfg.attn_layer_period if cfg.is_hybrid else 2
    rec = dryrun.lower_cell(arch, shape, mesh_shape="none", layers=layers,
                            batch=FULL_BATCH[shape])
    assert rec["status"] == "ok"
    counted = rec["counted_bytes_global"]
    model = rec["traffic_model_bytes_global"]["total"]
    assert abs(model / counted - 1.0) <= HOLD, (model, counted)


@pytest.mark.parametrize("moments", ["int8", "fp32"])
@pytest.mark.parametrize("arch,layers", [("llama3-8b", 2),
                                         ("dbrx-132b", 1)])
def test_model_within_25_percent_on_a_sharded_state(arch, layers, moments):
    """Each rank gathers every leaf and updates its own shard: a cell whose
    bytes are mostly the parameters' (full width, 8 rows of 64; dbrx's
    expert stacks gathered along both mesh axes)."""
    rec = dryrun.lower_cell(arch, "train_4k", mesh_shape=(2, 4),
                            layers=layers, batch=8, seq=64, moments=moments)
    assert rec["status"] == "ok"
    model = rec["traffic_model_bytes_global"]
    counted = rec["counted_bytes_global"]
    assert model["params"] / model["total"] > 0.5
    assert abs(model["total"] / counted - 1.0) <= HOLD, (model, counted)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch,layers,seq", [("llama3-8b", 2, 512),
                                             ("mamba2-2.7b", 2, 256),
                                             ("dbrx-132b", 1, 256)])
def test_model_within_25_percent_on_a_tensor_parallel_mesh(arch, layers,
                                                           seq, shape):
    """One node of eight ranks on ``model`` (1 x 8): each rank computes
    with its heads, channels, experts and vocabulary columns, gathers its
    layers and runs the model axis's collectives (full width, 2 rows; a
    decode cell's caches split by sequence over the eight ranks)."""
    rec = dryrun.lower_cell(arch, shape, mesh_shape=(1, 8), layers=layers,
                            batch=2, seq=seq)
    assert rec["status"] == "ok"
    model = rec["traffic_model_bytes_global"]["total"]
    counted = rec["counted_bytes_global"]
    assert abs(model / counted - 1.0) <= HOLD, (model, counted)
