"""``launch/train.py``'s tensor-parallel mesh step on gloo, several ranks on
the CPU: the dense and MoE models, the layouts the rule table's storage
does not give, and sequence parallelism.

Each step case runs one train step from the JAX package's initial
parameters on a batch made from a seed, its model tensor-parallel over
``model`` (Megatron attention, FFN and mamba, expert parallelism, the
vocab-parallel embedding and loss, each layer gathered and its gradient
reduce-scattered back), and the tests hold what the ranks wrote

* against the port's single-process step on the same parameters and rows:
  the loss and every gradient to f32 3e-5 (the ranks sum in another
  order), the parameters after the step as ``tests/test_torch_mesh.py``
  holds them;
* against the JAX package's jitted ``make_train_step`` under
  ``tests/test_torch_train.py``'s tolerances.

A module fixture starts the ranks once (``tests/torch_tp_cases.py``:
one world a mesh shape, all at once, the references computed while they
run).

The cases: llama3-8b and dbrx-132b (MoE: expert parallelism, the router
on every rank) at 1 x 2, 1 x 4 and 2 x 2; KV heads fewer than the model
axis (the smoke configs' 2 on 4, and qwen2-72b's, with the q/k/v biases'
slices); query heads the axis does not divide (6 on 4, with 2 and with 6
KV heads); ``sequence_parallel=True`` on llama and dbrx (the MoE routing
the gathered sequence); llama4-maverick at 1 x 2 (its shared expert's
columns beside the rank's experts).  A prefill case at
1 x 2 holds the logits, each rank's vocabulary columns gathered, against
the single-process forward.  Two gather cases take every layer of jamba
through ``sharding.gather_layer`` and back against the gather-whole path.
``tests/test_torch_tp_families.py`` has the mamba, hybrid, enc-dec and
VLM cases.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.convert import params_from_numpy
from repro_torch.models import build
from torch_tp_cases import (F32, HEADS_6_2, HEADS_6_6, SEQPAR, batch_of,
                            cfgs, hold_against_jax, hold_against_single,
                            inputs, key, run_ranks, single)

#: name -> (arch, config change, (data, model), frontend frames)
CASES = {
    "llama_1x2": ("llama3-8b", {}, (1, 2), 0),
    "llama_1x4": ("llama3-8b", {}, (1, 4), 0),  # 2 KV heads on 4 ranks
    "llama_2x2": ("llama3-8b", {}, (2, 2), 0),
    "dbrx_1x2": ("dbrx-132b", {}, (1, 2), 0),
    "dbrx_1x4": ("dbrx-132b", {}, (1, 4), 0),
    "dbrx_2x2": ("dbrx-132b", {}, (2, 2), 0),
    "heads_6_2_1x4": ("llama3-8b", HEADS_6_2, (1, 4), 0),
    "heads_6_6_1x4": ("llama3-8b", HEADS_6_6, (1, 4), 0),
    "seqpar_llama_1x2": ("llama3-8b", SEQPAR, (1, 2), 0),
    "seqpar_llama_2x2": ("llama3-8b", SEQPAR, (2, 2), 0),
    "seqpar_dbrx_1x4": ("dbrx-132b", SEQPAR, (1, 4), 0),
    "seqpar_dbrx_2x2": ("dbrx-132b", SEQPAR, (2, 2), 0),
    "maverick_1x2": ("llama4-maverick-400b-a17b", {}, (1, 2), 0),
    "qwen2_1x4": ("qwen2-72b", {}, (1, 4), 0),  # q/k/v biases, 2 KV heads
}
PREFILL = {"prefill_llama_1x2": ("llama3-8b", {}, (1, 2), 0)}
#: every layer of jamba (mamba, attention with 2 KV heads, FFN, MoE) and
#: the head through the layer gather and back
GATHER = {"gather_jamba_1x4": ("jamba-v0.1-52b", {}, (1, 4), 0),
          "gather_jamba_2x2": ("jamba-v0.1-52b", {}, (2, 2), 0)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("tp"), CASES, {
        **{n: ("prefill", c) for n, c in PREFILL.items()},
        **{n: ("gather", c) for n, c in GATHER.items()}})


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_the_single_process_step(ranks, name):
    port, _ = single(*key(CASES[name]))
    hold_against_single(ranks[name], port, CASES[name][2][0])
    if CASES[name][0] in ("dbrx-132b", "llama4-maverick-400b-a17b"):
        assert ranks[name][0]["metrics"]["moe_aux"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_the_jax_step(ranks, name):
    _, want = single(*key(CASES[name]))
    hold_against_jax(ranks[name][0], want)


@pytest.mark.parametrize("name", list(PREFILL))
def test_tp_prefill_logits_match_the_single_process_forward(ranks, name):
    arch, change, (_, m), _ = PREFILL[name]
    _, cfg = cfgs(arch, change)
    jparams, tokens, front = inputs(*key(PREFILL[name]))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu", torch.float32)
    feed = {k: v for k, v in batch_of(tokens, front).items()
            if k != "labels"}
    with torch.no_grad():
        want = model.forward(params, **feed)[0].numpy()
    for r in ranks[name]:
        assert r["columns"] * m == want.shape[-1]
        np.testing.assert_allclose(r["logits"], want, **F32)


@pytest.mark.parametrize("name", list(GATHER))
def test_layer_gather_matches_gather_whole_and_reduce_to(ranks, name):
    """``sharding.gather_layer``: its forward equals the leaf gathered whole
    (``sharding.gather``) then sliced, its backward the gradient padded to
    the whole leaf and reduced to the storage placement
    (``sharding.reduce_to``: over the data axis, and over ``model`` for a
    slice or a ``PARTIAL_GRAD`` leaf), exactly: each sum has one nonzero
    term per element but over the ranks' rows."""
    for r in ranks[name]:
        assert r["forward"] == 0.0
        assert r["backward"] <= 1e-6
