"""``launch/train.py``'s tensor-parallel mesh step on gloo, several ranks on
the CPU: the ssm, hybrid, enc-dec and VLM families.

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

The cases: mamba2-2.7b (``w_xz``'s x and z halves: at 2 ranks or more a
rank's storage holds only x or only z columns, and it computes its
heads' x and z), jamba-v0.1-52b (hybrid: mamba, attention, MoE) and
seamless-m4t (enc-dec, 24 frames) at 1 x 2, 1 x 4 and 2 x 2, and
internvl2-1b (its frontend projection's columns gathered) at 1 x 2.
``tests/test_torch_tp.py`` has the dense and MoE cases.
"""

import pytest

from torch_tp_cases import (hold_against_jax, hold_against_single, key,
                            run_ranks, single)

#: name -> (arch, config change, (data, model), frontend frames)
CASES = {
    "mamba_1x2": ("mamba2-2.7b", {}, (1, 2), 0),
    "mamba_1x4": ("mamba2-2.7b", {}, (1, 4), 0),
    "mamba_2x2": ("mamba2-2.7b", {}, (2, 2), 0),
    "jamba_1x2": ("jamba-v0.1-52b", {}, (1, 2), 0),
    "jamba_1x4": ("jamba-v0.1-52b", {}, (1, 4), 0),
    "jamba_2x2": ("jamba-v0.1-52b", {}, (2, 2), 0),
    "seamless_1x2": ("seamless-m4t-large-v2", {}, (1, 2), 24),
    "seamless_1x4": ("seamless-m4t-large-v2", {}, (1, 4), 24),
    "seamless_2x2": ("seamless-m4t-large-v2", {}, (2, 2), 24),
    "internvl_1x2": ("internvl2-1b", {}, (1, 2), 8),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("tp"), CASES)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_the_single_process_step(ranks, name):
    port, _ = single(*key(CASES[name]))
    hold_against_single(ranks[name], port, CASES[name][2][0])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_the_jax_step(ranks, name):
    _, want = single(*key(CASES[name]))
    hold_against_jax(ranks[name][0], want)
