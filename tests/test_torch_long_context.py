"""The port at prefill_32k's lengths, on the CPU: RoPE at the last positions
of a 32k row against the JAX package's, the smoke llama3-8b and mamba2-2.7b
forwards at a length that spans several chunks of the plain attention and
of the SSD, and chip_smoke.py's two prefill_32k rows (``LM_PHASES``).

The JAX side runs on the CPU; the port is built with ``device="cpu"``, so
its attention and SSD run their plain versions (the card holds the kernels
against those: chip_smoke.py's ``llama_32k`` and ``mamba_32k`` phases).
``chip_smoke.py`` is loaded by path, as tests/test_torch_train_families.py
does.

Tolerances: RoPE f32 3e-5 (tests/test_kernels.py:45-47); forward logits in
f32 1e-4 (tests/test_torch_lm.py).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_lm import _f32, _pair, _tokens
from test_torch_mamba import _pair as _mamba_pair

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models.common import apply_rope as japply_rope
from repro_torch.configs import SHAPES, get_config
from repro_torch.models.common import apply_rope
from repro_torch.models.model_zoo import padded_vocab

ROOT = Path(__file__).resolve().parents[1]
ROPE_TOL = dict(rtol=3e-5, atol=3e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
#: longer than the plain attention's query chunk (512) and the SSD's chunk
#: (128) several times over
LONG = 2048


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
LAST = np.arange(SHAPES["prefill_32k"].seq_len - 8,
                 SHAPES["prefill_32k"].seq_len, dtype=np.int32)


@pytest.mark.parametrize("positions", [LAST, np.stack([LAST, LAST - 8])],
                         ids=["S", "BS"])
def test_rope_at_the_last_positions_of_32k_matches_jax(positions):
    """llama3-8b's theta 5e5 and D 128 at positions 32,760-32,767 (as [S]
    and as [B, S]): angles up to 3.3e4 rad, each side in f32."""
    cfg = get_config("llama3-8b")
    assert (cfg.rope_theta, cfg.head_dim) == (5e5, 128)
    x = np.random.default_rng(0).standard_normal(
        (2, 4, LAST.size, cfg.head_dim), dtype=np.float32)
    want = japply_rope(jnp.asarray(x), jnp.asarray(positions),
                       cfg.rope_theta)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(positions),
                     cfg.rope_theta)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)


def test_smoke_llama_forward_at_2048_matches_jax():
    jmodel, jparams, model, params = _pair("llama3-8b")
    toks = _tokens(model.cfg.vocab_size, (1, LONG), seed=5)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, _ = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (1, LONG, padded_vocab(model.cfg))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_smoke_mamba_forward_at_2048_matches_jax():
    jmodel, jparams, model, params = _mamba_pair()
    toks = _tokens(model.cfg.vocab_size, (1, LONG), seed=6)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, _ = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (1, LONG, padded_vocab(model.cfg))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


@pytest.mark.parametrize("which, arch, launches", [
    ("llama_32k", "llama3-8b", {"flash_attention": 32, "ssd_scan": 0}),
    ("mamba_32k", "mamba2-2.7b", {"flash_attention": 0, "ssd_scan": 64})])
def test_32k_rows_are_the_published_models_at_one_row(which, arch,
                                                       launches):
    """Full width and depth (the published config, the JAX package's
    too), one row of prefill_32k's length, no generation, one kernel
    launch a layer."""
    phase = CS.LM_PHASES[which]
    cfg = CS.lm_config(which)
    assert phase.arch == arch and phase.layers is None
    assert cfg == get_config(arch)
    assert cfg.num_layers == jget_config(arch).num_layers
    assert (phase.requests, phase.tokens_each) == (
        1, SHAPES["prefill_32k"].seq_len)
    assert CS.PREFILL_32K_LEN == JSHAPES["prefill_32k"].seq_len == 32768
    assert not phase.generate
    assert CS.expected_launches(cfg) == launches
    assert list(CS.LM_PHASES)[-2:] == ["llama_32k", "mamba_32k"]
    assert {"llama_32k", "mamba_32k"} <= set(CS.only_names())


def test_32k_rows_hold_the_gates_of_their_families():
    """The logits' limits are the 4 x 2048 rows' of the same model, and
    every earlier row keeps 4 requests of 2048 positions."""
    rows = CS.LM_PHASES
    assert rows["llama_32k"].rel_l2_limit == rows["llama"].rel_l2_limit
    assert rows["mamba_32k"].rel_l2_limit == rows["mamba"].rel_l2_limit
    for which, phase in rows.items():
        if not which.endswith("_32k"):
            assert (phase.requests, phase.tokens_each, phase.held_ends) == (
                CS.PREFILL_BATCH, CS.PREFILL_LEN, None)


@pytest.mark.parametrize("n, ends, want", [
    (32, 2, [0, 1, 30, 31]), (64, None, None), (4, 2, None), (3, 2, None),
    (5, 1, [0, 4])])
def test_held_calls_are_the_first_and_last_layers(n, ends, want):
    assert CS.held_calls(n, ends) == want


def test_32k_holds_llamas_first_two_and_last_two_layers_and_every_ssd():
    llama = CS.LM_PHASES["llama_32k"]
    mamba = CS.LM_PHASES["mamba_32k"]
    assert CS.held_calls(32, llama.held_ends) == [0, 1, 30, 31]
    assert CS.held_calls(64, mamba.held_ends) is None


def test_all_finite_reads_every_position():
    """The check in slices of rows finds a value that is not finite in the
    last slice, and in the last row of a ragged one."""
    logits = torch.zeros((2, 700, 8), dtype=torch.bfloat16)
    assert CS.all_finite(torch, logits)
    for pos in ((1, 699, 7), (0, 256, 0), (1, 0, 3)):
        bad = logits.clone()
        bad[pos] = float("nan") if pos[1] else float("inf")
        assert not CS.all_finite(torch, bad)
