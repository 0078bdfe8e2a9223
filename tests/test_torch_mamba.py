"""The port's Mamba-2 serving path (repro_torch.models.mamba2, the ssm
family of models.transformer and model_zoo, convert.params_from_numpy,
train.serve_step, launch.serve) against the JAX package, on the CPU.

The JAX side initialises mamba2-smoke (3 layers, d_model 64, 8 SSD heads of
16, state 16) with ``init(PRNGKey(0))``; its parameter tree crosses over with
``convert.params_from_numpy``, so both packages run the same weights.
Tokens are made from a seed with numpy.  The port is built with
``device="cpu"``, so its SSD runs the plain PyTorch versions, chunked or
sequential exactly where the JAX package's does off the TPU (the CUDA kernel
is held against those on the card, in tests/test_torch_cuda.py and
chip_smoke.py).

Tolerances: f32 forward logits 1e-4 (the algorithm check: the two
frameworks sum matmuls and the SSD in other orders); bf16 forward logits by
argmax agreement >= 0.95 (bf16 rounds at other places in the two
frameworks); f32 decode-step logits 1e-4 as well: the decode state is f32
(conv tails and SSM state), so unlike the dense family's bf16 KV cache
nothing rounds a last-bit difference to a coarser type.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build as jbuild
from repro.train.serve_step import greedy_generate as jgreedy_generate
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve as pserve
from repro_torch.models import build
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.model_zoo import padded_vocab
from repro_torch.train import greedy_generate, make_decode_step, make_prefill

ARCH = "mamba2-2.7b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
F32_LEAVES = ("a_log", "d_skip", "dt_bias")


def _pair(dtype="float32"):
    """(JAX model, JAX params, port model, port params): the same weights."""
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype)
    jcfg = dataclasses.replace(jget_config(ARCH, "smoke"), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model, params


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix: (tuple(tree.shape), tree.dtype)}


# ---------------------------------------------------------------------------
# the config at full width
# ---------------------------------------------------------------------------
def test_mamba2_2p7b_full_width():
    cfg = get_config(ARCH)
    assert cfg.family == "ssm"
    assert (cfg.num_layers, cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
            cfg.ssm_heads, cfg.vocab_size) == (64, 2560, 128, 64, 80, 50280)
    assert cfg.ssm_d_inner == 5120 and cfg.tie_embeddings
    assert padded_vocab(cfg) == 50432
    assert abs(cfg.param_count() - 2.70e9) < 0.01e9


# ---------------------------------------------------------------------------
# forward (prefill) against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [16, 128, 200],
                         ids=["sequential", "chunked", "ragged"])
def test_forward_matches_jax_f32(seq):
    """L = 16 and 200 run the sequential SSD on both sides, L = 128 the
    chunked one (ops.ssd's rule)."""
    jmodel, jparams, model, params = _pair()
    toks = _tokens(model.cfg.vocab_size, (2, seq), seed=1)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, aux = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (2, seq, padded_vocab(model.cfg))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_forward_matches_jax_bf16():
    jmodel, jparams, model, params = _pair("bfloat16")
    toks = _tokens(model.cfg.vocab_size, (2, 32), seed=2)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got = make_prefill(model)(params, tokens=torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree >= 0.95, agree


@pytest.mark.parametrize("impl", ["ref", "chunked", "auto"])
def test_ssd_impl_is_threaded_down_from_forward(impl):
    """forward(ssd_impl=...) picks the SSD's implementation in every layer;
    on CPU tensors the three agree (at L = 128 auto is chunked)."""
    _, _, model, params = _pair()
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (2, 128), seed=3))
    want, _ = model.forward(params, tokens=toks, ssd_impl="ref")
    got = make_prefill(model)(params, tokens=toks, ssd_impl=impl)
    torch.testing.assert_close(got, want, **F32_TOL)


def test_ssd_impl_pallas_on_cpu_raises():
    _, _, model, params = _pair()
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 8), seed=4))
    before = kssd.launches.count
    with pytest.raises(ValueError, match="CUDA device"):
        model.forward(params, tokens=toks, ssd_impl="pallas")
    assert kssd.launches.count == before


# ---------------------------------------------------------------------------
# decode path against JAX
# ---------------------------------------------------------------------------
def test_decode_step_matches_jax():
    jmodel, jparams, model, params = _pair()
    B, S = 2, 8
    toks = _tokens(model.cfg.vocab_size, (B, S), seed=5)
    jstate = jmodel.init_decode(jparams, B, S + 1)
    state = model.init_decode(params, B, S + 1)
    step = make_decode_step(model)
    for t in range(S):
        jstate, want = jmodel.decode_step(jparams, jstate,
                                          jnp.asarray(toks[:, t:t + 1]))
        state, got = step(params, state, torch.from_numpy(toks[:, t:t + 1]))
        assert got.shape == (B, 1, padded_vocab(model.cfg))
        np.testing.assert_allclose(_f32(got), _f32(want), **DECODE_TOL)
    assert len(state) == model.cfg.num_layers
    for i, cache in enumerate(state):
        assert isinstance(cache, MambaCache) and int(cache.length) == S
        assert cache.ssm.dtype == torch.float32
        assert cache.conv_x.dtype == cache.conv_bc.dtype == torch.float32
        np.testing.assert_allclose(_f32(cache.ssm),
                                   np.asarray(jstate.mamba.ssm[i]), **F32_TOL)
        np.testing.assert_allclose(_f32(cache.conv_x),
                                   np.asarray(jstate.mamba.conv_x[i]),
                                   **F32_TOL)


def test_greedy_generate_tokens_equal_jax():
    jmodel, jparams, model, params = _pair()
    prompt = _tokens(model.cfg.vocab_size, (2, 6), seed=6)
    want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 12,
                            max_len=19)
    got = greedy_generate(model, params, torch.from_numpy(prompt), 12,
                          max_len=19)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < model.cfg.vocab_size


def test_greedy_generate_bf16_tokens_equal_jax():
    jmodel, jparams, model, params = _pair("bfloat16")
    prompt = _tokens(model.cfg.vocab_size, (2, 5), seed=7)
    want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 8,
                            max_len=14)
    got = greedy_generate(model, params, torch.from_numpy(prompt), 8,
                          max_len=14)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_forward():
    """tests/test_models.py:115-126 on the port: token-by-token decode
    agrees with the full forward pass (bf16, the config's own dtype)."""
    cfg = get_config(ARCH, "smoke")
    model = build(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), seed=8))
    full, _ = model.forward(params, tokens=toks)
    state = model.init_decode(params, B, S + 1)
    outs = []
    for t in range(S):
        state, logits = model.decode_step(params, state, toks[:, t:t + 1])
        outs.append(logits)
    dec = _f32(torch.cat(outs, dim=1))
    full = _f32(full)
    agree = (dec.argmax(-1) == full.argmax(-1)).mean()
    assert agree > 0.9, f"decode/forward argmax agreement {agree}"
    np.testing.assert_allclose(dec, full, rtol=0.15, atol=0.3)


def test_decode_never_launches_the_kernel_and_updates_the_state_in_place():
    _, _, model, params = _pair()
    state = model.init_decode(params, 1, 4)
    ssm = [c.ssm for c in state]
    before = kssd.launches.count
    state, _ = model.decode_step(params, state,
                                 torch.zeros((1, 1), dtype=torch.int32))
    assert kssd.launches.count == before
    assert all(c.ssm is s for c, s in zip(state, ssm))
    assert all(float(s.abs().max()) > 0 for s in ssm)


def test_state_is_context_size_independent():
    """tests/test_models.py:160 on the port: the decode state is O(1) in the
    context (init_decode ignores max_len)."""
    model = build(get_config(ARCH, "smoke"), device="cpu")
    params = model.init(0)

    def size(state):
        return sum(t.numel() for c in state for t in c)

    assert size(model.init_decode(params, 1, 64)) == size(
        model.init_decode(params, 1, 65536))


def test_greedy_generate_is_deterministic():
    model = build(get_config(ARCH, "smoke"), device="cpu")
    params = model.init(3)
    prompt = torch.from_numpy(_tokens(model.cfg.vocab_size, (3, 5), seed=9))
    a = greedy_generate(model, params, prompt, 6, max_len=12)
    b = greedy_generate(model, params, prompt, 6, max_len=12)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# init and conversion
# ---------------------------------------------------------------------------
def test_init_matches_jax_tree_shapes_and_port_dtypes():
    """The port's own init has the layout params_from_numpy makes of the
    JAX tree: the same leaves and shapes, and the port's dtypes (matmul and
    conv weights in cfg.dtype; a_log, d_skip, dt_bias and norms f32)."""
    _, jparams, model, converted = _pair("bfloat16")
    params = model.init(0)
    assert _leaves(params) == _leaves(converted)
    layers = model.cfg.num_layers
    for path, arr in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        name = "/".join(k.key for k in path)
        shape = arr.shape[1:] if name.startswith("blocks/") else arr.shape
        if name.startswith("blocks/"):
            assert arr.shape[0] == layers
            port = _leaves(params)[f"blocks/0/{name[len('blocks/'):]}/"]
        else:
            port = _leaves(params)[f"{name}/"]
        if name == "embed":  # the port pads the vocabulary as build does
            shape = (padded_vocab(model.cfg),) + shape[1:]
        assert port[0] == tuple(shape), name
        parts = name.split("/")
        keep_f32 = parts[-1] in F32_LEAVES or (
            len(parts) > 1 and parts[-2].startswith("norm"))
        assert port[1] == (torch.float32 if keep_f32 else torch.bfloat16), name


def test_init_draws_the_jax_packages_distributions():
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype="float32")
    mamba = build(cfg, device="cpu").init(0)["blocks"][0]["mamba"]
    h = cfg.ssm_heads
    torch.testing.assert_close(mamba["a_log"],
                               torch.log(torch.arange(1.0, h + 1)))
    assert torch.equal(mamba["d_skip"], torch.ones(h))
    dt0 = torch.nn.functional.softplus(mamba["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1 * 1.001
    w = cfg.ssm_conv_width
    assert abs(float(mamba["conv_x_w"].std()) - w ** -0.5) < 0.1
    assert float(mamba["conv_x_b"].abs().max()) == 0.0


def _jax_tree():
    jmodel = jbuild(jget_config(ARCH, "smoke"))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


def test_params_from_numpy_keeps_the_ssm_leaves_f32():
    tree = _jax_tree()
    params = params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")
    mamba = params["blocks"][1]["mamba"]
    for name in F32_LEAVES:
        assert mamba[name].dtype == torch.float32
        np.testing.assert_array_equal(mamba[name].numpy(),
                                      tree["blocks"]["mamba"][name][1])
    assert mamba["norm"]["scale"].dtype == torch.float32
    assert params["blocks"][0]["norm_mix"]["scale"].dtype == torch.float32
    assert mamba["w_xz"].dtype == mamba["conv_x_w"].dtype == torch.bfloat16


def test_params_from_numpy_rejects_an_unknown_leaf():
    tree = _jax_tree()
    tree["blocks"]["mamba"]["w_extra"] = tree["blocks"]["mamba"]["w_dt"]
    with pytest.raises(ValueError, match="unknown leaves.*w_extra"):
        params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")


def test_params_from_numpy_rejects_a_missing_leaf():
    tree = _jax_tree()
    del tree["blocks"]["mamba"]["dt_bias"]
    with pytest.raises(ValueError, match="missing.*dt_bias"):
        params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")


def test_params_from_numpy_rejects_a_shape_that_differs():
    tree = _jax_tree()
    tree["blocks"]["mamba"]["conv_bc_w"] = (
        tree["blocks"]["mamba"]["conv_bc_w"][:, :, :-1])
    with pytest.raises(ValueError, match="conv_bc_w: shape"):
        params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_cpu(capsys):
    before = kssd.launches.count
    assert pserve.main(["--arch", ARCH, "--variant", "smoke", "--batch", "2",
                        "--prompt-len", "4", "--gen", "5",
                        "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve] ")]
    assert len(lines) == 1
    rec = json.loads(lines[0][len("[serve] "):])
    assert rec["arch"] == ARCH and rec["batch"] == 2
    assert rec["device"] == "cpu" and len(rec["generated"]) == 5
    assert rec["tokens_per_s"] > 0
    assert kssd.launches.count == before
