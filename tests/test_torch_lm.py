"""The port's dense LM serving path (repro_torch.configs, models, convert,
train.serve_step, launch.serve) against the JAX package, on the CPU.

The JAX side initialises each model with ``init(PRNGKey(0))``; its
parameter tree crosses over with ``convert.params_from_numpy``, so both
packages run the same weights.  Tokens are made from a seed with numpy.
The port is built with ``device="cpu"``, so its attention runs the plain
PyTorch versions (the CUDA kernel is held against those on the card, in
tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: f32 forward logits 1e-4 (the algorithm check: the two
frameworks sum matmuls in other orders); bf16 forward logits by argmax
agreement >= 0.95 (bf16 rounds at other places in the two frameworks);
decode-step logits 2e-3, because the KV cache is bf16 even for an f32 model:
an f32 K or V value whose last bit differs between the frameworks can round
to the neighbouring bf16 value (measured up to 7.8e-4 on qwen2-72b-smoke).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import build as jbuild
from repro.train.serve_step import greedy_generate as jgreedy_generate
from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as kflash
from repro_torch.launch import serve as pserve
from repro_torch.models import build
from repro_torch.models.model_zoo import padded_vocab
from repro_torch.train import greedy_generate, make_decode_step, make_prefill

DENSE = ["llama3-8b", "gemma-7b", "qwen1.5-4b", "qwen2-72b"]
NOT_PORTED = {"dbrx-132b": "moe", "llama4-maverick-400b-a17b": "moe",
              "jamba-v0.1-52b": "hybrid",
              "seamless-m4t-large-v2": "encdec", "internvl2-1b": "vlm"}
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


def _pair(arch, dtype="float32", cfg_change=None, jax_change=None):
    """(JAX model, JAX params, port model, port params): the same weights."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype,
                              **(cfg_change or {}))
    jcfg = dataclasses.replace(jget_config(arch, "smoke"), dtype=dtype,
                               **{**(cfg_change or {}), **(jax_change or {})})
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


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
def test_registry_lists_the_same_archs():
    assert list_archs() == jlist_archs()


@pytest.mark.parametrize("variant", ["full", "smoke"])
@pytest.mark.parametrize("arch", sorted(jlist_archs()))
def test_config_equals_jax(arch, variant):
    assert (dataclasses.asdict(get_config(arch, variant))
            == dataclasses.asdict(jget_config(arch, variant)))


def test_llama3_8b_full_width():
    cfg = get_config("llama3-8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                32, 4096, 32, 8, 128, 14336, 128256)
    assert padded_vocab(cfg) == 128256
    assert abs(cfg.param_count() - 8.03e9) < 0.01e9


# ---------------------------------------------------------------------------
# forward (prefill) against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax_f32(arch):
    jmodel, jparams, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, (2, 16), seed=1)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, aux = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (2, 16, padded_vocab(model.cfg))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax_bf16(arch):
    jmodel, jparams, model, params = _pair(arch, "bfloat16")
    toks = _tokens(model.cfg.vocab_size, (2, 16), seed=2)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got = make_prefill(model)(params, tokens=torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree >= 0.95, agree


def test_full_head_dim_gqa_against_jax_pallas_kernel():
    """Two layers at llama3-8b's head_dim 128 with GQA 4:1, the JAX side
    forced through its Pallas flash kernel (interpret mode)."""
    change = dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
                  head_dim=128, d_ff=256)
    jmodel, jparams, model, params = _pair(
        "llama3-8b", cfg_change=change, jax_change={"attention_impl": "pallas"})
    assert jmodel.cfg.attention_impl == "pallas"
    toks = _tokens(model.cfg.vocab_size, (2, 64), seed=3)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, _ = model.forward(params, tokens=torch.from_numpy(toks))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_attention_impls_agree_on_cpu():
    """ref, chunked and auto give the same logits on CPU tensors (at
    S = 16, auto is ref and chunked is one chunk of 16)."""
    _, _, model, params = _pair("llama3-8b")
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (2, 16), seed=4))
    out = {}
    for impl in ("ref", "chunked", "auto"):
        m = build(dataclasses.replace(model.cfg, attention_impl=impl),
                  device="cpu")
        out[impl] = m.forward(params, tokens=toks)[0]
    torch.testing.assert_close(out["chunked"], out["ref"], **F32_TOL)
    torch.testing.assert_close(out["auto"], out["ref"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# decode path against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
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
    assert [c.length for c in state] == [S] * model.cfg.num_layers
    assert all(c.k.dtype == torch.bfloat16 for c in state)


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_generate_tokens_equal_jax(arch):
    jmodel, jparams, model, params = _pair(arch)
    prompt = _tokens(model.cfg.vocab_size, (2, 6), seed=6)
    want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 12,
                            max_len=19)
    got = greedy_generate(model, params, torch.from_numpy(prompt), 12,
                          max_len=19)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < model.cfg.vocab_size


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """tests/test_models.py:75 on the port: token-by-token decode agrees
    with the full forward pass (bf16, the configs' own dtype)."""
    cfg = get_config(arch, "smoke")
    model = build(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), seed=7))
    full, _ = model.forward(params, tokens=toks)
    state = model.init_decode(params, B, S + 1)
    outs = []
    for t in range(S):
        state, logits = model.decode_step(params, state, toks[:, t:t + 1])
        outs.append(logits)
    dec = _f32(torch.cat(outs, dim=1))
    full = _f32(full)
    agree = (dec.argmax(-1) == full.argmax(-1)).mean()
    assert agree > 0.9, f"{arch}: decode/forward argmax agreement {agree}"
    np.testing.assert_allclose(dec, full, rtol=0.15, atol=0.3)


def test_greedy_generate_is_deterministic():
    model = build(get_config("llama3-8b", "smoke"), device="cpu")
    params = model.init(3)
    prompt = torch.from_numpy(_tokens(model.cfg.vocab_size, (3, 5), seed=8))
    a = greedy_generate(model, params, prompt, 6, max_len=12)
    b = greedy_generate(model, params, prompt, 6, max_len=12)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# init, conversion and build
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_jax_tree_shapes_and_port_dtypes(arch):
    """The port's own init has the layout params_from_numpy makes of the
    JAX tree: the same leaves, shapes and dtypes (matmul weights in
    cfg.dtype, norm scales f32)."""
    _, _, model, converted = _pair(arch, "bfloat16")
    params = model.init(0)

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(leaves(v, f"{prefix}{k}/"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(leaves(v, f"{prefix}{i}/"))
            return out
        return {prefix: (tuple(tree.shape), tree.dtype)}

    assert leaves(params) == leaves(converted)
    assert params["norm_out"]["scale"].dtype == torch.float32
    assert params["embed"].dtype == torch.bfloat16


def test_init_draws_truncated_normal_at_fan_in_scale():
    cfg = dataclasses.replace(get_config("llama3-8b", "smoke"), d_model=256,
                              d_ff=512, dtype="float32")
    params = build(cfg, device="cpu").init(0)
    w = params["blocks"][0]["ffn"]["w_gate"]
    std = cfg.d_model ** -0.5
    assert float(w.abs().max()) <= 2 * std
    # a standard normal cut at +-2 has std 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.02
    assert not torch.equal(params["blocks"][0]["ffn"]["w_gate"],
                           params["blocks"][1]["ffn"]["w_gate"])
    again = build(cfg, device="cpu").init(0)
    assert torch.equal(again["embed"], params["embed"])


def _jax_tree(arch="llama3-8b"):
    jmodel = jbuild(jget_config(arch, "smoke"))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


def test_params_from_numpy_rejects_an_unknown_leaf():
    tree = _jax_tree()
    tree["blocks"]["attn"]["w_extra"] = tree["blocks"]["attn"]["wq"]
    with pytest.raises(ValueError, match="unknown leaves.*w_extra"):
        params_from_numpy(tree, get_config("llama3-8b", "smoke"), "cpu")


def test_params_from_numpy_rejects_a_missing_leaf():
    tree = _jax_tree()
    del tree["unembed"]
    with pytest.raises(ValueError, match="missing.*unembed"):
        params_from_numpy(tree, get_config("llama3-8b", "smoke"), "cpu")


def test_params_from_numpy_rejects_a_shape_that_differs():
    tree = _jax_tree()
    tree["blocks"]["ffn"]["w_up"] = tree["blocks"]["ffn"]["w_up"][:, :, :-1]
    with pytest.raises(ValueError, match="w_up: shape"):
        params_from_numpy(tree, get_config("llama3-8b", "smoke"), "cpu")


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_build_raises_for_families_not_ported(arch):
    with pytest.raises(NotImplementedError,
                       match=f"{NOT_PORTED[arch]} family.*ROADMAP.md"):
        build(get_config(arch, "smoke"), device="cpu")


@pytest.mark.parametrize("arch", sorted(NOT_PORTED))
def test_params_from_numpy_raises_for_families_not_ported(arch):
    with pytest.raises(NotImplementedError):
        params_from_numpy({}, get_config(arch, "smoke"), "cpu")


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_cpu(capsys):
    before = kflash.launches.count
    assert pserve.main(["--arch", "llama3-8b", "--variant", "smoke",
                        "--batch", "2", "--prompt-len", "4", "--gen", "5",
                        "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] ")
    import json

    rec = json.loads(line[len("[serve] "):])
    assert rec["arch"] == "llama3-8b" and rec["batch"] == 2
    assert rec["device"] == "cpu" and len(rec["generated"]) == 5
    assert rec["tokens_per_s"] > 0
    assert kflash.launches.count == before
