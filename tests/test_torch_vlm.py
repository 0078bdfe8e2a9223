"""The port's VLM family (internvl2-1b: models.transformer's frontend path,
convert.params_from_numpy, train.serve_step, launch.serve) against the JAX
package, on the CPU.

internvl-smoke has 2 layers, d_model 64, 4 query heads and 2 KV heads of
16 with q, k and v biases, SwiGLU, RMSNorm, RoPE, and a frontend of 8
patch embeddings of 48 features, projected by ``frontend_proj`` and put
before the token embeddings.  The JAX side initialises it with
``init(PRNGKey(0))``; the q, k, v biases and the norm scales, which JAX
initialises to 0 and 1, are then redrawn from a seed with numpy, so that
the bias paths run.  The tree crosses over with
``convert.params_from_numpy``.  Tokens and patch embeddings are made from a
seed with numpy.  The port is built with ``device="cpu"``, so its
attention runs the plain PyTorch versions (the CUDA kernel is held against
those on the card, in tests/test_torch_cuda.py and chip_smoke.py).

Generation ignores the frontend, as the JAX package's ``greedy_generate``
does: decode starts from an empty cache at position 0, and the JAX tests
skip the VLM's decode check (tests/test_models.py:100-101).  The decode
tests here run without the prefix.

Tolerances: f32 1e-4 (``F32_TOL``, tests/test_torch_lm.py's); bf16 2e-2
(``BF16_TOL``, tests/test_kernels.py:45-47), on the relative L2 distance of
the logits, against the JAX model run op by op; decode-step logits 2e-3
(the bf16 KV cache, as in tests/test_torch_lm.py).
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
from repro_torch.kernels import flash_attention as kflash
from repro_torch.launch import serve as pserve
from repro_torch.models import build
from repro_torch.models.model_zoo import _padded_cfg, padded_vocab
from repro_torch.train import greedy_generate, make_decode_step, make_prefill

ARCH = "internvl2-1b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 2e-2
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
S_TEXT = 16
#: the leaves JAX initialises to constants, redrawn here
BIAS_LEAVES = ("bq", "bk", "bv", "scale")


def _with_biases(tree, seed):
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name not in BIAS_LEAVES:
            return leaf
        noise = 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return (1.0 + noise) if name == "scale" else noise

    return jax.tree_util.tree_map_with_path(redraw, tree)


def _pair(dtype="float32", cfg_change=None, jax_change=None, seed=21):
    """(JAX model, JAX params, port model, port params): the same weights,
    biases non-zero."""
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype,
                              **(cfg_change or {}))
    jcfg = dataclasses.replace(jget_config(ARCH, "smoke"), dtype=dtype,
                               **{**(cfg_change or {}), **(jax_change or {})})
    jmodel = jbuild(jcfg)
    tree = _with_biases(jax.tree.map(np.asarray,
                                     jmodel.init(jax.random.PRNGKey(0))),
                        seed)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = build(cfg, device="cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    return jmodel, jparams, model, params


@pytest.fixture(scope="module")
def f32_pair():
    return _pair()


@pytest.fixture(scope="module")
def bf16_pair():
    return _pair("bfloat16")


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _patches(cfg, batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel_l2(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# forward (prefill) against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s_text", [S_TEXT, 1, 40])
def test_forward_with_frontend_matches_jax_f32(f32_pair, s_text):
    jmodel, jparams, model, params = f32_pair
    F = model.cfg.frontend_tokens
    toks = _tokens(model.cfg.vocab_size, (2, s_text), seed=1)
    patches = _patches(model.cfg, 2, seed=2)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                             frontend=jnp.asarray(patches))
    got, aux = model.forward(params, tokens=torch.from_numpy(toks),
                             frontend=torch.from_numpy(patches))
    # the logits cover the image prefix and the text: F + S positions
    assert got.shape == (2, F + s_text, padded_vocab(model.cfg))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_forward_without_frontend_matches_jax_f32(f32_pair):
    jmodel, jparams, model, params = f32_pair
    toks = _tokens(model.cfg.vocab_size, (2, S_TEXT), seed=3)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, _ = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (2, S_TEXT, padded_vocab(model.cfg))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_forward_matches_jax_bf16(bf16_pair):
    """bf16 logits within BF16_TOL relative L2 of the JAX model run op by
    op (compiled, XLA fuses bf16 chains and rounds elsewhere)."""
    jmodel, jparams, model, params = bf16_pair
    toks = _tokens(model.cfg.vocab_size, (2, S_TEXT), seed=4)
    patches = _patches(model.cfg, 2, seed=5)
    with jax.disable_jit():
        want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                 frontend=jnp.asarray(patches))
    got = make_prefill(model)(params, tokens=torch.from_numpy(toks),
                              frontend=torch.from_numpy(patches))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, want) < BF16_TOL


def test_prefix_is_causal_context(f32_pair):
    """The image prefix comes first under the causal mask: the text's
    logits depend on it, the prefix's own logits not on the text."""
    _, _, model, params = f32_pair
    F = model.cfg.frontend_tokens
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 8), seed=6))
    patches = torch.from_numpy(_patches(model.cfg, 1, seed=7))
    a, _ = model.forward(params, tokens=toks, frontend=patches)
    b, _ = model.forward(params, tokens=toks, frontend=patches + 1.0)
    c, _ = model.forward(params, tokens=(toks + 1) % model.cfg.vocab_size,
                         frontend=patches)
    assert float((a[:, F:] - b[:, F:]).abs().max()) > 1e-3
    torch.testing.assert_close(a[:, :F], c[:, :F], **F32_TOL)


def test_gqa_7_to_1_at_head_dim_64_against_jax_pallas_kernel():
    """internvl2-1b's attention shape (14 query heads on 2 KV heads, head_dim
    64) with its prefix, the JAX side through its Pallas flash kernel
    (interpret mode)."""
    change = dict(d_model=128, num_heads=14, num_kv_heads=2, head_dim=64,
                  d_ff=256)
    jmodel, jparams, model, params = _pair(
        cfg_change=change, jax_change={"attention_impl": "pallas"})
    assert jmodel.cfg.attention_impl == "pallas"
    toks = _tokens(model.cfg.vocab_size, (2, 24), seed=8)
    patches = _patches(model.cfg, 2, seed=9)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                             frontend=jnp.asarray(patches))
    got, _ = model.forward(params, tokens=torch.from_numpy(toks),
                           frontend=torch.from_numpy(patches))
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


# ---------------------------------------------------------------------------
# decode path against JAX (no prefix, as in the JAX package)
# ---------------------------------------------------------------------------
def test_decode_step_matches_jax(f32_pair):
    jmodel, jparams, model, params = f32_pair
    B, S = 2, 8
    toks = _tokens(model.cfg.vocab_size, (B, S), seed=10)
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


@pytest.mark.parametrize("seed", [11, 12])
def test_greedy_generate_tokens_equal_jax_and_ignore_the_frontend(f32_pair,
                                                                 seed):
    """Tokens equal in f32 (in bf16 a near-tie of two logits, rounded
    elsewhere by the two frameworks, may pick another token)."""
    jmodel, jparams, model, params = f32_pair
    prompt = _tokens(model.cfg.vocab_size, (2, 6), seed=seed)
    patches = _patches(model.cfg, 2, seed=seed)
    want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 12,
                            max_len=19, frontend=jnp.asarray(patches))
    got = greedy_generate(model, params, torch.from_numpy(prompt), 12,
                          max_len=19, frontend=torch.from_numpy(patches))
    plain = greedy_generate(model, params, torch.from_numpy(prompt), 12,
                            max_len=19)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, plain)


def test_decode_matches_forward_without_prefix():
    """tests/test_models.py:75 on the port, without the prefix (the JAX
    test skips the VLM): token-by-token decode agrees with the full
    forward of the text alone (bf16)."""
    cfg = get_config(ARCH, "smoke")
    model = build(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), seed=12))
    full, _ = model.forward(params, tokens=toks)
    state = model.init_decode(params, B, S + 1)
    outs = []
    for t in range(S):
        state, logits = model.decode_step(params, state, toks[:, t:t + 1])
        outs.append(logits)
    dec = _f32(torch.cat(outs, dim=1))
    full = _f32(full)
    assert (dec.argmax(-1) == full.argmax(-1)).mean() > 0.9
    np.testing.assert_allclose(dec, full, rtol=0.15, atol=0.3)


# ---------------------------------------------------------------------------
# init, conversion, config
# ---------------------------------------------------------------------------
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


def test_init_matches_converted_tree(bf16_pair):
    jmodel, jparams, model, converted = bf16_pair
    params = model.init(0)
    assert _leaves(params) == _leaves(converted)
    assert params["frontend_proj"].shape == (48, 64)
    assert params["frontend_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _f32(converted["frontend_proj"]),
        _f32(jnp.asarray(jparams["frontend_proj"]).astype(jnp.bfloat16)))


@pytest.mark.parametrize("breakage", ["missing", "shape"])
def test_params_from_numpy_needs_the_frontend_projection(breakage):
    cfg = get_config(ARCH, "smoke")
    tree = jax.tree.map(np.asarray, jbuild(jget_config(ARCH, "smoke")).init(
        jax.random.PRNGKey(0)))
    if breakage == "missing":
        del tree["frontend_proj"]
        match = "missing.*frontend_proj"
    else:
        tree["frontend_proj"] = tree["frontend_proj"][:-1]
        match = "frontend_proj: shape"
    with pytest.raises(ValueError, match=match):
        params_from_numpy(tree, cfg, "cpu")


def test_internvl_full_width():
    """The published widths of the LM backbone and the vocabulary's
    padding (151655 -> 151808); chip_smoke.py runs it at full depth."""
    cfg = get_config(ARCH)
    assert cfg.family == "vlm" and cfg.dtype == "bfloat16"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.frontend_tokens,
            cfg.frontend_dim) == (24, 896, 14, 2, 64, 4864, 256, 1024)
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert padded_vocab(cfg) == 151808
    assert abs(_padded_cfg(cfg).param_count() - 0.494e9) < 0.001e9


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_cpu(capsys):
    before = kflash.launches.count
    assert pserve.main(["--arch", ARCH, "--variant", "smoke", "--batch", "2",
                        "--prompt-len", "4", "--gen", "5",
                        "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[serve] ")
    rec = json.loads(line[len("[serve] "):])
    assert rec["arch"] == ARCH and rec["batch"] == 2
    assert rec["device"] == "cpu" and len(rec["generated"]) == 5
    assert kflash.launches.count == before
