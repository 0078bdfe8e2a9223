"""The port's hybrid family (jamba: attention and Mamba-2 sublayers, FFN
and MoE feed-forwards; models.transformer, convert.params_from_numpy,
train.serve_step, launch.serve) against the JAX package, on the CPU.

jamba-smoke has 8 layers in two super-blocks of 4 (attention at sublayer
2, an MoE of 4 experts top-2 at sublayers 1 and 3), d_model 64, 8 SSD heads
of 16, state 8.  The JAX side initialises it with ``init(PRNGKey(0))``; its
tree crosses over with ``convert.params_from_numpy``, which flattens each
super-block into one dict per sublayer, so both packages run the same
weights.  Tokens are made from a seed with numpy.  The port is built with
``device="cpu"``, so its attention and SSD run the plain PyTorch versions
(the CUDA kernels are held against those on the card, in
tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: f32 forward logits 1e-4; bf16 logits by argmax agreement >=
0.95 against the JAX forward run op by op (tests/test_torch_moe.py says
why); decode-step logits 2e-3 (the attention sublayer's bf16 KV cache, as
in tests/test_torch_lm.py).
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
from repro.models import transformer as jtransformer
from repro.train.serve_step import greedy_generate as jgreedy_generate
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import backend, ops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import serve as pserve
from repro_torch.models import build, moe
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import MambaCache
from repro_torch.models.model_zoo import padded_vocab
from repro_torch.models.transformer import layer_plan, num_blocks
from repro_torch.train import greedy_generate, make_decode_step, make_prefill

ARCH = "jamba-v0.1-52b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
AUX_TOL = 1e-6
#: jamba-smoke's sublayers: attention at 2 (period 4), MoE at odd ones
SMOKE_PLAN = [("mamba", "ffn"), ("mamba", "moe"), ("attn", "ffn"),
              ("mamba", "moe")] * 2


def _pair(dtype="float32"):
    """(JAX model, JAX params, port model, port params): the same weights."""
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype)
    jcfg = dataclasses.replace(jget_config(ARCH, "smoke"), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
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
# the layer plan and the config at full width
# ---------------------------------------------------------------------------
def test_layer_plan_of_the_smoke_config():
    cfg = get_config(ARCH, "smoke")
    assert layer_plan(cfg) == SMOKE_PLAN
    assert num_blocks(cfg) == 2
    assert [jtransformer._layer_is_moe(jget_config(ARCH, "smoke"), sub)
            for sub in range(4)] == [ff == "moe" for _, ff in SMOKE_PLAN[:4]]


def test_jamba_full_width():
    """The published widths, and chip_smoke.py's cut: 16 of 32 layers (two
    super-blocks), 26.00e9 parameters at the padded vocabulary."""
    cfg = get_config(ARCH)
    assert cfg.family == "hybrid" and cfg.dtype == "bfloat16"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                32, 4096, 32, 8, 128, 14336, 65536)
    assert (cfg.num_experts, cfg.experts_per_token, cfg.moe_layer_period,
            cfg.attn_layer_period, cfg.attn_layer_offset) == (16, 2, 2, 8, 4)
    assert (cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_heads,
            cfg.ssm_d_inner) == (16, 64, 128, 8192)
    assert padded_vocab(cfg) == 65536
    plan = layer_plan(cfg)
    assert [i for i, (m, _) in enumerate(plan) if m == "attn"] == [
        4, 12, 20, 28]
    assert [i for i, (_, f) in enumerate(plan) if f == "moe"] == list(
        range(1, 32, 2))
    cut = dataclasses.replace(cfg, num_layers=16)
    assert abs(cut.param_count() - 26.00e9) < 0.01e9
    assert sum(m == "mamba" for m, _ in layer_plan(cut)) == 14


@pytest.mark.parametrize("layers", [6, 9])
def test_layers_must_fill_whole_super_blocks(layers):
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), num_layers=layers)
    with pytest.raises(ValueError, match="divide attn_layer_period"):
        num_blocks(cfg)
    with pytest.raises(ValueError, match="divide attn_layer_period"):
        build(cfg, device="cpu").init(0)
    with pytest.raises(ValueError, match="divide attn_layer_period"):
        params_from_numpy({}, cfg, "cpu")


# ---------------------------------------------------------------------------
# forward (prefill) against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seq", [16, 128, 200],
                         ids=["sequential", "chunked", "ragged"])
def test_forward_matches_jax_f32(f32_pair, seq):
    """L = 16 and 200 run the sequential SSD on both sides, L = 128 the
    chunked one (ops.ssd's rule); the aux loss sums the MoE sublayers'."""
    jmodel, jparams, model, params = f32_pair
    toks = _tokens(model.cfg.vocab_size, (2, seq), seed=1)
    want, jaux = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, aux = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (2, seq, padded_vocab(model.cfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= AUX_TOL


def test_forward_matches_jax_bf16(bf16_pair):
    jmodel, jparams, model, params = bf16_pair
    toks = _tokens(model.cfg.vocab_size, (2, 32), seed=2)
    with jax.disable_jit():
        want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got = make_prefill(model)(params, tokens=torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree >= 0.95, agree


@pytest.mark.parametrize("impl", ["ref", "chunked", "auto"])
def test_ssd_impl_reaches_every_mamba_sublayer(f32_pair, impl):
    """forward(ssd_impl=...) picks the SSD of each of the six mamba
    sublayers; on CPU tensors the three give the same logits."""
    _, _, model, params = f32_pair
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 128), seed=3))
    seen = []
    orig = ops.ssd

    def spy(*args, impl="auto", **kw):
        seen.append(impl)
        return orig(*args, impl=impl, **kw)

    ops.ssd = spy
    try:
        got, _ = model.forward(params, tokens=toks, ssd_impl=impl)
    finally:
        ops.ssd = orig
    assert seen == [impl] * 6
    want, _ = model.forward(params, tokens=toks, ssd_impl="ref")
    torch.testing.assert_close(got, want, **F32_TOL)


def test_route_is_called_once_per_moe_sublayer(f32_pair):
    _, _, model, params = f32_pair
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (2, 16), seed=4))
    calls = []
    orig = moe.route

    def spy(*args, **kw):
        r = orig(*args, **kw)
        calls.append(r.topk_idx.shape)
        return r

    moe.route = spy
    try:
        model.forward(params, tokens=toks)
    finally:
        moe.route = orig
    assert calls == [(2, 16, 2)] * 4


# ---------------------------------------------------------------------------
# decode path against JAX
# ---------------------------------------------------------------------------
def test_decode_step_matches_jax(f32_pair):
    jmodel, jparams, model, params = f32_pair
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
    # one cache a sublayer: the JAX package's stacked [block, mamba sub]
    # states land on the port's mamba layers in order
    period = model.cfg.attn_layer_period
    for i, cache in enumerate(state):
        b, sub = divmod(i, period)
        if SMOKE_PLAN[i][0] == "attn":
            assert isinstance(cache, KVCache) and cache.length == S
            assert cache.k.dtype == torch.bfloat16
            continue
        assert isinstance(cache, MambaCache) and int(cache.length) == S
        j = sub - (sub > model.cfg.attn_layer_offset)
        np.testing.assert_allclose(_f32(cache.ssm),
                                   np.asarray(jstate.mamba.ssm[b, j]),
                                   **DECODE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greedy_generate_tokens_equal_jax(f32_pair, bf16_pair, dtype):
    """In bf16 against the JAX loop run op by op, as the bf16 forward."""
    jmodel, jparams, model, params = (f32_pair if dtype == "float32"
                                      else bf16_pair)
    prompt = _tokens(model.cfg.vocab_size, (2, 6), seed=6)
    with jax.disable_jit(dtype == "bfloat16"):
        want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 10,
                                max_len=17)
    got = greedy_generate(model, params, torch.from_numpy(prompt), 10,
                          max_len=17)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_matches_forward():
    """tests/test_models.py:77-126 on the port: token-by-token decode
    agrees with the full forward pass (bf16), at capacity factor E so that
    the forward drops nothing; at most one position may differ, through a
    bf16 router near-tie."""
    cfg = get_config(ARCH, "smoke")
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
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
    assert agree > 0.9, f"decode/forward argmax agreement {agree}"
    pos_diff = np.abs(dec - full).max(axis=(0, 2))
    assert (pos_diff > 0.3).sum() <= 1, pos_diff


def test_decode_never_launches_a_kernel_and_mamba_state_is_o1(f32_pair):
    """The decode path has no kernel (nor has the JAX package's); the six
    mamba sublayers' states do not grow with the context, the two
    attention sublayers' caches do."""
    _, _, model, params = f32_pair
    before = backend.launch_counts()
    state = model.init_decode(params, 1, 4)
    state, _ = model.decode_step(params, state,
                                 torch.zeros((1, 1), dtype=torch.int32))
    assert backend.launch_counts() == before

    def size(state, kind):
        return sum(t.numel() for c in state if isinstance(c, kind)
                   for t in c if isinstance(t, torch.Tensor))

    small = model.init_decode(params, 1, 64)
    big = model.init_decode(params, 1, 4096)
    assert size(small, MambaCache) == size(big, MambaCache)
    assert size(big, KVCache) == 64 * size(small, KVCache)


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
def test_init_matches_jax_tree_shapes_and_port_dtypes(bf16_pair):
    """The port's own init has the layout params_from_numpy makes of the
    JAX tree: the same leaves, shapes and dtypes, and each layer the dict
    its plan says."""
    _, _, model, converted = bf16_pair
    params = model.init(0)
    assert _leaves(params) == _leaves(converted)
    for layer, (mixer, ff) in zip(params["blocks"], SMOKE_PLAN):
        assert set(layer) == {"norm_mix", mixer, "norm_ffn", ff}
    assert params["blocks"][0]["mamba"]["a_log"].dtype == torch.float32
    assert params["blocks"][1]["moe"]["router"].dtype == torch.bfloat16
    assert params["blocks"][2]["norm_mix"]["scale"].dtype == torch.float32


def _distinct_tree():
    """The JAX package's tree with every leaf redrawn, so that each slice
    of each stacked leaf has values of its own."""
    jmodel = jbuild(jget_config(ARCH, "smoke"))
    tree = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(10)
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)


def test_params_from_numpy_maps_each_sublayer_by_value():
    """Super-block b's sublayer sub becomes layer 4b + sub: attn/* [b],
    mamba/* [b, j] for the j-th mamba sublayer, ffn/* and moe/* [b, j] for
    the j-th of their kind, norm_mix/* and norm_ffn/* [b, sub]."""
    tree = _distinct_tree()
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype="float32")
    params = params_from_numpy(tree, cfg, "cpu")
    jb = tree["blocks"]
    period = cfg.attn_layer_period
    for b in range(num_blocks(cfg)):
        mamba_j = dense_j = moe_j = 0
        for sub in range(period):
            layer = params["blocks"][b * period + sub]
            mixer, ff = SMOKE_PLAN[sub]
            for name in ("norm_mix", "norm_ffn"):
                np.testing.assert_array_equal(layer[name]["scale"].numpy(),
                                              jb[name]["scale"][b, sub])
            if mixer == "attn":
                for k in ("wq", "wk", "wv", "wo"):
                    np.testing.assert_array_equal(layer["attn"][k].numpy(),
                                                  jb["attn"][k][b])
            else:
                for k in ("w_xz", "a_log", "conv_bc_w", "out_proj"):
                    np.testing.assert_array_equal(
                        layer["mamba"][k].numpy(), jb["mamba"][k][b, mamba_j])
                np.testing.assert_array_equal(
                    layer["mamba"]["norm"]["scale"].numpy(),
                    jb["mamba"]["norm"]["scale"][b, mamba_j])
                mamba_j += 1
            if ff == "moe":
                for k in ("router", "w_gate", "w_up", "w_down"):
                    np.testing.assert_array_equal(layer["moe"][k].numpy(),
                                                  jb["moe"][k][b, moe_j])
                moe_j += 1
            else:
                for k in ("w_gate", "w_up", "w_down"):
                    np.testing.assert_array_equal(layer["ffn"][k].numpy(),
                                                  jb["ffn"][k][b, dense_j])
                dense_j += 1
    np.testing.assert_array_equal(params["unembed"].numpy(), tree["unembed"])


def _jax_tree():
    jmodel = jbuild(jget_config(ARCH, "smoke"))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


def test_params_from_numpy_rejects_an_unknown_leaf():
    tree = _jax_tree()
    tree["blocks"]["mamba"]["w_extra"] = tree["blocks"]["mamba"]["w_dt"]
    with pytest.raises(ValueError, match="unknown leaves.*w_extra"):
        params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")


def test_params_from_numpy_rejects_a_missing_leaf():
    tree = _jax_tree()
    del tree["blocks"]["norm_ffn"]
    with pytest.raises(ValueError, match="missing.*norm_ffn/scale"):
        params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")


@pytest.mark.parametrize("leaf", ["attn/wk", "mamba/w_bc", "moe/router",
                                  "norm_mix/scale"])
def test_params_from_numpy_rejects_a_shape_that_differs(leaf):
    """A stacked leaf one sublayer short or one column short."""
    tree = _jax_tree()
    group, name = leaf.split("/")
    arr = tree["blocks"][group][name]
    tree["blocks"][group][name] = (arr[:, :-1] if group != "attn"
                                   else arr[..., :-1])
    with pytest.raises(ValueError, match=f"{name}: shape"):
        params_from_numpy(tree, get_config(ARCH, "smoke"), "cpu")


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_cpu(capsys):
    before = backend.launch_counts()
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
    assert backend.launch_counts() == before
    assert kssd.launches.count == before["ssd_scan"]
