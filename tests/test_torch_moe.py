"""The port's MoE family (repro_torch.models.moe, the moe family of
models.transformer and model_zoo, convert.params_from_numpy,
train.serve_step, launch.serve) against the JAX package, on the CPU.

Two smoke configs: dbrx-smoke (4 experts, top-2, LayerNorm) and
llama4-maverick-smoke (8 experts, top-1, one shared expert).  The JAX side
initialises each with ``init(PRNGKey(0))`` (a layer with ``init_moe``);
its tree crosses over with ``convert.params_from_numpy`` (a layer's by
hand), so both packages run the same weights.  Inputs are made from a seed
with numpy.  The MoE has no kernel: its expert products are batched
matmuls on either side.

Tolerances: the MoE layer's output in f32 1e-5 (both sides sum the same
products in other orders), its routing (top-k experts, positions, keep)
exactly, its aux loss 1e-6; the models' f32 logits 1e-4 and bf16 logits by
argmax agreement >= 0.95 (against the JAX forward run op by op: see
test_forward_matches_jax_bf16), decode-step logits 2e-3 (the bf16 KV
cache, as in tests/test_torch_lm.py).
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
from repro.models import moe as jmoe
from repro.train.serve_step import greedy_generate as jgreedy_generate
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import backend
from repro_torch.launch import serve as pserve
from repro_torch.models import build
from repro_torch.models import moe
from repro_torch.models.ffn import ffn_forward
from repro_torch.models.attention import KVCache
from repro_torch.models.model_zoo import padded_vocab
from repro_torch.models.transformer import layer_plan
from repro_torch.train import greedy_generate, make_decode_step, make_prefill

MOE = ["dbrx-132b", "llama4-maverick-400b-a17b"]
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
F32_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
AUX_TOL = 1e-6


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def _layer(arch, **change):
    """(JAX config, JAX layer params, port config, port layer params) of
    one f32 MoE layer: the same weights."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32",
                              **change)
    jcfg = dataclasses.replace(jget_config(arch, "smoke"), dtype="float32",
                               **change)
    jparams = jmoe.init_moe(jax.random.PRNGKey(3), jcfg)
    return jcfg, jparams, cfg, _to_torch(jax.tree.map(np.asarray, jparams))


def _jax_route(jparams, jcfg, x):
    """The JAX package's routing, step for step as moe_forward computes it
    (repro/models/moe.py:65-76): top-k experts, positions and keep."""
    B, S, _ = x.shape
    E, K = jcfg.num_experts, jcfg.experts_per_token
    C = jmoe.capacity_per_group(jcfg, S)
    logits = (x @ jparams["router"].astype(x.dtype)).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    e_flat = idx.reshape(B, S * K)
    onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
    pos = jnp.einsum("bte,bte->bt", jnp.cumsum(onehot, axis=1), onehot) - 1
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < C)


def _x(cfg, B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _pair(arch, dtype="float32"):
    """(JAX model, JAX params, port model, port params): the same weights."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype=dtype)
    jcfg = dataclasses.replace(jget_config(arch, "smoke"), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, model, params


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
# the MoE layer against JAX's
# ---------------------------------------------------------------------------
CAPACITY = {"drops": 0.5, "config": None, "no_drops": "E"}


@pytest.mark.parametrize("capacity", sorted(CAPACITY))
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax_f32(arch, capacity):
    """The layer's output, routing and aux loss, with drops (capacity
    factor 0.5), at the config's capacity factor (1.25), and with none
    (capacity factor E)."""
    cf = CAPACITY[capacity]
    E = get_config(arch, "smoke").num_experts
    change = {} if cf is None else {
        "capacity_factor": float(E) if cf == "E" else cf}
    jcfg, jparams, cfg, params = _layer(arch, **change)
    x = _x(cfg, 2, 24, seed=11)
    want, jaux = jmoe.moe_forward(jparams, jcfg, jnp.asarray(x))
    got, aux = moe.moe_forward(params, cfg, torch.from_numpy(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **LAYER_TOL)
    assert abs(float(aux) - float(jaux)) <= AUX_TOL

    idx, pos, keep = _jax_route(jparams, jcfg, jnp.asarray(x))
    r = moe.route(params, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(r.topk_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy() == 1, keep)
    if capacity == "drops":
        assert not keep.all()
    if capacity == "no_drops":
        assert keep.all()


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax_bf16(arch):
    jcfg, jparams, cfg, params = _layer(arch)
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    x = _x(cfg, 2, 24, seed=12)
    want, _ = jmoe.moe_forward(jparams, jcfg,
                               jnp.asarray(x, dtype=jnp.bfloat16))
    got, _ = moe.moe_forward(params, cfg,
                             torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("kind", ["all_equal", "pairs"])
def test_router_ties_pick_jaxs_experts(kind):
    """Exact ties among the router's probabilities: the lower expert index
    first, as jax.lax.top_k orders them."""
    jcfg, jparams, cfg, params = _layer("dbrx-132b", capacity_factor=4.0)
    router = np.asarray(jparams["router"])
    if kind == "all_equal":
        router = np.zeros_like(router)
    else:  # experts 0 and 2, 1 and 3 score alike
        router = router.copy()
        router[:, 2] = router[:, 0]
        router[:, 3] = router[:, 1]
    jparams = {**jparams, "router": jnp.asarray(router)}
    params = {**params, "router": torch.from_numpy(router)}
    x = _x(cfg, 2, 8, seed=13)
    idx, pos, keep = _jax_route(jparams, jcfg, jnp.asarray(x))
    r = moe.route(params, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(r.topk_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    if kind == "all_equal":
        assert (idx == np.arange(cfg.experts_per_token)).all()
    want, _ = jmoe.moe_forward(jparams, jcfg, jnp.asarray(x))
    got, _ = moe.moe_forward(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_f32(got), _f32(want), **LAYER_TOL)


def test_top_k_orders_ties_as_jax():
    rng = np.random.default_rng(14)
    probs = rng.integers(0, 3, (64, 16)).astype(np.float32)  # many ties
    for k in (1, 2, 4, 16):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25, 2.0, 16.0, 128.0])
def test_capacity_per_group_equals_jax(cf):
    for S in (1, 2, 3, 7, 64, 100, 2048, 32768):
        for E in (4, 8, 16, 128):
            for K in (1, 2, 4):
                change = dict(num_experts=E, experts_per_token=K,
                              capacity_factor=cf)
                cfg = dataclasses.replace(get_config("dbrx-132b"), **change)
                jcfg = dataclasses.replace(jget_config("dbrx-132b"),
                                           **change)
                assert (moe.capacity_per_group(cfg, S)
                        == jmoe.capacity_per_group(jcfg, S)), (S, E, K, cf)


def _per_token_loop(params, cfg, x):
    """Σ_k w_k · FFN_e(x) for each token alone, plus the shared expert."""
    r = moe.route(params, cfg, x)
    act = cfg.act if cfg.act != "gelu" else "swiglu"
    out = torch.zeros_like(x)
    B, S, _ = x.shape
    for b in range(B):
        for s in range(S):
            t = x[b, s]
            for k in range(cfg.experts_per_token):
                e = int(r.topk_idx[b, s, k])
                h = moe.common.gated_act(act, t @ params["w_gate"][e],
                                         t @ params["w_up"][e])
                out[b, s] += r.topk_w[b, s, k] * (h @ params["w_down"][e])
    if cfg.num_shared_experts:
        out = out + ffn_forward(params["shared"], cfg, x)
    return out


@pytest.mark.parametrize("arch", MOE)
def test_no_drop_output_equals_per_token_loop(arch):
    E = get_config(arch, "smoke").num_experts
    _, _, cfg, params = _layer(arch, capacity_factor=float(E))
    x = torch.from_numpy(_x(cfg, 2, 12, seed=15))
    got, _ = moe.moe_forward(params, cfg, x)
    torch.testing.assert_close(got, _per_token_loop(params, cfg, x),
                               **LAYER_TOL)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    _HAVE_HYPOTHESIS = True
except ImportError:
    _HAVE_HYPOTHESIS = False

if _HAVE_HYPOTHESIS:

    @settings(max_examples=25, deadline=None)
    @given(B=st.integers(1, 3), S=st.integers(1, 24),
           E=st.sampled_from([2, 4, 8]), K=st.integers(1, 3),
           cf=st.sampled_from([0.25, 0.5, 1.0, 1.25, 2.0]),
           seed=st.integers(0, 2 ** 16))
    def test_routing_slots_and_drops_property(B, S, E, K, cf, seed):
        """Each (row, expert, slot) holds at most one kept assignment; the
        drops are exactly the assignments at pos >= C; at capacity factor
        E the layer equals the per-token loop."""
        K = min(K, E)
        cfg = dataclasses.replace(
            get_config("dbrx-132b", "smoke"), dtype="float32", d_model=16,
            moe_d_ff=24, num_experts=E, experts_per_token=K,
            capacity_factor=cf)
        g = torch.Generator().manual_seed(seed)
        params = moe.init_moe(g, cfg, torch.float32)
        x = torch.randn((B, S, cfg.d_model), generator=g)
        C = moe.capacity_per_group(cfg, S)
        r = moe.route(params, cfg, x)
        e_flat = r.topk_idx.reshape(B, S * K)
        kept = r.keep == 1
        assert torch.equal(kept, r.pos < C)
        slots = set()
        for b in range(B):
            for t in range(S * K):
                if kept[b, t]:
                    slot = (b, int(e_flat[b, t]), int(r.pos[b, t]))
                    assert slot not in slots
                    slots.add(slot)
        # positions count each row's assignments to an expert from 0
        for b in range(B):
            for e in range(E):
                mine = r.pos[b][e_flat[b] == e]
                assert torch.equal(mine, torch.arange(len(mine)))
        wide = dataclasses.replace(cfg, capacity_factor=float(E))
        got, _ = moe.moe_forward(params, wide, x)
        torch.testing.assert_close(got, _per_token_loop(params, wide, x),
                                   **LAYER_TOL)


# ---------------------------------------------------------------------------
# the models against JAX
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax_f32(arch):
    jmodel, jparams, model, params = _pair(arch)
    toks = _tokens(model.cfg.vocab_size, (2, 32), seed=1)
    want, jaux = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got, aux = model.forward(params, tokens=torch.from_numpy(toks))
    assert got.shape == (2, 32, padded_vocab(model.cfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= AUX_TOL


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax_bf16(arch):
    """Against the JAX forward evaluated op by op (``jax.disable_jit``),
    the order in which the port rounds: compiled, XLA fuses elementwise
    chains and rounds to bf16 at other places, enough to flip routing
    near-ties (tools/moe_spread.py --package jax measures the JAX
    package's two evaluations apart)."""
    jmodel, jparams, model, params = _pair(arch, "bfloat16")
    toks = _tokens(model.cfg.vocab_size, (2, 32), seed=2)
    with jax.disable_jit():
        want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks))
    got = make_prefill(model)(params, tokens=torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    agree = (_f32(got).argmax(-1) == _f32(want).argmax(-1)).mean()
    assert agree >= 0.95, agree


@pytest.mark.parametrize("arch", MOE)
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
    assert all(isinstance(c, KVCache) and c.length == S for c in state)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_greedy_generate_tokens_equal_jax(arch, dtype):
    """In bf16 against the JAX loop run op by op, as the bf16 forward."""
    jmodel, jparams, model, params = _pair(arch, dtype)
    prompt = _tokens(model.cfg.vocab_size, (2, 6), seed=6)
    with jax.disable_jit(dtype == "bfloat16"):
        want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 10,
                                max_len=17)
    got = greedy_generate(model, params, torch.from_numpy(prompt), 10,
                          max_len=17)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_forward(arch):
    """tests/test_models.py:77-126 on the port: token-by-token decode
    agrees with the full forward pass (bf16), at capacity factor E so that
    the forward drops nothing; at most one position may differ, through a
    bf16 router near-tie."""
    cfg = get_config(arch, "smoke")
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
    assert agree > 0.9, f"{arch}: decode/forward argmax agreement {agree}"
    pos_diff = np.abs(dec - full).max(axis=(0, 2))
    assert (pos_diff > 0.3).sum() <= 1, pos_diff


def test_aux_loss_and_routing():
    """tests/test_models.py:129-137 on the port."""
    cfg = get_config("dbrx-132b", "smoke")
    model = build(cfg, device="cpu")
    params = model.init(0)
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 16), seed=8))
    _, aux = model.forward(params, tokens=toks)
    assert float(aux) > 0.0
    assert float(aux) < 10 * cfg.router_aux_weight * cfg.num_experts


def test_capacity_drops_are_bounded():
    """tests/test_models.py:140-145 on the port."""
    cfg = get_config("dbrx-132b", "smoke")
    c = moe.capacity_per_group(cfg, group_len=64)
    assert c >= 64 * cfg.experts_per_token // cfg.num_experts


@pytest.mark.parametrize("arch", MOE)
def test_served_decode_drops_nothing(arch):
    """At S = 1 every row has C >= 1 and its top-k experts are distinct, so
    greedy decoding at the config's own capacity factor keeps every
    assignment."""
    cfg = dataclasses.replace(get_config(arch, "smoke"), dtype="float32")
    params = build(cfg, device="cpu").init(0)["blocks"][0]["moe"]
    x = torch.from_numpy(_x(cfg, 4, 1, seed=9))
    assert moe.capacity_per_group(cfg, 1) == 1
    assert bool((moe.route(params, cfg, x).keep == 1).all())


def test_greedy_generate_is_deterministic():
    model = build(get_config("dbrx-132b", "smoke"), device="cpu")
    params = model.init(3)
    prompt = torch.from_numpy(_tokens(model.cfg.vocab_size, (3, 5), seed=10))
    a = greedy_generate(model, params, prompt, 6, max_len=12)
    b = greedy_generate(model, params, prompt, 6, max_len=12)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# configs, init and conversion
# ---------------------------------------------------------------------------
# arch -> (layers, d_model, heads, kv heads, experts, top-k, shared,
# moe_d_ff, vocab, padded vocab); the parameter counts of chip_smoke.py's
# depth cuts at the padded vocabulary
FULL = {
    "dbrx-132b": ((40, 6144, 48, 8, 16, 4, 0, 10752, 100352, 100352),
                  8, 27.31e9),
    "llama4-maverick-400b-a17b": (
        (48, 5120, 40, 8, 128, 1, 1, 8192, 202048, 202240), 1, 18.37e9),
}


@pytest.mark.parametrize("arch", MOE)
def test_full_width(arch):
    cfg = get_config(arch)
    widths, depth, params = FULL[arch]
    assert cfg.family == "moe" and cfg.dtype == "bfloat16"
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.num_experts, cfg.experts_per_token, cfg.num_shared_experts,
            cfg.moe_d_ff, cfg.vocab_size, padded_vocab(cfg)) == widths
    assert cfg.head_dim == 128 and cfg.capacity_factor == 1.25
    cut = dataclasses.replace(cfg, num_layers=depth,
                              vocab_size=padded_vocab(cfg))
    assert abs(cut.param_count() - params) < 0.01e9
    assert layer_plan(cut) == [("attn", "moe")] * depth


@pytest.mark.parametrize("arch", MOE)
def test_init_matches_jax_tree_shapes_and_port_dtypes(arch):
    """The port's own init has the layout params_from_numpy makes of the
    JAX tree: the same leaves, shapes and dtypes (the router and the
    experts in cfg.dtype, norms f32)."""
    _, _, model, converted = _pair(arch, "bfloat16")
    params = model.init(0)
    assert _leaves(params) == _leaves(converted)
    layer = params["blocks"][0]
    cfg = model.cfg
    assert set(layer) == {"norm_attn", "attn", "norm_ffn", "moe"}
    assert layer["moe"]["router"].dtype == torch.bfloat16
    assert layer["moe"]["w_down"].shape == (cfg.num_experts, cfg.moe_d_ff,
                                            cfg.d_model)
    assert ("shared" in layer["moe"]) == bool(cfg.num_shared_experts)
    assert layer["norm_ffn"]["scale"].dtype == torch.float32


def test_init_draws_each_expert_at_fan_in_scale():
    cfg = dataclasses.replace(get_config("dbrx-132b", "smoke"), d_model=256,
                              d_ff=512, dtype="float32")
    w = build(cfg, device="cpu").init(0)["blocks"][0]["moe"]["w_gate"]
    std = cfg.d_model ** -0.5
    assert float(w.abs().max()) <= 2 * std
    for e in range(cfg.num_experts):  # a standard normal cut at +-2
        assert abs(float(w[e].std()) / std - 0.8796) < 0.02
    assert not torch.equal(w[0], w[1])


def _jax_tree(arch="dbrx-132b"):
    jmodel = jbuild(jget_config(arch, "smoke"))
    return jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))


def test_params_from_numpy_maps_the_moe_leaves_by_value():
    arch = "llama4-maverick-400b-a17b"
    tree = _jax_tree(arch)
    params = params_from_numpy(tree, get_config(arch, "smoke"), "cpu")
    jm = tree["blocks"]["moe"]
    for i, layer in enumerate(params["blocks"]):
        for name in ("router", "w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                _f32(layer["moe"][name]),
                jm[name][i].astype(np.float32).astype(
                    jnp.bfloat16).astype(np.float32))
        np.testing.assert_array_equal(
            _f32(layer["moe"]["shared"]["w_up"]),
            jm["shared"]["w_up"][i].astype(jnp.bfloat16).astype(np.float32))


def test_params_from_numpy_rejects_an_unknown_leaf():
    tree = _jax_tree()
    tree["blocks"]["moe"]["w_extra"] = tree["blocks"]["moe"]["router"]
    with pytest.raises(ValueError, match="unknown leaves.*w_extra"):
        params_from_numpy(tree, get_config("dbrx-132b", "smoke"), "cpu")


def test_params_from_numpy_rejects_a_missing_leaf():
    arch = "llama4-maverick-400b-a17b"
    tree = _jax_tree(arch)
    del tree["blocks"]["moe"]["shared"]["w_down"]
    with pytest.raises(ValueError, match="missing.*shared/w_down"):
        params_from_numpy(tree, get_config(arch, "smoke"), "cpu")


def test_params_from_numpy_rejects_a_shape_that_differs():
    tree = _jax_tree()
    tree["blocks"]["moe"]["w_down"] = tree["blocks"]["moe"]["w_down"][:, :-1]
    with pytest.raises(ValueError, match="w_down: shape"):
        params_from_numpy(tree, get_config("dbrx-132b", "smoke"), "cpu")


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------
def test_serve_cli_on_cpu(capsys):
    before = backend.launch_counts()
    assert pserve.main(["--arch", "dbrx-132b", "--variant", "smoke",
                        "--batch", "2", "--prompt-len", "4", "--gen", "5",
                        "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve] ")]
    assert len(lines) == 1
    rec = json.loads(lines[0][len("[serve] "):])
    assert rec["arch"] == "dbrx-132b" and rec["batch"] == 2
    assert rec["device"] == "cpu" and len(rec["generated"]) == 5
    assert backend.launch_counts() == before
