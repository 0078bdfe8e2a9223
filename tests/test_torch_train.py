"""The port's training path (models.common.cross_entropy, train.optimizer,
train.train_step, convert.params_to_numpy) against the JAX package, on the
CPU.

Inputs are made from numpy seeds and handed to both packages; the JAX
model's parameters cross over with ``convert.params_from_numpy`` as f32
masters, and come back with ``convert.params_to_numpy``.  The port runs
its plain PyTorch versions on CPU tensors (attention ``"ref"`` or
``"chunked"``, the SSD's chunked version), which autograd differentiates;
the JAX side differentiates with ``jax.value_and_grad``.

Tolerances, each from the arithmetic: f32 loss and metrics 1e-5 relative
(the two frameworks sum in other orders); f32 parameters after an AdamW
step within 2e-6 + 1e-5 relative, the update being lr times a ratio of
moments, each agreeing to a few f32 ulps (after a model's first step, 999
in 1000 parameters: the first step's ratio g / (|g| + eps) turns on the
last bits of a gradient within a few eps of 0); int8 moments to within one
quantisation step of their row's scale (and so a few parameters, one in a
thousand at most, to within 3 lr / 127).  bf16 steps compare with the JAX
step run op by op (``jax.disable_jit``): the loss within 2e-2 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.train import make_train_step as jmake_train_step
from repro.train import optimizer as jopt
from repro_torch.configs import get_config
from repro_torch.convert import (params_from_numpy, params_to_numpy,
                                 reference_shapes)
from repro_torch.models import build
from repro_torch.models import common
from repro_torch.train import make_eval_step, make_loss_fn, make_train_step
from repro_torch.train import optimizer as opt

F32 = dict(rtol=1e-5, atol=1e-5)
PARAMS_TOL = dict(rtol=1e-5, atol=2e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 300), dtype=np.float32) * 4
    labels = rng.integers(0, 300, (3, 7), dtype=np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want, wm = jcommon.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got, gm = common.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert set(gm) == set(wm) == {"nll", "z_loss", "tokens"}
    for k in wm:
        np.testing.assert_allclose(_np(gm[k]), _np(wm[k]), **F32)


def test_cross_entropy_gradient_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 5, 64), dtype=np.float32) * 3
    labels = rng.integers(0, 64, (2, 5), dtype=np.int32)
    want = jax.grad(lambda x: jcommon.cross_entropy(
        x, jnp.asarray(labels))[0])(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    (got,) = torch.autograd.grad(
        common.cross_entropy(x, torch.from_numpy(labels))[0], x)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def _opt_tree(rng):
    """A matrix and a 3-D leaf over the int8 threshold, a small matrix and
    a vector under it."""
    shapes = {"w": (300, 256), "stack": {"e": (2, 64, 600)},
              "small": (16, 8), "scale": (256,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s, dtype=np.float32)

    return draw(shapes)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_optimizer_update_matches_jax_over_three_steps(moments):
    rng = np.random.default_rng(2)
    params_np = _opt_tree(rng)
    grads_np = [_opt_tree(rng) for _ in range(3)]
    cfg = opt.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                              decay_steps=10, moments_dtype=moments,
                              grad_clip_norm=50.0)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams, jcfg)
    params = _to_torch(params_np)
    state = opt.init(params, cfg)
    for g in grads_np:
        jparams, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, g),
                                          jstate, jparams, jcfg)
        params, state, m = opt.update(_to_torch(g), state, params, cfg)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=1e-6)
    assert int(state.step) == int(jstate.step) == 3
    for (path, p), (_, jp) in zip(_leaves_with_paths(params),
                                  _leaves_with_paths(jparams)):
        if moments == "fp32":
            np.testing.assert_allclose(_np(p), _np(jp), **PARAMS_TOL,
                                       err_msg=path)
            continue
        # an int8 moment whose f32 value lies an ulp from a rounding edge
        # can land one step (its row's scale) apart in the two packages,
        # moving that element's update by about lr / 127: a few elements
        # may differ by that much, the rest as in fp32
        diff = np.abs(_np(p) - _np(jp))
        close = diff <= PARAMS_TOL["atol"] + PARAMS_TOL["rtol"] * np.abs(
            _np(jp))
        assert close.mean() > 0.999, (path, close.mean())
        assert diff.max() <= 3 * cfg.learning_rate / 127, (path, diff.max())
    for tree, jtree in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
        for (path, m), (_, jm_) in zip(_leaves_with_paths(tree),
                                       _leaves_with_paths(jtree)):
            assert isinstance(m, opt.QTensor) == isinstance(jm_, jopt.QTensor)
            if isinstance(m, opt.QTensor):
                np.testing.assert_allclose(_np(m.scale), _np(jm_.scale),
                                           rtol=1e-5, err_msg=path)
                step = _np(jm_.scale)[..., None]
                diff = np.abs(_np(opt.dequantize(m))
                              - _np(jopt.dequantize(jm_)))
                assert np.all(diff <= 1.01 * step + 1e-12), path
            else:
                np.testing.assert_allclose(_np(m), _np(jm_), rtol=1e-5,
                                           atol=1e-8, err_msg=path)


def test_quantize_rounds_half_to_even_as_jax():
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]], np.float32)
    got = opt.quantize(torch.from_numpy(x))
    want = jopt.quantize(jnp.asarray(x))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    assert got.shape == tuple(want.shape)


@pytest.mark.parametrize("max_norm", [1.0, 1e3], ids=["clipped", "not"])
def test_global_norm_and_clip_match_jax(max_norm):
    tree = _opt_tree(np.random.default_rng(5))
    got, norm = opt.clip_by_global_norm(_to_torch(tree), max_norm)
    want, jnorm = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                           max_norm)
    np.testing.assert_allclose(_np(norm), _np(jnorm), rtol=1e-6)
    np.testing.assert_allclose(_np(opt.global_norm(_to_torch(tree))),
                               _np(jopt.global_norm(jax.tree.map(
                                   jnp.asarray, tree))), rtol=1e-6)
    for (path, a), (_, b) in zip(_leaves_with_paths(got),
                                 _leaves_with_paths(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7,
                                   err_msg=path)


def test_schedule_matches_jax():
    cfg = opt.OptimizerConfig(learning_rate=3e-3, warmup_steps=5,
                              decay_steps=40)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    for step in range(0, 50, 3):
        np.testing.assert_allclose(
            _np(opt.schedule(cfg, torch.tensor(step))),
            _np(jopt.schedule(jcfg, jnp.asarray(step))), rtol=1e-6)


# ---------------------------------------------------------------------------
# f32 masters
# ---------------------------------------------------------------------------
def test_f32_masters_hold_the_same_draws_as_the_serving_storage():
    cfg = get_config("llama3-8b", "smoke")  # bf16
    model = build(cfg, device="cpu")
    served = model.init(5)
    masters = model.init(5, param_dtype=torch.float32)
    wq, wq32 = served["blocks"][0]["attn"]["wq"], masters["blocks"][0]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq32.dtype == torch.float32
    assert torch.equal(wq32.to(torch.bfloat16), wq)
    assert served["norm_out"]["scale"].dtype == torch.float32
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16), dtype=np.int32))
    a, _ = model.forward(served, tokens=tokens)
    b, _ = model.forward(masters, tokens=tokens)
    assert torch.equal(a, b)  # every layer casts at use


# ---------------------------------------------------------------------------
# one train step against the JAX package's
# ---------------------------------------------------------------------------
def _step_pair(arch, dtype="float32", cfg_change=None, seed=0, batch=4,
               seq=32, num_micro=1, lr=1e-3, frames=None):
    """The JAX step and the port's on the same weights and batch ->
    ((jax params, jax metrics), (port params as the JAX tree, port
    metrics)).  ``frames``: a ``frontend`` [batch, frames, frontend_dim]
    in the batch (an enc-dec model's encoder input, a VLM's patch
    embeddings)."""
    change = dict(dtype=dtype, **(cfg_change or {}))
    jcfg = dataclasses.replace(jget_config(arch, "smoke"), **change)
    cfg = dataclasses.replace(get_config(arch, "smoke"), **change)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    tokens = np.random.default_rng(seed + 1).integers(
        0, cfg.vocab_size, (batch, seq), dtype=np.int32)
    opt_cfg = opt.OptimizerConfig(learning_rate=lr, warmup_steps=1)
    jopt_cfg = jopt.OptimizerConfig(**dataclasses.asdict(opt_cfg))
    jstate = jopt.init(jparams, jopt_cfg)
    jstep = jmake_train_step(jmodel, jopt_cfg, num_microbatches=num_micro)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    front = None
    if frames:
        front = np.random.default_rng(seed + 2).standard_normal(
            (batch, frames, cfg.frontend_dim or cfg.d_model), dtype=np.float32)
        jbatch["frontend"] = jnp.asarray(front)
    if dtype == "bfloat16":
        with jax.disable_jit():
            jnew, _, jm = jstep(jparams, jstate, jbatch)
    else:
        jnew, _, jm = jax.jit(jstep)(jparams, jstate, jbatch)

    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, "cpu",
                               param_dtype=torch.float32)
    state = opt.init(params, opt_cfg, reference_shapes(cfg))
    step = make_train_step(model, opt_cfg, num_microbatches=num_micro)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(tokens)}
    if front is not None:
        batch["frontend"] = torch.from_numpy(front)
    new, new_state, m = step(params, state, batch)
    assert int(new_state.step) == 1
    return (jax.tree.map(np.asarray, jnew), jm), (params_to_numpy(new, cfg), m)


def _hold_step(jax_side, port_side, params_tol=PARAMS_TOL, lr=1e-3):
    (jparams, jm), (params, m) = jax_side, port_side
    assert set(m) == set(jm) | {"grad_norm", "lr"} or set(m) == set(jm)
    for k in ("loss", "nll", "z_loss", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert jax.tree.structure(params) == jax.tree.structure(jparams)
    close = total = 0
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree.leaves(jparams)):
        diff = np.abs(a - b)
        ok = diff <= params_tol["atol"] + params_tol["rtol"] * np.abs(b)
        close, total = close + int(ok.sum()), total + ok.size
        # AdamW's first step moves a parameter by lr g / (|g| + eps): for a
        # gradient within a few eps of 0 the ratio turns on the gradient's
        # last bits, which the frameworks' sum orders set differently; no
        # first step moves a parameter by more than lr (plus its decay)
        assert diff.max() <= 2 * lr, (jax.tree_util.keystr(path), diff.max())
    assert close / total > 0.999, (close, total)


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_llama_train_step_matches_jax(remat):
    _hold_step(*_step_pair("llama3-8b", cfg_change={"remat": remat}))


def test_llama_train_step_with_dots_remat_policy_matches_jax():
    _hold_step(*_step_pair("llama3-8b", cfg_change={
        "remat": True, "remat_policy": "dots"}))


def test_llama_train_step_with_two_microbatches_matches_jax():
    _hold_step(*_step_pair("llama3-8b", num_micro=2))


def test_dbrx_train_step_with_moe_aux_matches_jax():
    jax_side, port_side = _step_pair("dbrx-132b")
    assert float(port_side[1]["moe_aux"]) > 0
    _hold_step(jax_side, port_side)


def test_mamba_train_step_through_the_chunked_ssd_matches_jax():
    _hold_step(*_step_pair("mamba2-2.7b", seq=64))


@pytest.mark.parametrize("arch,frames", [
    ("jamba-v0.1-52b", None),             # hybrid: mamba, attention, MoE
    ("llama4-maverick-400b-a17b", None),  # MoE with a shared expert
    ("gemma-7b", None),
    ("qwen1.5-4b", None),
    ("qwen2-72b", None),                  # GQA with qkv biases
    ("seamless-m4t-large-v2", 24),        # enc-dec: 24 frames encoded
    ("internvl2-1b", "prefix"),           # VLM: the patch-embedding prefix
])
def test_train_step_matches_jax_for_every_other_family(arch, frames):
    """The families no other test steps: one AdamW step against the JAX
    package's, an enc-dec and a VLM model with a frontend in the batch."""
    if frames == "prefix":
        frames = get_config(arch, "smoke").frontend_tokens
    _hold_step(*_step_pair(arch, frames=frames))


def test_bf16_llama_train_step_matches_jax_op_by_op():
    (jparams, jm), (params, m) = _step_pair("llama3-8b", dtype="bfloat16",
                                            batch=2, seq=16)
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(_np(m[k]), _np(jm[k]), rtol=2e-2,
                                   err_msg=k)


def test_vlm_loss_drops_the_frontend_prefix():
    cfg = dataclasses.replace(get_config("internvl2-1b", "smoke"),
                              dtype="float32")
    model = build(cfg, device="cpu")
    params = model.init(0, param_dtype=torch.float32)
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 12),
                                           dtype=np.int32))
    frontend = torch.from_numpy(rng.standard_normal(
        (2, cfg.frontend_tokens, cfg.frontend_dim), dtype=np.float32))
    batch = {"tokens": tokens, "labels": tokens, "frontend": frontend}
    metrics = make_eval_step(model)(params, batch)
    assert float(metrics["tokens"]) == 2 * 11
    loss, _ = make_loss_fn(model)(params, batch)
    logits, _ = model.forward(params, tokens=tokens, frontend=frontend)
    want, _ = common.cross_entropy(logits[:, cfg.frontend_tokens:-1],
                                   tokens[:, 1:])
    assert torch.equal(loss, want)
