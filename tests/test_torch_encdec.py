"""The port's enc-dec family (seamless-m4t: models.common's sinusoids,
models.attention's cross-attention, models.encdec, convert.params_from_numpy,
train.serve_step, launch.serve) against the JAX package, on the CPU.

seamless-smoke has 2 encoder and 2 decoder layers, d_model 64, 4 heads of
16, LayerNorm, plain-GELU FFNs with biases and frames of 48 features.  The
JAX side initialises it with ``init(PRNGKey(0))``; the biases and norms,
which JAX initialises to 0 and 1, are then redrawn from a seed with numpy
(and the config gains ``qkv_bias``), so that every bias path runs.  The
tree crosses over with ``convert.params_from_numpy``, so both packages run
the same weights.  Tokens and frames are made from a seed with numpy.  The
port is built with ``device="cpu"``, so its attention runs the plain
PyTorch versions (the CUDA kernel is held against those on the card, in
tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: f32 1e-4 (``F32_TOL``, tests/test_torch_lm.py's: the two
frameworks sum matmuls in other orders); bf16 2e-2 (``BF16_TOL``,
tests/test_kernels.py:45-47), on the relative L2 distance of the logits,
against the JAX model run op by op; decode-step logits 2e-3, because the
self-attention KV cache is bf16 even for an f32 model (tests/test_torch_lm.py
says why).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattention
from repro.models import build as jbuild
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models.model_zoo import _padded_cfg as jpadded_cfg
from repro.train.serve_step import greedy_generate as jgreedy_generate
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as kflash
from repro_torch.launch import serve as pserve
from repro_torch.models import attention, build, common, encdec
from repro_torch.models.model_zoo import _padded_cfg, padded_vocab
from repro_torch.train import greedy_generate, make_decode_step, make_prefill

ARCH = "seamless-m4t-large-v2"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = 2e-2
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
#: encoder frames and decoder tokens of the smoke cases (S_enc != S_dec)
S_ENC, S_DEC = 12, 16
#: the leaves JAX initialises to constants, redrawn here
BIAS_LEAVES = ("bq", "bk", "bv", "b_in", "b_out", "bias", "scale")


def _with_biases(tree, seed):
    """The numpy tree with every bias and norm leaf redrawn from a seed."""
    rng = np.random.default_rng(seed)

    def redraw(path, leaf):
        name = path[-1].key
        if name not in BIAS_LEAVES:
            return leaf
        noise = 0.1 * rng.standard_normal(leaf.shape).astype(np.float32)
        return (1.0 + noise) if name == "scale" else noise

    return jax.tree_util.tree_map_with_path(redraw, tree)


def _pair(dtype="float32", cfg_change=None, jax_change=None, seed=11):
    """(JAX model, JAX params, port model, port params): the same weights,
    biases non-zero."""
    change = {"qkv_bias": True, **(cfg_change or {})}
    cfg = dataclasses.replace(get_config(ARCH, "smoke"), dtype=dtype,
                              **change)
    jcfg = dataclasses.replace(jget_config(ARCH, "smoke"), dtype=dtype,
                               **{**change, **(jax_change or {})})
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


def _frames(cfg, batch, frames, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, frames, cfg.frontend_dim)).astype(np.float32)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _rel_l2(got, want):
    got, want = _f32(got), _f32(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _layer(jtree, i):
    return jax.tree.map(lambda a: a[i], jtree)


# ---------------------------------------------------------------------------
# sinusoidal positions
# ---------------------------------------------------------------------------
def _sinusoid_tol(max_pos):
    """F32_TOL, plus what one ulp of a channel's frequency moves its angle
    at ``max_pos``: XLA's f32 exp and PyTorch's differ by one ulp on some
    channels (the frequencies are <= 1, an ulp <= 2^-23), and sin and cos
    carry the angle's error over."""
    return dict(rtol=F32_TOL["rtol"], atol=F32_TOL["atol"] + max_pos * 2**-23)


@pytest.mark.parametrize("seq,dim", [(1, 8), (16, 64), (2048, 1024)])
def test_sinusoidal_positions_match_jax(seq, dim):
    got = common.sinusoidal_positions(seq, dim)
    want = jcommon.sinusoidal_positions(seq, dim)
    assert got.dtype == torch.float32 and got.shape == (seq, dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_sinusoid_tol(seq - 1))


@pytest.mark.parametrize("dim", [64, 1024])
@pytest.mark.parametrize("pos", [0, 1, 7, 100, 2047])
def test_sinusoidal_at_matches_jax(pos, dim):
    got = common.sinusoidal_at(pos, dim)
    want = jcommon.sinusoidal_at(jnp.int32(pos), dim)
    assert got.dtype == torch.float32 and got.shape == (dim,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **_sinusoid_tol(pos))
    # one position's embedding is that row of the table
    torch.testing.assert_close(got, common.sinusoidal_positions(pos + 1,
                                                                dim)[pos])


# ---------------------------------------------------------------------------
# cross-attention against JAX
# ---------------------------------------------------------------------------
def _cross_inputs(model, seq_q, seq_k, seed):
    rng = np.random.default_rng(seed)
    d = model.cfg.d_model
    x = rng.standard_normal((2, seq_q, d)).astype(np.float32)
    mem = rng.standard_normal((2, seq_k, d)).astype(np.float32)
    return x, mem


@pytest.mark.parametrize("seq_q,seq_k", [(1, 12), (16, 12), (5, 40)],
                         ids=["decode_row", "sq_gt_sk", "sq_lt_sk"])
def test_encode_memory_kv_and_cross_attention_match_jax(f32_pair, seq_q,
                                                        seq_k):
    jmodel, jparams, model, params = f32_pair
    jblock = _layer(jparams["decoder"], 1)["cross_attn"]
    block = params["decoder"][1]["cross_attn"]
    x, mem = _cross_inputs(model, seq_q, seq_k, seed=1)
    jkv = jattention.encode_memory_kv(jblock, jmodel.cfg, jnp.asarray(mem))
    kv = attention.encode_memory_kv(block, model.cfg, torch.from_numpy(mem))
    for got, want in zip(kv, jkv):
        assert got.shape == (2, model.cfg.num_kv_heads, seq_k,
                             model.cfg.head_dim)
        np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)
    want = jattention.cross_attn_forward(jblock, jmodel.cfg, jnp.asarray(x),
                                         jkv)
    got = attention.cross_attn_forward(block, model.cfg, torch.from_numpy(x),
                                       kv)
    assert got.shape == (2, seq_q, model.cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


@pytest.mark.parametrize("seq_q", [1, 24, 64])
def test_cross_attention_against_jax_pallas_kernel(seq_q):
    """seamless's head_dim 64, the JAX side through its Pallas flash kernel
    (interpret mode): non-causal, Sq != Sk (40 encoder frames)."""
    change = dict(d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
                  d_ff=256)
    jmodel, jparams, model, params = _pair(
        cfg_change=change, jax_change={"attention_impl": "pallas"})
    assert jmodel.cfg.attention_impl == "pallas" and model.cfg.head_dim == 64
    jblock = _layer(jparams["decoder"], 0)["cross_attn"]
    block = params["decoder"][0]["cross_attn"]
    x, mem = _cross_inputs(model, seq_q, 40, seed=2)
    jkv = jattention.encode_memory_kv(jblock, jmodel.cfg, jnp.asarray(mem))
    want = jattention.cross_attn_forward(jblock, jmodel.cfg, jnp.asarray(x),
                                         jkv)
    kv = attention.encode_memory_kv(block, model.cfg, torch.from_numpy(mem))
    got = attention.cross_attn_forward(block, model.cfg, torch.from_numpy(x),
                                       kv)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_encoder_attention_is_bidirectional(f32_pair):
    """The encoder's attention sees later frames: changing the last frame
    moves the first frame's memory (a causal encoder would not)."""
    _, _, model, params = f32_pair
    pcfg = _padded_cfg(model.cfg)
    frames = torch.from_numpy(_frames(model.cfg, 1, S_ENC, seed=3))
    moved = frames.clone()
    moved[:, -1] += 1.0
    a = encdec.encode(params, pcfg, frames)
    b = encdec.encode(params, pcfg, moved)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# encode and forward against JAX
# ---------------------------------------------------------------------------
def test_encode_matches_jax(f32_pair):
    jmodel, jparams, model, params = f32_pair
    frames = _frames(model.cfg, 2, S_ENC, seed=4)
    want = jencdec.encode(jparams, jpadded_cfg(jmodel.cfg),
                          jnp.asarray(frames))
    got = encdec.encode(params, _padded_cfg(model.cfg),
                        torch.from_numpy(frames))
    assert got.shape == (2, S_ENC, model.cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


@pytest.mark.parametrize("s_enc,s_dec", [(S_ENC, S_DEC), (32, 8), (7, 1)],
                         ids=["enc_lt_dec", "enc_gt_dec", "one_token"])
def test_forward_matches_jax_f32(f32_pair, s_enc, s_dec):
    jmodel, jparams, model, params = f32_pair
    toks = _tokens(model.cfg.vocab_size, (2, s_dec), seed=5)
    frames = _frames(model.cfg, 2, s_enc, seed=6)
    want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                             frontend=jnp.asarray(frames))
    got, aux = model.forward(params, tokens=torch.from_numpy(toks),
                             frontend=torch.from_numpy(frames))
    assert got.shape == (2, s_dec, padded_vocab(model.cfg))
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_f32(got), _f32(want), **F32_TOL)


def test_forward_matches_jax_bf16(bf16_pair):
    """bf16 logits within BF16_TOL relative L2 of the JAX model run op by
    op (compiled, XLA fuses bf16 chains and rounds elsewhere)."""
    jmodel, jparams, model, params = bf16_pair
    toks = _tokens(model.cfg.vocab_size, (2, S_DEC), seed=7)
    frames = _frames(model.cfg, 2, S_ENC, seed=8)
    with jax.disable_jit():
        want, _ = jmodel.forward(jparams, tokens=jnp.asarray(toks),
                                 frontend=jnp.asarray(frames))
    got = make_prefill(model)(params, tokens=torch.from_numpy(toks),
                              frontend=torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16
    assert _rel_l2(got, want) < BF16_TOL


def test_forward_ignores_ssd_impl_and_launches_nothing_on_the_cpu(f32_pair):
    _, _, model, params = f32_pair
    toks = torch.from_numpy(_tokens(model.cfg.vocab_size, (1, 4), seed=9))
    frames = torch.from_numpy(_frames(model.cfg, 1, 5, seed=9))
    before = kflash.launches.count
    a, _ = model.forward(params, tokens=toks, frontend=frames)
    b, _ = model.forward(params, tokens=toks, frontend=frames,
                         ssd_impl="chunked")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kflash.launches.count == before


# ---------------------------------------------------------------------------
# decode path against JAX
# ---------------------------------------------------------------------------
def _memory_pair(jmodel, jparams, model, params, frames):
    jmem = jencdec.encode(jparams, jpadded_cfg(jmodel.cfg),
                          jnp.asarray(frames))
    mem = encdec.encode(params, _padded_cfg(model.cfg),
                        torch.from_numpy(frames))
    return jmem, mem


def test_decode_step_matches_jax(f32_pair):
    jmodel, jparams, model, params = f32_pair
    B, S = 2, 8
    toks = _tokens(model.cfg.vocab_size, (B, S), seed=10)
    jmem, mem = _memory_pair(jmodel, jparams, model, params,
                             _frames(model.cfg, B, S_ENC, seed=10))
    jstate = jmodel.init_decode(jparams, B, S + 1, memory=jmem)
    state = model.init_decode(params, B, S + 1, memory=mem)
    assert isinstance(state, encdec.DecCache)
    assert len(state.self_kv) == len(state.cross_k) == model.cfg.num_layers
    for i in range(model.cfg.num_layers):
        np.testing.assert_allclose(_f32(state.cross_k[i]),
                                   _f32(jstate.cross_k[i]), **F32_TOL)
        np.testing.assert_allclose(_f32(state.cross_v[i]),
                                   _f32(jstate.cross_v[i]), **F32_TOL)
    step = make_decode_step(model)
    for t in range(S):
        jstate, want = jmodel.decode_step(jparams, jstate,
                                          jnp.asarray(toks[:, t:t + 1]))
        state, got = step(params, state, torch.from_numpy(toks[:, t:t + 1]))
        assert got.shape == (B, 1, padded_vocab(model.cfg))
        np.testing.assert_allclose(_f32(got), _f32(want), **DECODE_TOL)
    assert [c.length for c in state.self_kv] == [S] * model.cfg.num_layers
    assert all(c.k.dtype == torch.bfloat16 for c in state.self_kv)


def test_init_decode_needs_memory(f32_pair):
    _, _, model, params = f32_pair
    with pytest.raises(ValueError, match="memory"):
        model.init_decode(params, 2, 9)
    with pytest.raises(ValueError, match="frontend"):
        greedy_generate(model, params, torch.zeros((2, 3), dtype=torch.int32),
                        2, max_len=6)


@pytest.mark.parametrize("seed", [12, 14])
def test_greedy_generate_tokens_equal_jax(f32_pair, seed):
    """Tokens equal in f32 (in bf16 a near-tie of two logits, rounded
    elsewhere by the two frameworks, may pick another token)."""
    jmodel, jparams, model, params = f32_pair
    prompt = _tokens(model.cfg.vocab_size, (2, 6), seed=seed)
    frames = _frames(model.cfg, 2, S_ENC, seed=seed)
    want = jgreedy_generate(jmodel, jparams, jnp.asarray(prompt), 12,
                            max_len=19, frontend=jnp.asarray(frames))
    got = greedy_generate(model, params, torch.from_numpy(prompt), 12,
                          max_len=19, frontend=torch.from_numpy(frames))
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.max()) < model.cfg.vocab_size


def test_decode_matches_forward():
    """tests/test_models.py:75's enc-dec case on the port: token-by-token
    decode against the memory agrees with the full forward (bf16)."""
    cfg = get_config(ARCH, "smoke")
    model = build(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 8
    toks = torch.from_numpy(_tokens(cfg.vocab_size, (B, S), seed=13))
    frames = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (B, 4, cfg.frontend_dim)).astype(np.float32))
    full, _ = model.forward(params, tokens=toks, frontend=frames)
    memory = encdec.encode(params, _padded_cfg(cfg), frames)
    state = model.init_decode(params, B, S + 1, memory=memory)
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
    """The port's own init has the layout params_from_numpy makes of the
    JAX tree: the same leaves, shapes and dtypes."""
    _, _, model, converted = bf16_pair
    params = model.init(0)
    assert _leaves(params) == _leaves(converted)
    assert params["norm_enc"]["bias"].dtype == torch.float32
    assert params["frontend_proj"].dtype == torch.bfloat16
    assert params["decoder"][1]["ffn"]["b_in"].dtype == torch.bfloat16


def test_params_from_numpy_maps_each_layer_by_value(f32_pair):
    jmodel, jparams, _, params = f32_pair
    for stack, parts in (("encoder", ("attn/bq", "ffn/b_out",
                                      "norm_attn/bias")),
                         ("decoder", ("cross_attn/wk", "self_attn/bv",
                                      "norm_cross/scale"))):
        for i, layer in enumerate(params[stack]):
            for part in parts:
                a, b = part.split("/")
                np.testing.assert_array_equal(
                    layer[a][b].numpy(), np.asarray(jparams[stack][a][b][i]))
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(jparams["frontend_proj"]))


@pytest.mark.parametrize("breakage", ["unknown", "missing", "shape"])
def test_params_from_numpy_rejects_a_tree_that_does_not_fit(breakage):
    cfg = get_config(ARCH, "smoke")
    tree = jax.tree.map(np.asarray,
                        jbuild(jget_config(ARCH, "smoke")).init(
                            jax.random.PRNGKey(0)))
    if breakage == "unknown":
        tree["decoder"]["cross_attn"]["bq"] = tree["decoder"]["ffn"]["b_out"]
        match = "unknown leaves.*decoder/cross_attn/bq"
    elif breakage == "missing":
        del tree["norm_enc"]
        match = "missing.*norm_enc/bias"
    else:
        tree["encoder"]["ffn"]["w_in"] = tree["encoder"]["ffn"]["w_in"][:1]
        match = "encoder/ffn/w_in: shape"
    with pytest.raises(ValueError, match=match):
        params_from_numpy(tree, cfg, "cpu")


def test_seamless_full_width():
    """The published widths and the vocabulary's padding (256206 ->
    256256); chip_smoke.py runs it at full depth."""
    cfg = get_config(ARCH)
    assert cfg.family == "encdec" and cfg.dtype == "bfloat16"
    assert (cfg.enc_layers, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, cfg.d_ff, cfg.frontend_dim) == (
                24, 24, 1024, 16, 16, 64, 8192, 1024)
    assert cfg.norm == "layernorm" and cfg.pos_embed == "sinusoidal"
    assert padded_vocab(cfg) == 256256
    assert abs(_padded_cfg(cfg).param_count() - 1.37e9) < 0.01e9


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
    assert all(0 <= t < get_config(ARCH, "smoke").vocab_size
               for t in rec["generated"])
    assert kflash.launches.count == before
