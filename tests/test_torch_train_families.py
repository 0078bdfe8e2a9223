"""chip_smoke.py's training phases (``TRAIN``) on the CPU: the cut configs
against the published ones, the kernels' entry points called as often in
one train step as the card's gate expects, and each cut's train step
against the JAX package's at smoke width.

``chip_smoke.py`` is loaded by path (it sits at the repository's root and
imports neither ``torch`` nor the port at module level).  On the CPU the
entry points ``kernels.ops.flash_attention`` and ``kernels.ops.ssd`` run
their plain versions, which autograd differentiates: a train step with
remat "full" calls each twice per attention call or mamba layer (the
forward and the recompute), what the card counts as forward launches; the
card's backward launches (once per call) have no CPU counterpart and are
counted on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import contextlib
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_train import _hold_step, _step_pair

from repro.configs import get_config as jget_config
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import build
from repro_torch.models.transformer import layer_plan, mixer_norm_name
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


CS = _chip_smoke()
#: the phases after mamba's and jamba's, and their (decoder) layers and
#: encoder layers at full width
NEW = {"seamless": (24, 24), "gemma": (4, 0), "internvl": (24, 0),
       "dbrx": (1, 0), "jamba_attn": (2, 0), "qwen": (16, 0),
       "qwen72": (1, 0)}
#: what a cut may not change: every width, the vocabulary, the experts and
#: the frontend
WIDTHS = ("family", "d_model", "num_heads", "num_kv_heads", "head_dim",
          "d_ff", "vocab_size", "qkv_bias", "act", "norm", "rope_theta",
          "pos_embed", "embed_scale", "tie_embeddings", "num_experts",
          "experts_per_token", "moe_d_ff", "num_shared_experts",
          "moe_layer_period", "capacity_factor", "ssm_state",
          "ssm_head_dim", "ssm_expand", "ssm_conv_width", "frontend_tokens",
          "frontend_dim", "dtype", "remat", "remat_policy",
          "attention_impl")


def test_the_table_holds_every_training_family_in_order():
    assert list(CS.TRAIN) == ["mamba", "jamba", *NEW]
    assert {CS.TRAIN[w].arch for w in NEW} == {
        "seamless-m4t-large-v2", "gemma-7b", "internvl2-1b", "dbrx-132b",
        "jamba-v0.1-52b", "qwen1.5-4b", "qwen2-72b"}
    assert CS.TRAIN["qwen72"].moments == "int8"
    assert not CS.TRAIN["qwen72"].grads_on_host


@pytest.mark.parametrize("which", list(NEW))
def test_cut_keeps_the_published_widths(which):
    """Only the depth differs from the arch's config (and the JAX
    package's), and for jamba's attention cut its period and offset."""
    phase = CS.TRAIN[which]
    cfg = CS.train_config(which)
    for full in (get_config(phase.arch), jget_config(phase.arch)):
        assert {w: getattr(cfg, w) for w in WIDTHS} == {
            w: getattr(full, w) for w in WIDTHS}
    full = get_config(phase.arch)
    changed = {f.name for f in dataclasses.fields(cfg)
               if getattr(cfg, f.name) != getattr(full, f.name)}
    allowed = {"num_layers"}
    if which == "jamba_attn":
        allowed |= {"attn_layer_period", "attn_layer_offset"}
    assert changed <= allowed
    assert (cfg.num_layers, cfg.enc_layers) == NEW[which]


def test_jamba_attention_cut_holds_an_attention_sublayer():
    """Period 2, offset 1: (mamba, FFN), (attention, MoE), the attention
    after ``norm_mix`` as in a hybrid's super-block."""
    cfg = CS.train_config("jamba_attn")
    assert layer_plan(cfg) == [("mamba", "ffn"), ("attn", "moe")]
    assert mixer_norm_name(cfg, "attn") == "norm_mix"
    assert CS.train_launches(cfg) == {
        "flash_attention": 2, "flash_attention_bwd": 1, "ssd_scan": 2,
        "ssd_scan_bwd": 1}
    assert layer_plan(CS.train_config("jamba")) == [("mamba", "ffn"),
                                                    ("mamba", "moe")]


def test_dry_run_holds_each_cut_it_can_express():
    """The dry run takes a depth: every training phase but jamba's two
    (a period and an offset) has its cell, at the phase's shape."""
    cells = {k for k in CS.DRYRUN_TRAINED if k.endswith("_train")}
    assert cells == {"llama_train", "mesh_train", "tp_rank_train",
                     "maverick_rank_train",
                     *(f"{w}_train" for w in CS.TRAIN
                       if w not in ("jamba", "jamba_attn"))}
    for cell in ("dbrx_train", "qwen72_train"):
        argv = CS.DRYRUN_TRAINED[cell]
        assert argv[argv.index("--layers") + 1] == "1"
        assert argv[argv.index("--moments") + 1] == "int8"
    assert "--layers" not in CS.DRYRUN_TRAINED["seamless_train"]
    argv = CS.DRYRUN_TRAINED["maverick_rank_train"]
    assert argv == ["--arch", "llama4-maverick-400b-a17b", "--shape",
                    "train_4k", "--mesh", "local", "--mesh-data", "1",
                    "--mesh-model", "8", "--layers", "1", "--batch", "2",
                    "--seq", "4096", "--moments", "int8"]


@pytest.mark.parametrize("which, arch, layers, heads", [
    ("tp_rank_train", "llama3-8b", 8, (4, 1)),
    ("maverick_rank_train", "llama4-maverick-400b-a17b", 1, (5, 1))])
def test_rank_phases_heads_and_launches(which, arch, layers, heads):
    """The rank phases' table (RANK_TRAIN): rank 0 of a model axis of 8
    holds llama3-8b's 4 query heads on 1 KV head, maverick's 5 on 1; each
    attention layer launches the flash forward twice a step (remat) and
    its backward once."""
    assert CS.RANK_TRAIN[which] == (arch, layers)
    assert which in CS.only_names()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    assert CS.rank_heads(cfg, CS.TP_RANKS) == heads
    assert CS.rank_launches(cfg) == {"flash_attention": 2 * layers,
                                     "flash_attention_bwd": layers}
    assert layer_plan(cfg) == [("attn", "moe" if cfg.is_moe else "ffn")
                               ] * layers


def _smoke_cut(which):
    """TRAIN[which]'s arch at smoke width with the phase's cut, its
    attention through the entry point's "auto"."""
    phase = CS.TRAIN[which]
    return dataclasses.replace(get_config(phase.arch, "smoke"),
                               attention_impl="auto", remat=True,
                               remat_policy="full", **phase.cut)


@pytest.mark.parametrize("which", list(CS.TRAIN))
def test_train_step_calls_the_entry_points_as_the_card_gate_expects(
        which, monkeypatch):
    """One train step at smoke width calls ops.flash_attention and ops.ssd
    as often as chip_smoke's ``train_launches`` expects forward launches
    a step: an enc-dec model's enc_layers + 2 num_layers attention calls,
    a VLM's with its patch-embedding prefix in the batch, twice each."""
    monkeypatch.setattr(CS, "TRAIN_SEQ", 64)
    cfg = _smoke_cut(which)
    calls = {"flash_attention": 0, "ssd_scan": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(ops, "flash_attention",
                        counted("flash_attention", ops.flash_attention))
    monkeypatch.setattr(ops, "ssd", counted("ssd_scan", ops.ssd))
    tokens, frames = CS.train_lengths(cfg)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, tokens),
                                        dtype=np.int32))
    batch = {"tokens": ids, "labels": ids}
    if frames:
        batch["frontend"] = torch.from_numpy(rng.standard_normal(
            (2, frames, cfg.frontend_dim or cfg.d_model), dtype=np.float32))
    model = build(cfg, device="cpu")
    params = model.init(0, param_dtype=torch.float32)
    opt_cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=1)
    _, _, metrics = make_train_step(model, opt_cfg)(
        params, opt.init(params, opt_cfg), batch)
    assert np.isfinite(float(metrics["loss"]))
    want = CS.train_launches(cfg)
    assert calls == {"flash_attention": want["flash_attention"],
                     "ssd_scan": want["ssd_scan"]}
    assert want["flash_attention"] == 2 * want["flash_attention_bwd"]
    if cfg.is_encdec:
        assert want["flash_attention_bwd"] == cfg.enc_layers + 2 * \
            cfg.num_layers
        assert frames == 128  # max(128, TRAIN_SEQ // 4) frames a row
    if cfg.frontend_tokens and not cfg.is_encdec:
        assert (tokens, frames) == (64 - cfg.frontend_tokens,
                                    cfg.frontend_tokens)


#: the batch's frontend for the JAX comparison: frames of an enc-dec
#: model's encoder, a VLM's patch embeddings
JAX_FRAMES = {"seamless": 24, "internvl": "prefix"}


@pytest.mark.parametrize("which", list(NEW))
def test_cut_train_step_matches_jax_at_smoke_width(which):
    """Each new phase's cut (its depth; jamba's period and offset) at
    smoke width: one AdamW step of the port against the JAX package's on
    the same weights and batch (tests/test_torch_train.py's tolerances)."""
    phase = CS.TRAIN[which]
    frames = JAX_FRAMES.get(which)
    if frames == "prefix":
        frames = get_config(phase.arch, "smoke").frontend_tokens
    _hold_step(*_step_pair(phase.arch, cfg_change=dict(phase.cut),
                           frames=frames))


def _int8_step(leaf_shape, steps=3):
    """``steps`` AdamW updates with int8 moments of a leaf ``leaf_shape``
    and a vector, on gradients drawn from a numpy seed -> (params,
    state)."""
    rng = np.random.default_rng(7)
    params = {"w": torch.from_numpy(rng.standard_normal(
        leaf_shape, dtype=np.float32)),
        "b": torch.from_numpy(rng.standard_normal(leaf_shape[-1:],
                                                  dtype=np.float32))}
    cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=1,
                          moments_dtype="int8")
    state = opt.init(params, cfg)
    for _ in range(steps):
        grads = {k: torch.from_numpy(rng.standard_normal(
            tuple(v.shape), dtype=np.float32)) for k, v in params.items()}
        params, state, _ = opt.update(grads, state, params, cfg)
    return params, state


def test_int8_update_in_row_parts_is_the_whole_leaf_update(monkeypatch):
    """Parts of whole rows (here 1, 2 and 3 rows of 256, the last part
    short) give the same bits as the whole leaf: parameters, int8 moments
    and their row scales."""
    shape = (4, 64, 256)  # Q_MIN_SIZE elements: int8 moments
    whole = _int8_step(shape)
    assert isinstance(whole[1].mu["w"], opt.QTensor)
    for part in (256, 512, 768):
        monkeypatch.setattr(opt, "UPDATE_PART", part)
        got = _int8_step(shape)
        assert got[1].mu["w"].shape == shape
        for a, b in zip(opt.tree_leaves(got), opt.tree_leaves(whole)):
            if isinstance(a, opt.QTensor):
                assert torch.equal(a.q, b.q) and torch.equal(a.scale,
                                                             b.scale)
            else:
                assert torch.equal(a, b)


@contextlib.contextmanager
def _one_rank_mesh():
    """A 1 x 1 mesh on torch's fake process group of one rank (the dry
    run's), torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as pmesh

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        yield pmesh.make_local_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _update_temporaries(shape, leaf=None) -> int:
    """Bytes the int8 update of one f32 leaf ``shape`` holds beyond its
    arguments at its peak, counted on fake tensors by the dry run's
    StepCounter.  ``leaf`` (an MoE leaf's name): the leaf is that leaf's
    shard on a 1 x 1 mesh, updated with its ``layouts`` (the global norm
    and each row maximum all-reduced on the fake process group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd

    counter = dryrun.StepCounter()
    cfg = OptimizerConfig(moments_dtype="int8")
    with contextlib.ExitStack() as stack:
        layouts = None
        if leaf is not None:
            mesh = stack.enter_context(_one_rank_mesh())
            layouts = {"w": shd.to_named_sharding(
                mesh, shd.param_logical_spec(["blocks", "moe", leaf]),
                shape)}
        with FakeTensorMode():
            params = {"w": torch.empty(shape)}
            state = opt.init(params, cfg)
            grads = {"w": torch.empty(shape)}
            held = counter.hold((params, state, grads))
            with counter:
                opt.update(grads, state, params, cfg, layouts=layouts)
    return counter.peak - held


def test_int8_update_holds_no_f32_copies_of_a_large_leaf(monkeypatch):
    """dbrx-132b's expert stack at d_model / 8: updated whole, the int8
    update holds four f32 copies of the leaf and more at once; in parts of
    1 << 20 elements, the global norm's square of the gradient (one copy,
    before the update; the new int8 moments go into the old ones' place)."""
    shape = (16, 768, 10752)
    f32_leaf = 4 * math.prod(shape)
    monkeypatch.setattr(opt, "UPDATE_PART", math.prod(shape))
    assert _update_temporaries(shape) >= 4 * f32_leaf
    monkeypatch.setattr(opt, "UPDATE_PART", 1 << 20)
    assert _update_temporaries(shape) < 1.5 * f32_leaf


@pytest.mark.parametrize("leaf,shape", [("w_gate", (16, 768, 10752)),
                                        ("w_down", (16, 10752, 768))])
def test_int8_update_on_a_mesh_holds_no_f32_copies_of_a_large_leaf(
        monkeypatch, leaf, shape):
    """The same stacks with ``layouts``, as every mesh step updates them
    (a 1 x 1 mesh, the fake process group): ``w_gate``'s last axis is not
    sharded, ``w_down``'s is over ``data``, so each of its parts
    all-reduces its row maxima.  In one part, four f32 copies of the leaf
    and more; in parts of 1 << 20 elements, under 1.5."""
    f32_leaf = 4 * math.prod(shape)
    monkeypatch.setattr(opt, "UPDATE_PART", math.prod(shape))
    assert _update_temporaries(shape, leaf) >= 4 * f32_leaf
    monkeypatch.setattr(opt, "UPDATE_PART", 1 << 20)
    assert _update_temporaries(shape, leaf) < 1.5 * f32_leaf
