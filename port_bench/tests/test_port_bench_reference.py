"""The plain reference against the port in float32 on the CPU, at the
configurations' smoke sizes: the same forward, the same training steps,
the same parameter tree, so that on the card the reference judges the
architecture the port runs and not another."""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import manifest, port, tokens, weights  # noqa: E402
from reference import model as ref  # noqa: E402
from reference import train as ref_train  # noqa: E402
from reference.layers import mamba as ref_mamba  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402

CONFIGS = ["mamba2-2.7b", "jamba-v0.1-52b"]
SEED = 2_876_543_210


def smoke(name: str, dtype: str = "float32"):
    cfg = manifest.load_json(BENCH / "configs" / f"{name}.json")
    model = dict(cfg["model"], **cfg["smoke"])
    spec = ref.Spec.from_dict(model)
    pcfg = dataclasses.replace(port.config(cfg["port"]["arch"], model, spec),
                               dtype=dtype)
    return spec, pcfg


def forward(spec, params, toks):
    x = ref.embed(params["embed"], toks)
    for p, (mixer, ff) in zip(params["blocks"], ref.layer_plan(spec)):
        x = ref.block(p, spec, mixer, ff, x)
    return ref.head(params, spec, x)


def test_ssd_chunks_equal_the_recurrence():
    g = torch.Generator().manual_seed(0)
    B, L, H, P, N = 2, 100, 3, 4, 5
    x = torch.randn(B, L, H, P, generator=g, dtype=torch.float64)
    dt = torch.rand(B, L, H, generator=g, dtype=torch.float64) * 0.2
    a = -torch.rand(H, generator=g, dtype=torch.float64) * 4
    b = torch.randn(B, L, N, generator=g, dtype=torch.float64)
    c = torch.randn(B, L, N, generator=g, dtype=torch.float64)
    h = torch.zeros(B, H, N, P, dtype=torch.float64)
    want = []
    for t in range(L):
        h = (h * torch.exp(a * dt[:, t])[..., None, None]
             + dt[:, t, :, None, None] * b[:, t, None, :, None]
             * x[:, t, :, None, :])
        want.append(torch.einsum("bn,bhnp->bhp", c[:, t], h))
    got = ref_mamba.ssd(x, dt, a, b, c, chunk=16)
    assert torch.allclose(got, torch.stack(want, 1), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("name", CONFIGS)
def test_layer_pattern_is_the_ports_plan_at_full_size(name):
    cfg = manifest.load_json(BENCH / "configs" / f"{name}.json")
    spec = ref.Spec.from_dict(cfg["model"])
    pcfg = port.config(cfg["port"]["arch"], cfg["model"], spec)
    assert ref.layer_plan(spec) == layer_plan(pcfg)
    assert len(ref.layer_plan(spec)) == cfg["model"]["num_layers"]


def test_a_pattern_that_does_not_divide_the_depth_is_refused():
    spec, _ = smoke("jamba-v0.1-52b")
    with pytest.raises(ValueError):
        ref.layer_plan(dataclasses.replace(spec, num_layers=6))


@pytest.mark.parametrize("name", CONFIGS)
def test_layer_plan_and_parameter_tree_are_the_ports(name):
    spec, pcfg = smoke(name)
    assert ref.layer_plan(spec) == layer_plan(pcfg)
    for dtype in (torch.float32, torch.bfloat16):
        mine = ref_train.leaves(weights.draw(spec, SEED, dtype, "cpu"))
        theirs = ref_train.leaves(build(pcfg, device="cpu").init(
            0, param_dtype=dtype))
        assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == \
            {k: (tuple(v.shape), v.dtype) for k, v in theirs.items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_a_layer_drawn_again_is_the_same_bits(name):
    spec, _ = smoke(name)
    tree = weights.draw(spec, SEED, torch.bfloat16, "cpu")
    again = weights.draw_layer(spec, SEED, 2, torch.bfloat16, "cpu")
    first = ref_train.leaves(tree["blocks"][1])
    assert all(torch.equal(first[k], v) for k, v in again.items())


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_forward_is_the_ports_in_float32(name):
    spec, pcfg = smoke(name)
    params = weights.draw(spec, SEED, torch.float32, "cpu")
    toks = torch.as_tensor(tokens.rows(SEED, 1, 2, 128, spec.vocab_size, 0.7))
    with torch.no_grad():
        got, _ = build(pcfg, device="cpu").forward(params, tokens=toks)
        want = forward(spec, params, toks)
    assert got.shape == want.shape == (2, 128, spec.vocab_rows)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_weight_decay_falls_where_the_port_puts_it():
    spec, pcfg = smoke("mamba2-2.7b")
    flat = {}

    def walk(tree, prefix=""):
        if isinstance(tree, tuple):
            flat[prefix] = tree
            return
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            walk(v, f"{prefix}.{k}" if prefix else str(k))

    walk(convert.reference_shapes(pcfg))
    params = ref_train.leaves(weights.draw(spec, SEED, torch.float32, "cpu"))
    assert set(flat) == set(params)
    assert all(ref_train.decays(k, params[k]) == (len(s) >= 2)
               for k, s in flat.items())


def test_reference_adamw_is_the_ports_optimizer_config():
    o = opt_mod.OptimizerConfig()
    r = ref_train.AdamW(o.learning_rate, o.warmup_steps, o.decay_steps)
    assert (r.beta1, r.beta2, r.eps, r.weight_decay, r.clip,
            r.min_lr_ratio) == (o.beta1, o.beta2, o.eps, o.weight_decay,
                                o.grad_clip_norm, o.min_lr_ratio)
    for step in (1, 3, 99, 100, 5000, 20000):
        assert r.lr_at(step) == pytest.approx(
            float(opt_mod.schedule(o, torch.tensor(step))), rel=1e-6)


def test_reference_steps_are_the_ports_train_steps_in_float32():
    spec, pcfg = smoke("mamba2-2.7b")
    tr = manifest.load_json(BENCH / "traffic" / "train_4k.json")["optimizer"]
    opt_cfg = opt_mod.OptimizerConfig(learning_rate=tr["lr"],
                                      warmup_steps=tr["warmup"],
                                      decay_steps=tr["decay_steps"])
    rows = tokens.rows(SEED, 0, 6, 128, spec.vocab_size, 0.7)
    batches = [torch.as_tensor(rows[2 * i:2 * i + 2]) for i in range(3)]
    params = weights.draw(spec, SEED, torch.float32, "cpu")
    state = opt_mod.init(params, opt_cfg, convert.reference_shapes(pcfg))
    step = make_train_step(build(pcfg, device="cpu"), opt_cfg)
    losses = []
    for i, b in enumerate(batches):
        params, state, m = step(params, state, {"tokens": b, "labels": b})
        losses.append(float(m["loss"]))
        if i == 0:
            grads = {k: float(v.norm()) / (1 - opt_cfg.beta1)
                     for k, v in ref_train.leaves(state.mu).items()}
    start = ref_train.leaves(weights.draw(spec, SEED, torch.float32, "cpu"))
    change = {k: float((v.detach() - start[k]).norm())
              for k, v in ref_train.leaves(params).items()}
    want = ref_train.run(lambda: weights.draw(spec, SEED, torch.float32, "cpu"),
                         spec, batches, ref_train.AdamW(
                             tr["lr"], tr["warmup"], tr["decay_steps"]),
                         tr["z_loss_weight"])
    assert losses == pytest.approx(want["loss"], rel=1e-5)
    assert grads == pytest.approx(want["grad_norms"], rel=1e-4, abs=1e-9)
    assert change == pytest.approx(want["change_norms"], rel=1e-3, abs=1e-9)
