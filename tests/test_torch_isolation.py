"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports jax or any module of the JAX package ``repro``, at any depth, and
its entry points do not fall back to the CPU when no card is present."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.apps import composite as papp
from repro_torch.apps import segmentation as pseg
from repro_torch.configs.festivus_imagery import SMOKE
from repro_torch.configs import get_config
from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore
from repro_torch.launch import serve as pserve
from repro_torch.models import build
from repro_torch.train import greedy_generate

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return (module == "jax" or module.startswith("jax.")
            or module == "repro" or module.startswith("repro."))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    modules = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"mods = {modules!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = set(__import__("json").loads(out.strip().splitlines()[-1]))
    assert set(modules) <= loaded
    assert not sorted(m for m in loaded if _forbidden(m))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_repro_import_at_any_depth(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)
              and _forbidden(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_composite_tile_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stack = np.random.default_rng(0).random((2, 8, 8, 4), dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.composite_tile(stack, SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.composite_tile(stack, SMOKE, impl="ref")


def test_campaign_without_device_raises_before_any_work(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = InMemoryObjectStore()
    cs = ChunkStore(Festivus(store), "bucket")
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.run_composite_campaign(cs, ["stacks/none"], SMOKE)
    assert store.list("bucket/composite") == []


def test_segment_tile_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    stack = rng.random((2, 8, 8, 4), dtype=np.float32)
    valid = rng.random((2, 8, 8)) > 0.3
    for impl in ("auto", "ref"):
        with pytest.raises(RuntimeError, match="CUDA"):
            pseg.segment_tile(stack, valid, SMOKE, impl=impl)
    with pytest.raises(RuntimeError, match="CUDA"):
        pseg.temporal_edges(stack, valid, SMOKE)
    with pytest.raises(RuntimeError, match="CUDA"):
        pseg.connected_components(valid[0])


def test_segmentation_campaign_without_device_raises_before_any_work(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = InMemoryObjectStore()
    cs = ChunkStore(Festivus(store), "bucket")
    with pytest.raises(RuntimeError, match="CUDA"):
        pseg.run_segmentation_campaign(cs, ["stacks/none"], SMOKE)
    assert store.list("bucket/fields") == []


def test_lm_entry_points_without_device_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = build(get_config("llama3-8b", "smoke"))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0)
    params = build(get_config("llama3-8b", "smoke"), device="cpu").init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        greedy_generate(model, params, torch.zeros((1, 2), dtype=torch.int32),
                        2, max_len=5)


def test_serve_cli_without_device_raises_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pserve.main(["--arch", "llama3-8b", "--variant", "smoke", "--gen", "2"])
    assert "[serve]" not in capsys.readouterr().out
