"""Every cell end to end at its smoke size on the CPU (the port's plain
paths): a well-formed result line, ``correct`` true; with each planted
fault and for the control, ``correct`` false; and a cell, a traffic mix,
a kind of loop, a sublayer and a metric added as files alone are run by
the harness unchanged."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import manifest, session  # noqa: E402
from harness.context import Context  # noqa: E402
from reference.model import Spec  # noqa: E402

CELLS = [w["name"] for w in manifest.load_json(
    ROOT / "BENCHMARK.json")["workloads"]]
FAULTED = [(name, fault) for name in CELLS
           for fault in manifest.loop_module(
               manifest.cell(name).traffic["kind"]).FAULTS]
SEED = 3_456_789_012


def run(name, traced=False, fault=None, seed=SEED, bench=BENCH):
    return session.run_cell(torch, manifest.cell(name, ROOT, bench), seed,
                            0.2, traced, "cpu", time.perf_counter(),
                            fault=fault, smoke=True, bench=bench)


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_end_to_end_and_prints_a_well_formed_line(name, traced):
    result = json.loads(json.dumps(run(name, traced)))
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(result)
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    cell = manifest.cell(name)
    allowed = {m["name"]: m["unit"]
               for m in (cell.per_layer if traced else cell.end_to_end)}
    assert all(allowed[k] == v["unit"] for k, v in result["metrics"].items())
    if not traced:  # the host clock's metrics exist on the CPU too
        assert "setup_s" in result["metrics"]
    else:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name,fault", FAULTED)
def test_a_planted_fault_makes_the_run_incorrect(name, fault):
    result = run(name, fault=fault, seed=SEED + 1)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_check(name):
    cell = manifest.cell(name)
    model, traffic, limits = session.sizes(cell, smoke=True)
    ctx = Context(torch=torch, cell=name, arch=cell.config["port"]["arch"],
                  model=model, spec=Spec.from_dict(model), traffic=traffic,
                  seed=SEED + 2, seconds=0.0, trace=False,
                  device=torch.device("cpu"), t0=time.perf_counter())
    numbers = manifest.loop_module(traffic["kind"]).control_numbers(ctx)
    assert session.verdict(numbers, limits, 0) is not None, numbers


def test_a_cell_mix_and_metric_added_as_files_are_run_unchanged(tmp_path):
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    m = manifest.load_json(ROOT / "BENCHMARK.json")
    m["workloads"].append({"name": "mamba2-2.7b.prefill_tiny",
                           "config": "mamba2-2.7b", "traffic": "prefill_tiny",
                           "chips": 1, "why": "a cell added as data"})
    m["per_layer"].append({"name": "dummy_ms.prefill", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "device", "moves": "prefill_tokens_per_s",
                           "workloads": ["mamba2-2.7b.prefill_tiny"]})
    for e in m["end_to_end"]:
        if "workloads" in e and "mamba2-2.7b.prefill_2k" in e["workloads"]:
            e["workloads"].append("mamba2-2.7b.prefill_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    mix = manifest.load_json(BENCH / "traffic" / "prefill_2k.json")
    mix["batch"] = 2
    (bench / "traffic" / "prefill_tiny.json").write_text(json.dumps(mix))
    shutil.copy(bench / "limits" / "mamba2-2.7b.prefill_2k.json",
                bench / "limits" / "mamba2-2.7b.prefill_tiny.json")
    (bench / "metrics" / "dummy_ms.prefill.py").write_text(
        'UNIT, SOURCE, LAYER = "ms", "host_clock", "device"\n'
        'MOVES = "prefill_tokens_per_s"\n\n\n'
        'def read(run):\n    return 1e3 * run.setup_s\n')
    m["per_layer"].append({"name": "blind_ms.prefill", "unit": "ms",
                           "better": "lower", "source": "program_span",
                           "layer": "device", "moves": "prefill_tokens_per_s",
                           "workloads": ["mamba2-2.7b.prefill_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    (bench / "metrics" / "blind_ms.prefill.py").write_text(
        'UNIT, SOURCE, LAYER = "ms", "program_span", "device"\n'
        'MOVES = "prefill_tokens_per_s"\n\n\n'
        'def read(run):\n    return None\n')
    script = (
        "import sys, time, json, torch\n"
        f"sys.path[:0] = [{str(bench)!r}, {str(ROOT / 'src')!r}]\n"
        "from harness import manifest, session\n"
        "cell = manifest.cell('mamba2-2.7b.prefill_tiny')\n"
        "r = session.run_cell(torch, cell, 7, 0.2, True, 'cpu',\n"
        "                     time.perf_counter(), smoke=True)\n"
        "print(json.dumps(r))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert "dummy_ms.prefill" in result["metrics"]
    # a metric given to the cell that reads nothing is named, not dropped
    assert "blind_ms.prefill" in result["missing"]
    assert "blind_ms.prefill" not in result["metrics"]
    assert result["attempted"] % 2 == 0 and result["correct"] is True


ECHO_LOOP = '''"""A loop of a new kind, added as a file."""

from harness.record import Run

NUMBERS = ("gap",)
FAULTS = ()


def run(ctx):
    record = Run(cell=ctx.cell, kind="echo", spec=ctx.spec, batch=1,
                 seq_len=ctx.traffic["seq_len"], n_params=0, setup_s=0.0)
    x = ctx.torch.arange(ctx.traffic["seq_len"], dtype=ctx.torch.float32)
    record.iterations = 3
    record.window_s = 1.0
    return record, {"gap": float((x - x).abs().max())}, 3, 0


def control_numbers(ctx):
    return {"gap": 1.0}
'''


def _copy(tmp_path):
    bench = tmp_path / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    return bench, manifest.load_json(ROOT / "BENCHMARK.json")


def _run_in(tmp_path, bench, script):
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         f"sys.path[:0] = [{str(bench)!r}, {str(ROOT / 'src')!r}]\n"
         + script], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_loop_of_a_new_kind_added_as_files_is_run_unchanged(tmp_path):
    bench, m = _copy(tmp_path)
    (bench / "harness" / "loops" / "echo.py").write_text(ECHO_LOOP)
    (bench / "traffic" / "echo.json").write_text(json.dumps(
        {"kind": "echo", "why": "a new kind", "seq_len": 8}))
    (bench / "limits" / "mamba2-2.7b.echo.json").write_text(json.dumps(
        {"gap": 0.5, "smoke": {"gap": 0.5}}))
    (bench / "metrics" / "echo_count.py").write_text(
        'UNIT, SOURCE = "1", "host_clock"\n\n\n'
        'def read(run):\n'
        '    return run.iterations if run.kind == "echo" else None\n')
    m["workloads"].append({"name": "mamba2-2.7b.echo", "config": "mamba2-2.7b",
                           "traffic": "echo", "chips": 1, "why": "new kind"})
    m["end_to_end"].append({"name": "echo_count", "unit": "1",
                            "better": "higher", "bound": 0.01,
                            "source": "host_clock",
                            "workloads": ["mamba2-2.7b.echo"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    result = _run_in(tmp_path, bench, (
        "import json, time, torch\n"
        "from harness import manifest, session\n"
        "cell = manifest.cell('mamba2-2.7b.echo')\n"
        "r = session.run_cell(torch, cell, 7, 0.2, False, 'cpu',\n"
        "                     time.perf_counter(), smoke=True)\n"
        "print(json.dumps(r))\n"))
    assert result["correct"] is True and result["attempted"] == 3
    assert result["metrics"]["echo_count"]["value"] == 3
    assert result["checks"] == {"gap": {"value": 0.0, "limit": 0.5}}


def test_a_sublayer_and_a_norm_added_as_files_are_drawn_run_and_counted(
        tmp_path):
    bench, _ = _copy(tmp_path)
    ffn = (bench / "reference" / "layers" / "ffn.py").read_text()
    (bench / "reference" / "layers" / "gelu_ffn.py").write_text(
        ffn.replace("F.silu(h @ p[\"w_gate\"])", "F.gelu(h @ p[\"w_gate\"])"))
    (bench / "counts" / "layers" / "gelu_ffn.py").write_text(
        (bench / "counts" / "layers" / "ffn.py").read_text())
    (bench / "reference" / "norms" / "offset_norm.py").write_text(
        (bench / "reference" / "norms" / "rmsnorm.py").read_text().replace(
            "return [(\"scale\", (d,), \"scale\")]",
            "return [(\"scale\", (d,), \"scale\"), (\"shift\", (d,), \"bias\")]"
        ).replace("* p[\"scale\"]", "* p[\"scale\"] + p[\"shift\"]"))
    result = _run_in(tmp_path, bench, (
        "import json, torch\n"
        "from counts import model_flops\n"
        "from harness import weights\n"
        "from reference import model\n"
        "spec = model.Spec.from_dict(dict(\n"
        "    family='ssm', num_layers=2, d_model=16, vocab_size=40,\n"
        "    d_ff=24, ssm_state=8, ssm_head_dim=8,\n"
        "    pattern=[['mamba', 'gelu_ffn']], norm='offset_norm'))\n"
        "tree = weights.draw(spec, 5, torch.float32, 'cpu')\n"
        "x = model.embed(tree['embed'], torch.arange(12)[None] % 40)\n"
        "for p, (mixer, ff) in zip(tree['blocks'], model.layer_plan(spec)):\n"
        "    x = model.block(p, spec, mixer, ff, x)\n"
        "logits = model.head(tree, spec, x)\n"
        "print(json.dumps({'shape': list(logits.shape),\n"
        "                  'finite': bool(logits.isfinite().all()),\n"
        "                  'leaves': sorted(tree['blocks'][0]['gelu_ffn']),\n"
        "                  'norm': sorted(tree['norm_out']),\n"
        "                  'macs': model_flops.matmul_macs_per_token(spec)}))\n"))
    assert result["shape"] == [1, 12, 256] and result["finite"]
    assert result["leaves"] == ["w_down", "w_gate", "w_up"]
    assert result["norm"] == ["scale", "shift"]
    mamba = 16 * (2 * 32 + 2 * 8 + 4) + 32 * 16
    assert result["macs"] == 2 * (mamba + 3 * 16 * 24) + 16 * 40


def test_run_refuses_without_the_cards_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
