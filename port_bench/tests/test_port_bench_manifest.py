"""The benchmark's manifest and the files it names: names, units, the
metrics each cell reports, and each metric's reader declaring what the
manifest says of it."""

import json
import math
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))

from harness import manifest  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}

M = manifest.load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_run_seconds():
    assert set(M) == KEYS
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert M["paths"] == ["port_bench"]
    assert M["command"] == ["python3", "port_bench/run.py"]


def test_names_units_and_lines_use_the_allowed_characters():
    names = ([c["name"] for c in M["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in M["workloads"]]
             + [w["traffic"] for w in M["workloads"]]
             + [k for c in M["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    for group in (M["configs"], M["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    lines = ([c["why"] for c in M["configs"] + M["workloads"]]
             + [c["source"] for c in M["configs"]]
             + [m["layer"] for m in M["per_layer"]] + M["command"])
    assert all(LINE.match(s) for s in lines)
    assert len(json.dumps(M)) < 64 * 1024


def test_each_entry_has_only_the_contract_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25 and "workloads" not in setup


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(name):
    cell = manifest.cell(name)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:  # each per-layer metric's moves is reported
        assert m["moves"] in e2e


def test_every_listed_workload_exists_and_every_config_is_used():
    for m in METRICS:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert {c["name"] for c in M["configs"]} == {w["config"]
                                                 for w in M["workloads"]}


@pytest.mark.parametrize("entry", M["configs"], ids=lambda c: c["name"])
def test_config_file_states_its_source_and_cuts(entry):
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("port_bench/")
    cfg = manifest.load_json(path)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    for key, cut in cfg["reduced"].items():
        assert cfg[key] == cut["run"] != cut["published"]
    assert {"model", "port", "departures", "deployment", "assumed"} <= set(cfg)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_each_metric_reader_declares_what_the_manifest_says(metric):
    mod = manifest.metric_module(metric["name"])
    assert mod.UNIT == metric["unit"] and mod.SOURCE == metric["source"]
    if "moves" in metric:
        assert (mod.LAYER, mod.MOVES) == (metric["layer"], metric["moves"])
    assert callable(mod.read)


@pytest.mark.parametrize("name", CELLS)
def test_limits_name_numbers_the_cell_compares(name):
    cell = manifest.cell(name)
    known = set(manifest.loop_module(cell.traffic["kind"]).NUMBERS)
    for limits in ({k: v for k, v in cell.limits.items() if k != "smoke"},
                   cell.limits["smoke"]):
        assert limits and set(limits) <= known
        assert all(v > 0 and math.isfinite(v) for v in limits.values())
