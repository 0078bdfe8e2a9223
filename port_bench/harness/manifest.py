"""The manifest (``BENCHMARK.json``) and the files it names.

A cell ``<config>.<traffic>`` is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
the loop that drives it in ``harness/loops/<kind>.py`` (the mix's
``kind``), the limits of its output check in ``limits/<cell>.json``, and
each metric in ``metrics/<metric>.py``; the sublayers a configuration's
layer pattern names in ``reference/layers/`` and ``counts/layers/``.
Adding a cell, a mix, a kind of loop, a sublayer or a metric adds such a
file and an entry in the manifest; no code here changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_module(name: str, bench: Path = BENCH) -> ModuleType:
    """``metrics/<name>.py``, imported by path (a metric's name may hold
    dots)."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop_module(kind: str) -> ModuleType:
    """``harness/loops/<kind>.py``: the loop a traffic mix of ``kind``
    runs."""
    return importlib.import_module(f"harness.loops.{kind}")


def applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is read in ``cell``: named in its ``workloads``,
    or without that key wherever the end-to-end metric it moves (a per-layer
    metric) is reported, or everywhere (an end-to-end metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: Path = ROOT, bench: Path = BENCH) -> Cell:
    manifest = load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in manifest['workloads']]}")
    e2e = [m for m in manifest["end_to_end"] if applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"] if applies(m, name, reported)]
    return Cell(name=name, chips=entry["chips"],
                config=load_json(bench / "configs" / f"{entry['config']}.json"),
                traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(bench / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)
