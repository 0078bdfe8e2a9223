"""One run of one cell, from the manifest's entry to the result line."""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from harness import manifest, trace
from harness.context import Context
from reference.model import Spec

#: top-level modules that must not be loaded in the process that prints
#: the result: JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_env(root: Path) -> None:
    """Caches of compilers the program may use, at fixed paths inside the
    checkout (the port builds its kernels into ``build/repro_torch``
    there itself); no library is to load JAX."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, None where it cannot
    be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "--id=0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def sizes(cell: manifest.Cell, smoke: bool):
    """(model sizes, traffic, limits) of ``cell``; ``smoke`` takes the
    files' ``smoke`` blocks (the CPU tests' sizes, and their limits)."""
    model, traffic = dict(cell.config["model"]), dict(cell.traffic)
    limits = {k: v for k, v in cell.limits.items() if k != "smoke"}
    if smoke:
        model.update(cell.config.get("smoke", {}))
        traffic.update(cell.traffic.get("smoke", {}))
        limits = cell.limits["smoke"]
    return model, traffic, limits


def run_cell(torch, cell: manifest.Cell, seed: int, seconds: float,
             traced: bool, device, t0: float, fault: Optional[str] = None,
             smoke: bool = False, bench: Path = manifest.BENCH) -> dict:
    """Drive ``cell`` once and return its result line (a dict)."""
    model, traffic, limits = sizes(cell, smoke)
    ctx = Context(torch=torch, cell=cell.name, arch=cell.config["port"]["arch"],
                  model=model, spec=Spec.from_dict(model), traffic=traffic,
                  seed=seed, seconds=seconds, trace=traced,
                  device=torch.device(device), t0=t0, fault=fault)
    loop = manifest.loop_module(traffic["kind"])
    started = time.perf_counter() - t0
    run, numbers, attempted, failed = loop.run(ctx)
    run.marks = {"imports": started, **run.marks}

    metrics, samples, missing = {}, {}, []
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = manifest.metric_module(m["name"], bench).read(run)
        if value is None:
            missing.append(m["name"])
        else:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if run.latencies_s:  # each prefill's or training step's seconds
        lat = sorted(run.latencies_s)
        samples["latencies"] = {"n": len(lat), "min_s": lat[0],
                                "median_s": lat[len(lat) // 2],
                                "max_s": lat[-1]}
    device_info = {"platform": "gpu" if ctx.on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(ctx.device)
                            if ctx.on_card else "cpu"),
                   "count": cell.chips if ctx.on_card else 0,
                   "memory_peak_bytes": run.peak_bytes}
    if ctx.on_card:
        device_info["power_limit_w"] = power_limit_w()
    result = {"correct": verdict(numbers, limits, failed) is None,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = trace.breakdown(run.trace)
    samples["seconds"] = {"setup": run.setup_s, "window": run.window_s,
                          "check": run.check_s, "setup_marks": run.marks}
    result["samples"] = samples
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in limits}
    result["missing"] = missing  # the cell's metrics that read nothing
    result["checks"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in limits.items()}
    return result


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> Optional[str]:
    """None where every number that has a limit is within it and nothing
    failed; else what was not."""
    bad = [k for k, lim in limits.items()
           if not (math.isfinite(numbers[k]) and numbers[k] <= lim)]
    if failed:
        bad.append(f"{failed} failed")
    return ", ".join(bad) or None
