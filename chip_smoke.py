#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its seconds:

0. device and build: the card's name and power limit from ``nvidia-smi``,
   the kernels compiled with ``nvcc`` from this checkout's sources, and the
   rate of a 4 GiB device-to-device copy;
1. every kernel against its plain PyTorch version on the card, at the main
   path's shapes and at ragged ones, with the tolerance stated; the
   full-size cases are timed with CUDA events (median of 10);
2. one full-size tile (``DEFAULT``: 4096 px, 4 bands, T = 16) through
   ``apps.composite.composite_tile``, held against ``impl="ref"``;
3. the §V.C campaign: 4 tiles of 1024 px, T = 16, written by
   ``imagery.write_scene_stack`` and composited by ``run_composite_campaign``
   on 4 worker threads over a flaky store; each output must be
   byte-identical to the single-process path;
4. summary: the ``kernels`` line, the peak device memory, the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Any mismatch raises and the script exits nonzero.  Without CUDA, or run
from a directory that holds nothing else of the repository, it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 3e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:45-47
#: NVIDIA's H100 SXM data sheet: HBM3 bytes/s and f32 operations/s outside
#: the tensor cores, both at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
COPY_BYTES = 4 * 1024 ** 3
TIMED_RUNS = 10


def check(ok: bool, what: str) -> None:
    """Raise on a failed check (unlike assert, kept under python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(torch, fn, runs: int = TIMED_RUNS, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device(torch, build) -> dict:
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    built = build.build()
    resources = [line.strip() for info in built.values()
                 for line in info["log"].splitlines()
                 if "registers" in line or "spill" in line]
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = median_ms(torch, lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    copy_rate = 2 * COPY_BYTES / (copy_ms * 1e-3)  # read + write
    return {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "built": {n: round(i["seconds"], 3) for n, i in built.items()},
            "ptxas": resources[:16], "copy_gib": COPY_BYTES / 1024 ** 3,
            "copy_ms": copy_ms, "copy_bytes_per_s": copy_rate,
            "seconds": time.perf_counter() - t0}


# name, [T, H, W, C], images dtype, weights dtype, timed, zero weights,
# misaligned (vector loads off)
COMPOSITE_CASES = [
    ("main_path", (16, 4096, 4096, 4), "float32", "float32", True, False, False),
    ("paper_depth", (64, 4096, 4096, 4), "float32", "float32", True, False, False),
    ("bf16", (16, 4096, 4096, 4), "bfloat16", "bfloat16", True, False, False),
    ("bf16_f32_weights", (5, 64, 96, 4), "bfloat16", "float32", False, False, False),
    ("ragged_c3", (7, 37, 53, 3), "float32", "float32", False, False, False),
    ("thin_c1", (1, 8, 128, 1), "float32", "float32", False, False, False),
    ("c8", (3, 17, 33, 8), "float32", "float32", False, False, False),
    ("misaligned_c4", (4, 16, 24, 4), "float32", "float32", False, False, True),
    ("zero_weights", (3, 8, 8, 2), "float32", "float32", False, True, False),
]


def composite_bound(shape, x_bytes: int, w_bytes: int):
    """Bytes and operations the function needs, and the least time."""
    T, H, W, C = shape
    nbytes = T * H * W * (C * x_bytes + w_bytes) + H * W * C * x_bytes
    ops = 2 * T * H * W * C + T * H * W + H * W * C
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def phase_kernels(torch, seed: int, copy_rate: float) -> dict:
    from repro_torch.kernels import composite as kcomposite
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, wd, timed, zero_w, misaligned) in enumerate(
            COMPOSITE_CASES):
        xdt, wdt = getattr(torch, xd), getattr(torch, wd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + i)
        T, H, W, C = shape
        if misaligned:  # a contiguous view 4 bytes past an aligned base
            base = torch.rand(T * H * W * C + 1, generator=g, device="cuda",
                              dtype=xdt)
            x = base[1:].view(shape)
            check(x.data_ptr() % 16 != 0, "view should be misaligned")
        else:
            x = torch.rand(shape, generator=g, device="cuda", dtype=xdt)
        w = (torch.zeros((T, H, W), device="cuda", dtype=wdt) if zero_w else
             torch.rand((T, H, W), generator=g, device="cuda", dtype=wdt))
        got = kcomposite.composite(x, w)
        want = ref.composite(x, w)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (H, W, C) and got.dtype == xdt,
              f"{name}: shape or dtype")
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        tol = TOL[xd]
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"composite {name}")
        del got, want
        case = {"name": name, "shape": list(shape), "images": xd,
                "weights": wd, "max_abs_err": err, "tol": tol}
        if timed:
            nbytes, ops, bound_ms, bound_by = composite_bound(
                shape, x.element_size(), w.element_size())
            ms = median_ms(torch, lambda: kcomposite.composite(x, w))
            plain_ms = median_ms(torch, lambda: ref.composite(x, w))
            case.update({
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "bytes_per_s": nbytes / (ms * 1e-3)})
        cases.append(case)
        emit({"phase": "kernels.case", **case})
        del x, w
        torch.cuda.empty_cache()
    return {"phase": "kernels", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


def phase_tile(torch, seed: int, backend) -> dict:
    from repro_torch.apps.composite import composite_tile
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg

    t0 = time.perf_counter()
    px, T = cfg.composite_tile_px, cfg.temporal_depth
    stack = np.random.default_rng(seed).random((T, px, px, cfg.bands),
                                               dtype=np.float32)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    out = composite_tile(stack, cfg)
    tile_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    want = composite_tile(stack, cfg, impl="ref")
    check(out.shape == (px, px, cfg.bands) and out.dtype == np.float32,
          "tile: shape or dtype")
    check(np.isfinite(out).all(), "tile: non-finite output")
    err = float(np.abs(out - want).max())
    np.testing.assert_allclose(out, want, rtol=TOL["float32"],
                               atol=TOL["float32"])
    check(launches["composite"] == 1, f"tile: launches {launches}")
    breakdown = tile_breakdown(torch, stack, cfg)
    check(breakdown.pop("out").tobytes() == out.tobytes(),
          "tile: breakdown output differs")
    return {"phase": "tile", "shape": [T, px, px, cfg.bands],
            "launches": launches, "max_abs_err": err, "tol": TOL["float32"],
            "stack_gen_s": gen_s, "composite_tile_s": tile_s,
            "breakdown_s": breakdown, "seconds": time.perf_counter() - t0}


def tile_breakdown(torch, stack, cfg) -> dict:
    """composite_tile's steps, each timed on the host clock up to a
    synchronise: where a tile's time goes."""
    from repro_torch.apps.composite import cloud_score
    from repro_torch.convert import stack_to_device
    from repro_torch.kernels import ops, ref

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t

    (imgs, _), h2d_s = timed(lambda: stack_to_device(stack, None,
                                                     torch.device("cuda")))
    weights, weights_s = timed(lambda: ref.composite_weights(
        cloud_score(imgs, cfg), nir=imgs[..., 1], red=imgs[..., 0]))
    comp, kernel_s = timed(lambda: ops.composite(imgs, weights))
    out, d2h_s = timed(lambda: comp.cpu().numpy())
    return {"host_to_device": h2d_s, "cloud_score_and_weights": weights_s,
            "composite_kernel": kernel_s, "device_to_host": d2h_s, "out": out}


def phase_campaign(torch, seed: int, backend, tiles: int = 4,
                   px: int = 1024) -> dict:
    from repro_torch.apps.composite import (composite_tile,
                                            run_composite_campaign)
    from repro_torch.configs.festivus_imagery import DEFAULT
    from repro_torch.core import (ChunkStore, Festivus, FlakyObjectStore,
                                  InMemoryObjectStore)
    from repro_torch.data import imagery

    t0 = time.perf_counter()
    cfg = dataclasses.replace(DEFAULT, composite_tile_px=px, chunk_px=px)
    inner = InMemoryObjectStore()
    flaky = FlakyObjectStore(inner, failure_rate=0.02, seed=7)
    cs = ChunkStore(Festivus(flaky), "bucket")
    names = []
    for i in range(tiles):
        name = f"stacks/t{i}"
        imagery.write_scene_stack(
            cs, name, imagery.SceneSpec(tile_px=px, bands=cfg.bands,
                                        temporal_depth=cfg.temporal_depth,
                                        seed=seed * 100 + i),
            chunk_px=cfg.chunk_px)
        names.append(name)
    write_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    out = run_composite_campaign(cs, names, cfg, num_workers=4)
    campaign_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    report = out["report"]
    check(report.all_done and out["tiles"] == tiles, "campaign incomplete")

    max_err = 0.0
    for n in names:
        imgs, _ = imagery.read_scene_stack(cs, n)
        single = composite_tile(imgs, cfg)
        got = cs.open(f"composite/{n}").read_all()
        check(got.dtype == single.dtype and got.shape == single.shape,
              f"campaign: {n} shape or dtype")
        check(got.tobytes() == single.tobytes(), f"campaign diverges on {n}")
        want = composite_tile(imgs, cfg, impl="ref")
        np.testing.assert_allclose(got, want, rtol=TOL["float32"],
                                   atol=TOL["float32"])
        max_err = max(max_err, float(np.abs(got - want).max()))
    overview = cs.open(f"composite/{names[0]}").read_level(2)
    check(overview.shape == (px // 4, px // 4, cfg.bands),
          f"pyramid level 2 shape {overview.shape}")
    check(np.isfinite(overview).all(), "pyramid: non-finite")
    return {"phase": "campaign", "tiles": tiles, "tile_px": px,
            "temporal_depth": cfg.temporal_depth, "workers": report.nodes,
            "launches": launches, "byte_identical": True,
            "max_abs_err": max_err, "tol": TOL["float32"],
            "queue": report.queue_stats,
            "injected_store_failures": flaky.injected_failures,
            "retried_ops": report.festivus_stats.retried_ops,
            "stack_write_s": write_s, "campaign_s": campaign_s,
            "seconds": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; nothing was run")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        sys.exit(f"chip_smoke: {ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import backend, build

    device = phase_device(torch, build)
    emit(device)
    kernels = phase_kernels(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in kernels.items() if k != "results"})
    tile = phase_tile(torch, args.seed, backend)
    emit(tile)
    campaign = phase_campaign(torch, args.seed, backend)
    emit(campaign)
    launches = (tile["launches"]["composite"]
                + campaign["launches"]["composite"])
    check(campaign["launches"]["composite"] >= campaign["tiles"],
          f"campaign launches {campaign['launches']}")

    main_case = next(c for c in kernels["results"] if c["name"] == "main_path")
    emit({"kernels": [{
        "name": "composite", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/composite.cu",
        "replaces": "src/repro/kernels/composite.py:53",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in kernels["results"]
                           if c["images"] == "float32"),
        "tol": TOL["float32"], "shape": main_case["shape"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "copy_bound_ms": main_case["copy_bound_ms"],
        "library_ms": None}]})
    emit({"max_memory_allocated": torch.cuda.max_memory_allocated()})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
