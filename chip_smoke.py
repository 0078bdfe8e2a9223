#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its seconds:

0. device and build: the card's name and power limit from ``nvidia-smi``,
   the kernels compiled with ``nvcc`` from this checkout's sources, and the
   rate of a 4 GiB device-to-device copy;
1. every kernel (``composite``, ``grad_mag``) against its plain PyTorch
   version on the card, at the main path's shapes and at ragged ones, with
   the tolerance stated; the full-size cases are timed with CUDA events
   (median of 10);
2. one full-size composite tile (``DEFAULT``: 4096 px, 4 bands, T = 16)
   through ``apps.composite.composite_tile``, held against ``impl="ref"``;
3. the §V.C campaign: 4 tiles of 1024 px, T = 16, written by
   ``imagery.write_scene_stack`` and composited by ``run_composite_campaign``
   on 4 worker threads over a flaky store; each output must be
   byte-identical to the single-process path;
4. one full-size §V.B segmentation tile ([16, 6144, 6144, 4] f32, a mosaic
   of fields under clouds made on the card) through
   ``apps.segmentation.segment_tile``: its edges held against
   ``impl="ref"``, its labels and GeoJSON against the chain run step by
   step (each step timed), its fields against the ground truth;
5. the §V.B campaign over phase 3's four stacks: ``run_segmentation_campaign``
   on 4 worker threads, byte-identical to the single-process path;
6. summary: the ``kernels`` line, the peak device memory, the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

The launch counts are set to 0 just before each main-path phase (2-5)
and read just after it.

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
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:122
EDGE_AGREEMENT = 0.999  # examples/field_segmentation.py:37
MIN_PURITY = 0.8  # examples/field_segmentation.py:67
#: NVIDIA's H100 SXM data sheet: HBM3 bytes/s and f32 operations/s outside
#: the tensor cores, both at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
COPY_BYTES = 4 * 1024 ** 3
#: the TPU kernel each CUDA kernel replaces (its ``*_fwd`` entry point)
REPLACES = {"composite": "src/repro/kernels/composite.py:53",
            "grad_mag": "src/repro/kernels/grad_mag.py:63"}
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


# name, [T, H, W, C], images dtype, timed, valid ("random" ~70 % True,
# "none", "one" pixel), misaligned (vector loads off)
GRAD_MAG_CASES = [
    ("main_path", (16, 6144, 6144, 4), "float32", True, "random", False),
    ("bf16", (16, 6144, 6144, 4), "bfloat16", True, "random", False),
    ("ragged_c3", (7, 37, 53, 3), "float32", False, "random", False),
    ("thin_c1", (1, 8, 128, 1), "float32", False, "random", False),
    ("one_row", (3, 1, 40, 2), "float32", False, "random", False),
    ("one_column", (3, 40, 1, 2), "float32", False, "random", False),
    ("c8", (3, 17, 33, 8), "float32", False, "random", False),
    ("misaligned_c4", (4, 16, 24, 4), "float32", False, "random", True),
    ("all_invalid", (3, 8, 8, 2), "float32", False, "none", False),
    ("one_valid_pixel", (3, 8, 8, 4), "float32", False, "one", False),
]


def grad_mag_bound(shape, x_bytes: int):
    """Bytes and operations the function needs, and the least time: each
    image and valid byte read once, both [H, W] f32 outputs written once;
    8C + 8 operations per pixel and timestep."""
    T, H, W, C = shape
    nbytes = T * H * W * (C * x_bytes + 1) + 2 * 4 * H * W
    ops = (8 * C + 8) * T * H * W
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_F32_OPS_PER_S * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def phase_grad_mag(torch, seed: int, copy_rate: float) -> dict:
    from repro_torch.kernels import grad_mag as kgrad
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, timed, valid_mode, misaligned) in enumerate(
            GRAD_MAG_CASES):
        xdt = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 500 + i)
        T, H, W, C = shape
        if misaligned:  # a contiguous view 4 bytes past an aligned base
            base = torch.rand(T * H * W * C + 1, generator=g, device="cuda",
                              dtype=xdt)
            x = base[1:].view(shape)
            check(x.data_ptr() % 16 != 0, "view should be misaligned")
        else:
            x = torch.rand(shape, generator=g, device="cuda", dtype=xdt)
        if valid_mode == "random":
            v = torch.rand((T, H, W), generator=g, device="cuda") < 0.7
        else:
            v = torch.zeros((T, H, W), dtype=torch.bool, device="cuda")
            if valid_mode == "one":
                v[T // 2, H // 2, W // 2] = True
        got_g, got_c = kgrad.grad_mag(x, v)
        want_g, want_c = ref.grad_mag(x, v)
        torch.cuda.synchronize()
        check(got_g.shape == got_c.shape == (H, W)
              and got_g.dtype == got_c.dtype == torch.float32,
              f"grad_mag {name}: shape or dtype")
        check(bool(torch.isfinite(got_g).all()), f"grad_mag {name}: non-finite")
        check(torch.equal(got_c, want_c), f"grad_mag {name}: count not exact")
        tol = GRAD_TOL[xd]
        err = float((got_g - want_g).abs().max())
        torch.testing.assert_close(got_g, want_g, rtol=tol, atol=tol,
                                   msg=f"grad_mag {name}")
        if valid_mode == "none":
            check(float(got_g.abs().max()) == 0.0
                  and float(got_c.abs().max()) == 0.0,
                  f"grad_mag {name}: outputs should be zero")
        if valid_mode == "one":
            sqrt_eps = float(torch.sqrt(torch.tensor(kgrad.EPS)))
            check(float(got_g[H // 2, W // 2]) == sqrt_eps
                  and float(got_g.sum()) == sqrt_eps
                  and float(got_c.sum()) == 1.0,
                  f"grad_mag {name}: want sqrt(eps) at the one pixel")
        del got_g, got_c, want_g, want_c
        case = {"name": name, "shape": list(shape), "images": xd,
                "valid": valid_mode,
                "valid_fraction": float(v.float().mean()),
                "max_abs_err": err, "tol": tol, "count_exact": True}
        if timed:
            nbytes, ops, bound_ms, bound_by = grad_mag_bound(
                shape, x.element_size())
            ms = median_ms(torch, lambda: kgrad.grad_mag(x, v))
            plain_ms = median_ms(torch, lambda: ref.grad_mag(x, v))
            case.update({
                "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "bytes_per_s": nbytes / (ms * 1e-3)})
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "grad_mag", **case})
        del x, v
        torch.cuda.empty_cache()
    return {"phase": "kernels.grad_mag", "cases": len(cases),
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


def synced(torch, fn):
    """fn's result and its seconds on the host clock, from a synchronise to
    a synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t


def tile_breakdown(torch, stack, cfg) -> dict:
    """composite_tile's steps, each timed on the host clock up to a
    synchronise: where a tile's time goes."""
    from functools import partial

    from repro_torch.apps.composite import cloud_score
    from repro_torch.convert import stack_to_device
    from repro_torch.kernels import ops, ref

    timed = partial(synced, torch)
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
            "seconds": time.perf_counter() - t0}, cs, names


CLOUD_BLOBS = 16  # per timestep: ~30 % of a tile under cloud


def field_scene(torch, seed: int, T: int, px: int, bands: int, dev):
    """A [T, px, px, bands] f32 stack made on ``dev`` from a seeded
    generator, with SceneSpec's structure (data/imagery.py) at a size its
    host-side synthesis cannot reach: a mosaic of fields, each with its own
    reflectance per band (rows of fields 64-384 px high, each row cut into
    fields 64-384 px wide), an NIR seasonal swing, sensor noise of sigma
    0.01, and elliptical cloud blobs at 0.7 reflectance, marked invalid.
    Returns (stack, valid [T, px, px] bool, ground-truth field map
    [px, px] int64)."""
    import math

    g = torch.Generator(device=dev).manual_seed(seed)
    n = px // 64 + 1
    row_edges = torch.randint(64, 385, (n,), generator=g, device=dev).cumsum(0)
    rows = torch.searchsorted(row_edges, torch.arange(px, device=dev),
                              right=True)
    col_edges = torch.randint(64, 385, (n, n), generator=g,
                              device=dev).cumsum(1)
    cols = torch.searchsorted(
        col_edges, torch.arange(px, device=dev).expand(n, px).contiguous(),
        right=True)
    truth = rows[:, None] * (n + 1) + cols[rows]
    base = 0.05 + 0.4 * torch.rand((n * (n + 1), bands), generator=g,
                                   device=dev)
    yy = torch.arange(px, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(px, device=dev, dtype=torch.float32)[None, :]
    stack = torch.empty((T, px, px, bands), device=dev)
    valid = torch.empty((T, px, px), dtype=torch.bool, device=dev)
    for t in range(T):
        img = base[truth]
        season = 0.5 + 0.5 * math.sin(2 * math.pi * t / max(2, T))
        img[..., 1] = (img[..., 1] * (0.6 + 0.8 * season)).clamp(0.0, 1.0)
        img += 0.01 * torch.randn(img.shape, generator=g, device=dev)
        cloudy = torch.zeros((px, px), dtype=torch.bool, device=dev)
        blobs = torch.rand((CLOUD_BLOBS, 4), generator=g, device=dev)
        for cy, cx, ry, rx in blobs.tolist():
            ry, rx = (px * (1 / 20 + r * (1 / 8 - 1 / 20)) for r in (ry, rx))
            cloudy |= ((yy - cy * px) / ry) ** 2 + ((xx - cx * px) / rx) ** 2 < 1
        cloud = 0.7 + 0.02 * torch.randn(img.shape, generator=g, device=dev)
        stack[t] = torch.where(cloudy[..., None], cloud, img).clamp_(0.0, 1.0)
        valid[t] = ~cloudy
    return stack, valid, truth


def field_purity(torch, labels, truth, geo) -> float:
    """Mean over the found fields of the share of their pixels that lie in
    their majority ground-truth field (examples/field_segmentation.py:57-67),
    from one joint histogram of (label, truth) on the device."""
    lab = torch.from_numpy(labels).to(truth.device).long()
    fg = lab > 0
    n_truth = int(truth.max()) + 1
    keys, counts = torch.unique(lab[fg] * n_truth + truth[fg],
                                return_counts=True)
    ids, inv = torch.unique(keys // n_truth, return_inverse=True)
    total = torch.zeros_like(ids).index_add_(0, inv, counts)
    best = torch.zeros_like(ids).scatter_reduce_(0, inv, counts, "amax")
    found = torch.tensor([f["properties"]["field_id"] for f in geo["features"]],
                         device=truth.device)
    sel = torch.isin(ids, found)
    check(int(sel.sum()) == len(geo["features"]), "purity: features missing")
    return float((best[sel].double() / total[sel]).mean())


def seg_breakdown(torch, stack, valid, cfg, dev) -> dict:
    """segment_tile's steps, each timed on the host clock up to a
    synchronise: where a segmentation tile's time goes."""
    from functools import partial

    from repro_torch.apps.composite import cloud_score
    from repro_torch.apps.segmentation import (clean_edges,
                                               connected_components,
                                               polygonize)
    from repro_torch.convert import stack_to_device
    from repro_torch.kernels import ops

    timed = partial(synced, torch)
    (imgs, v), h2d_s = timed(lambda: stack_to_device(stack, valid, dev))
    valid_eff, cloud_s = timed(lambda: v & (cloud_score(imgs, cfg) < 0.5))
    (gsum, count), kernel_s = timed(lambda: ops.grad_mag(imgs, valid_eff))
    del imgs, v, valid_eff
    edges, threshold_s = timed(
        lambda: gsum / count.clamp_min(1.0) > cfg.edge_threshold)
    cleaned, clean_s = timed(lambda: clean_edges(edges))
    (labels, iterations), cc_s = timed(lambda: connected_components(~cleaned))
    labels, d2h_s = timed(lambda: labels.cpu().numpy())
    geo, poly_s = timed(lambda: polygonize(labels))
    return {"steps_s": {
                "host_to_device": h2d_s, "cloud_score_and_valid": cloud_s,
                "grad_mag_kernel": kernel_s, "threshold": threshold_s,
                "clean_edges": clean_s, "connected_components": cc_s,
                "device_to_host": d2h_s, "polygonize": poly_s},
            "cc_iterations": iterations, "edges": edges.cpu().numpy(),
            "labels": labels, "geo": geo}


def phase_seg_tile(torch, seed: int, backend, dev, px: int = 0) -> dict:
    from repro_torch.apps.segmentation import segment_tile, temporal_edges
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    px, T = px or cfg.segmentation_tile_px, cfg.temporal_depth
    (stack_t, valid_t, truth), synth_s = synced(
        torch, lambda: field_scene(torch, seed, T, px, cfg.bands, dev))
    cloud_cover = float((~valid_t).float().mean())
    (stack, valid), to_host_s = synced(
        torch, lambda: (stack_t.cpu().numpy(), valid_t.cpu().numpy()))
    del stack_t, valid_t
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    backend.reset_launch_counts()
    t1 = time.perf_counter()
    labels, geo = segment_tile(stack, valid, cfg, device=dev)
    tile_s = time.perf_counter() - t1
    launches = backend.launch_counts()
    check(launches["grad_mag"] == 1, f"segmentation tile: launches {launches}")
    check(labels.dtype == np.int32 and labels.shape == (px, px),
          "segmentation tile: labels dtype or shape")
    check(len(geo["features"]) > 0, "segmentation tile: no fields")

    steps = seg_breakdown(torch, stack, valid, cfg, dev)
    check(steps.pop("labels").tobytes() == labels.tobytes(),
          "segmentation tile: labels differ from the step-by-step chain")
    check(json.dumps(steps.pop("geo")) == json.dumps(geo),
          "segmentation tile: GeoJSON differs from the step-by-step chain")
    edges = steps.pop("edges")
    ref_edges = temporal_edges(stack, valid, cfg, impl="ref", device=dev)
    agreement = float((edges == ref_edges).mean())
    check(agreement > EDGE_AGREEMENT,
          f"segmentation tile: edges agree with impl='ref' on {agreement}")
    purity = field_purity(torch, labels, truth, geo)
    check(purity > MIN_PURITY, f"segmentation tile: purity {purity}")
    return {"phase": "segmentation_tile", "shape": [T, px, px, cfg.bands],
            "launches": launches, "fields_found": len(geo["features"]),
            "fields_true": int(torch.unique(truth).numel()),
            "purity": purity, "edge_agreement": agreement,
            "edges_identical": bool((edges == ref_edges).all()),
            "edge_fraction": float(edges.mean()), "cloud_cover": cloud_cover,
            "synth_s": synth_s, "to_host_s": to_host_s,
            "segment_tile_s": tile_s, "breakdown_s": steps.pop("steps_s"),
            "cc_iterations": steps.pop("cc_iterations"),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0}


def phase_seg_campaign(torch, backend, cs, names, dev) -> dict:
    from repro_torch.apps.segmentation import (run_segmentation_campaign,
                                               segment_to_store)
    from repro_torch.configs.festivus_imagery import DEFAULT as cfg

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    out = run_segmentation_campaign(cs, names, cfg, num_workers=4, device=dev)
    campaign_s = time.perf_counter() - t0
    launches = backend.launch_counts()
    report = out["report"]
    check(report.all_done and out["tiles"] == len(names),
          "segmentation campaign incomplete")
    check(launches["grad_mag"] >= len(names),
          f"segmentation campaign launches {launches}")
    fields = {}
    for n in names:
        single = segment_to_store(cs, n, cfg, out_prefix="fields_single",
                                  device=dev)
        got = cs.open(f"fields/{n}/labels").read_all()
        want = cs.open(f"fields_single/{n}/labels").read_all()
        check(got.dtype == want.dtype == np.int32
              and got.tobytes() == want.tobytes(),
              f"segmentation campaign: labels diverge on {n}")
        check(cs.fs.read(f"{cs.root}/fields/{n}/fields.geojson")
              == cs.fs.read(f"{cs.root}/fields_single/{n}/fields.geojson"),
              f"segmentation campaign: GeoJSON diverges on {n}")
        fields[n] = single["fields"]
    return {"phase": "segmentation_campaign", "tiles": len(names),
            "workers": report.nodes, "launches": launches,
            "byte_identical": True, "fields": fields,
            "queue": report.queue_stats,
            "retried_ops": report.festivus_stats.retried_ops,
            "campaign_s": campaign_s, "seconds": time.perf_counter() - t0}


def kernel_line(name: str, results, tol, launches: int) -> dict:
    """One kernel's entry in the ``kernels`` line: its main-path case's
    times and bound, its f32 cases' largest error."""
    main_case = next(c for c in results if c["name"] == "main_path")
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in results
                           if c["images"] == "float32"),
        "tol": tol["float32"], "shape": main_case["shape"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "copy_bound_ms": main_case["copy_bound_ms"], "library_ms": None}


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
    grad = phase_grad_mag(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in grad.items() if k != "results"})
    tile = phase_tile(torch, args.seed, backend)
    emit(tile)
    campaign, cs, names = phase_campaign(torch, args.seed, backend)
    emit(campaign)
    check(campaign["launches"]["composite"] >= campaign["tiles"],
          f"campaign launches {campaign['launches']}")
    cuda = torch.device("cuda")
    peak = torch.cuda.max_memory_allocated()  # the next phase resets it
    seg_tile = phase_seg_tile(torch, args.seed, backend, cuda)
    emit(seg_tile)
    seg_campaign = phase_seg_campaign(torch, backend, cs, names, cuda)
    emit(seg_campaign)
    del cs

    emit({"kernels": [
        kernel_line("composite", kernels["results"], TOL,
                    tile["launches"]["composite"]
                    + campaign["launches"]["composite"]),
        kernel_line("grad_mag", grad["results"], GRAD_TOL,
                    seg_tile["launches"]["grad_mag"]
                    + seg_campaign["launches"]["grad_mag"])]})
    emit({"max_memory_allocated": max(peak,
                                      torch.cuda.max_memory_allocated())})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
