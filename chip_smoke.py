#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py [--seed N]

Phases, each printing one JSON line with its seconds:

0. device and build: the card's name and power limit from ``nvidia-smi``,
   the matmul precision flags (TF32 and reduced-precision bf16 reductions
   off, stated in the line), the kernels compiled with ``nvcc`` from this
   checkout's sources (registers and spills; the tensor-core instructions
   of each bf16 LM kernel in its SASS, which must not be 0), and the rate
   of a 4 GiB device-to-device copy;
1. every kernel (``composite``, ``grad_mag``, ``flash_attention``,
   ``ssd_scan``) against its plain PyTorch version on the card, at the main
   path's shapes and at ragged ones, with the tolerance stated (and, for
   attention and the SSD, a relative L2 limit as well); the main path's
   cases, and every attention and SSD case, are timed with CUDA events
   (median of 10; the prefill_32k attention and SSD layers, median of 3),
   beside their bound and, for bf16 attention at Sq == Sk, PyTorch's
   ``scaled_dot_product_attention`` on the same inputs (no single PyTorch
   call computes the SSD);
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
6. llama3-8b prefill at full width and depth (bf16 weights drawn on the
   card from ``--seed``): ``make_prefill`` answers 4 requests of 2048
   tokens; 32 ``flash_attention`` launches; logits held against the same
   model with ``attention_impl="chunked"`` (the plain version); one more
   prefill that holds each layer's kernel output against
   ``ref.attention_chunked`` on that layer's own q, k and v
   (``flash_layers``); a profiler breakdown of one prefill by kernel;
7. llama3-8b generation: ``greedy_generate`` for 4 requests of 64 prompt
   tokens and 32 new ones, twice (the tokens must be identical), and the
   prompt's decode-path logits against ``make_prefill`` on the same prompt
   (tests/test_models.py:115-126's criterion); a profiler breakdown of one
   decode step;
8. mamba2-2.7b prefill at full width and depth, as phase 6: 64
   ``ssd_scan`` launches; logits held against the same model with the SSD's
   chunked plain version (``ssd_impl="chunked"``), and one more prefill
   that holds each layer's kernel output against the plain version on that
   layer's own inputs;
9. mamba2-2.7b generation, as phase 7, with the decode check in f32
   activations: no ``ssd_scan`` launch in decode (the decode path has no
   kernel), 64 in the check's prefill;
10. summary: the ``kernels`` line, the peak device memory, the
    ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

The launch counts are set to 0 just before each main-path run (phases 2-9)
and read just after it.

Any mismatch raises and the script exits nonzero.  Without CUDA, or run
from a directory that holds nothing else of the repository, it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
TOL = {"float32": 3e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:45-47
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:122
#: flash attention's output against its plain version, relative L2 over the
#: whole case: in bf16 a few ulps of the output's rounding, in f32 a few
#: hundred f32 ulps.  The elementwise TOL alone is looser than a typical
#: output at long Sk (random scores spread the softmax over ~Sk/e keys)
FLASH_REL_L2 = {"float32": 1e-5, "bfloat16": 5e-3}
EDGE_AGREEMENT = 0.999  # examples/field_segmentation.py:37
MIN_PURITY = 0.8  # examples/field_segmentation.py:67
#: NVIDIA's H100 SXM data sheet: HBM3 bytes/s and f32 operations/s outside
#: the tensor cores, both at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
#: the same data sheet: dense bf16 operations/s on the tensor cores
PEAK_BF16_OPS_PER_S = 989e12
COPY_BYTES = 4 * 1024 ** 3
#: the TPU kernel each CUDA kernel replaces (its ``*_fwd`` entry point)
REPLACES = {"composite": "src/repro/kernels/composite.py:53",
            "grad_mag": "src/repro/kernels/grad_mag.py:63",
            "flash_attention": "src/repro/kernels/flash_attention.py:93",
            "ssd_scan": "src/repro/kernels/ssd_scan.py:75"}
TIMED_RUNS = 10
LLAMA = "llama3-8b"
MAMBA = "mamba2-2.7b"
PREFILL_BATCH, PREFILL_LEN = 4, 2048
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 64, 32
#: the kernel's logits against the plain run's, relative L2 over [4, 2048, V]
PREFILL_REL_L2 = 2e-2
#: the same for mamba2-2.7b's 64 bf16 layers, where the SSD's two plain
#: versions are themselves 5.6e-2 apart (PERF.md §6); its kernel is held
#: layer by layer to SSD_TOL and SSD_REL_L2 instead (ssd_layers)
MAMBA_PREFILL_REL_L2 = 1e-1
#: decode path against prefill: tests/test_models.py:115-126
DECODE_AGREEMENT, DECODE_RTOL, DECODE_ATOL = 0.9, 0.15, 0.3


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


def ptxas_resources(log: str) -> dict:
    """nvcc's ``--resource-usage`` report: each kernel's (mangled) name ->
    its registers and spill lines."""
    out, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for", 1)[1].strip()
        elif name and ("registers" in line or "spill" in line):
            out.setdefault(name, []).append(
                line.replace("ptxas info    :", "").strip())
    return out


def kernel_label(mangled: str) -> str:
    """``..._flash_attention_kernel_bf16ILi128EEEv...`` ->
    ``flash_attention_kernel_bf16<Li128>``: enough to tell the
    instantiations apart."""
    pos = mangled.find("_ZN") + 3
    while 2 < pos < len(mangled):
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        start = pos + len(m[0])
        pos = start + int(m[0])
        name = mangled[start:pos]
        if "kernel" in name:
            args = re.match(r"I(.*?)EE", mangled[pos:])
            return f"{name}<{args[1]}>" if args else name
    return mangled


def tensor_core_instructions(build, source: str):
    """Each kernel of ``csrc/<source>.cu``'s library -> its count of
    tensor-core instructions (HMMA from ``mma.sync``, HGMMA from ``wgmma``)
    in the SASS, read with the toolkit's ``cuobjdump``; None where the
    toolkit has no ``cuobjdump``."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    if not tool.is_file():
        return None
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(source))],
                          check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_label(line.split("Function :", 1)[1].strip())
            counts[name] = 0
        elif name and re.search(r"\bHG?MMA\.", line):
            counts[name] += 1
    return counts


def phase_device(torch, build) -> dict:
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    built = build.build()
    resources = {kernel_label(name): lines for info in built.values()
                 for name, lines in ptxas_resources(info["log"]).items()}
    for source, symbol in KERNEL_SYMBOLS.items():
        if source in built:  # the profiler groups every kernel of a source
            names = [n for n, lines in
                     ptxas_resources(built[source]["log"]).items()
                     if any("registers" in line for line in lines)]
            check(bool(names) and all(symbol in n for n in names),
                  f"{source}.cu: a kernel name lacks {symbol!r}: "
                  f"{sorted(names)}")
    # every bf16 kernel of the LM sources runs its products on the tensor
    # cores (the SSD's c.b kernel is bf16 only)
    tensor_ops = {s: tensor_core_instructions(build, s)
                  for s in ("flash_attention", "ssd_scan")}
    for source, counts in tensor_ops.items():
        bf16 = {n: k for n, k in (counts or {}).items()
                if "bf16" in n or "_cb" in n}
        check(counts is None or (bool(bf16) and all(bf16.values())),
              f"{source}.cu: a bf16 kernel has no HMMA/HGMMA: {counts}")
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = median_ms(torch, lambda: dst.copy_(src))
    del src, dst
    torch.cuda.empty_cache()
    copy_rate = 2 * COPY_BYTES / (copy_ms * 1e-3)  # read + write
    return {"phase": "device", "nvidia_smi": smi,
            "kind": torch.cuda.get_device_name(0),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
            "bf16_reduced_precision_reduction":
                torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            "built": {n: round(i["seconds"], 3) for n, i in built.items()},
            "ptxas": resources, "tensor_core_instructions": tensor_ops,
            "copy_gib": COPY_BYTES / 1024 ** 3,
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


# name, (B, Hq, Hkv, Sq, Sk, D), causal, dtype, timed runs, q and k as
# transposed [B, S, H, D] views (v always is one).  The main path is one
# llama3-8b layer of phase 6's prefill; the 32k layer is
# SHAPES["prefill_32k"] for one request; then tests/test_kernels.py:53-60
# in f32 and bf16, ragged lengths, and bf16 cases across the tensor-core
# kernel's tile edges (128 query rows; 128 keys, 64 at D = 256).
FLASH_CASES = [
    ("main_path", (4, 32, 8, 2048, 2048, 128), True, "bfloat16", TIMED_RUNS,
     False),
    ("prefill_32k_layer", (1, 32, 8, 32768, 32768, 128), True, "bfloat16", 3,
     False),
    *[(f"{name}_{dt}", shape, causal, dt, TIMED_RUNS, False)
      for dt in ("float32", "bfloat16")
      for name, shape, causal in [
          ("gqa2", (2, 4, 2, 128, 128, 64), True),
          ("mha_d128", (1, 8, 8, 256, 256, 128), True),
          ("gqa4_sk_gt_sq", (1, 4, 1, 128, 384, 64), True),
          ("bidirectional_d32", (2, 2, 2, 128, 128, 32), False),
          ("gemma_d256", (1, 16, 2, 64, 64, 256), True),
          ("ragged_1000", (1, 4, 2, 1000, 1000, 128), True),
          ("one_row_sk777", (3, 5, 5, 1, 777, 64), True),
          ("odd_heads", (3, 7, 7, 129, 129, 64), True)]],
    ("gemma_d256_ragged_1000", (1, 16, 2, 1000, 1000, 256), True, "bfloat16",
     TIMED_RUNS, False),
    ("sq_lt_sk_200_328", (2, 32, 8, 200, 328, 128), True, "bfloat16",
     TIMED_RUNS, False),
    *[(f"qk_transposed_{dt}", (2, 8, 2, 300, 300, 64), True, dt, TIMED_RUNS,
       True) for dt in ("float32", "bfloat16")],
]


def flash_bound(shape, causal: bool, x_bytes: int):
    """Operations and bytes the function needs, and the least time: the
    scores and the weighted sum, 4·D FLOP per visible (query, key) pair
    (query i sees min(Sk, i + 1 + Sk - Sq) keys when causal), at the
    inputs' type's peak; q, k, v read once and the output written once."""
    B, Hq, Hkv, Sq, Sk, D = shape
    seen = Sq * (Sk - Sq) + Sq * (Sq + 1) // 2 if causal else Sq * Sk
    ops = 4 * D * B * Hq * seen
    nbytes = x_bytes * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D)
    peak = PEAK_BF16_OPS_PER_S if x_bytes == 2 else PEAK_F32_OPS_PER_S
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def sdpa_ms(torch, q, k, v, causal: bool, runs: int) -> float:
    """PyTorch's ``scaled_dot_product_attention(..., enable_gqa=True)`` on
    the same inputs, a yardstick only (the port never calls it), at
    Sq == Sk, where its causal mask (top-left aligned) is the kernel's.  It
    may pick among PyTorch's fused backends (cuDNN, flash) as it does by
    default, but not fall back to one that materialises the [Sq, Sk]
    scores."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION,
                      SDPBackend.FLASH_ATTENTION]):
        return median_ms(
            torch, lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True),
            runs=runs, warmup=1)


def rel_l2(torch, got, want) -> float:
    """Relative L2 distance of two tensors, in f64 over f32 values."""
    diff = got.float() - want.float()
    return float(torch.linalg.vector_norm(diff, dtype=torch.float64)
                 / torch.linalg.vector_norm(want.float(), dtype=torch.float64))


def phase_flash(torch, seed: int, copy_rate: float) -> dict:
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.kernels import ref

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, causal, xd, runs, qk_t) in enumerate(FLASH_CASES):
        dtype = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 800 + i)
        B, Hq, Hkv, Sq, Sk, D = shape

        def draw(heads, seq, transposed):
            if transposed:  # as the attention layer hands it over
                return torch.randn((B, seq, heads, D), generator=g,
                                   device="cuda", dtype=dtype).transpose(1, 2)
            return torch.randn((B, heads, seq, D), generator=g,
                               device="cuda", dtype=dtype)

        q = draw(Hq, Sq, qk_t)
        k = draw(Hkv, Sk, qk_t)
        v = draw(Hkv, Sk, True)
        # the plain version ops.flash_attention takes on CPU tensors
        plain = ref.attention_chunked if Sq >= 1024 else ref.attention
        got = kflash.flash_attention(q, k, v, causal=causal)
        want = plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (B, Hq, Sq, D) and got.dtype == dtype
              and got.is_contiguous(), f"flash {name}: shape or dtype")
        check(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
        tol = TOL[xd]
        err = float((got.float() - want.float()).abs().max())
        l2 = rel_l2(torch, got, want)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"flash_attention {name}")
        check(l2 < FLASH_REL_L2[xd],
              f"flash {name}: relative L2 {l2} >= {FLASH_REL_L2[xd]}")
        del got, want
        nbytes, ops, bound_ms, bound_by = flash_bound(
            shape, causal, q.element_size())
        ms = median_ms(torch, lambda: kflash.flash_attention(
            q, k, v, causal=causal), runs=runs, warmup=1)
        plain_ms = median_ms(torch, lambda: plain(q, k, v, causal=causal),
                             runs=runs, warmup=1)
        # SDPA's fused backends take bf16, and its causal mask is the
        # kernel's only at Sq == Sk
        library_ms = (sdpa_ms(torch, q, k, v, causal, runs)
                      if Sq == Sk and xd == "bfloat16" else None)
        case = {"name": name, "shape": [B, Hq, Hkv, Sq, Sk, D],
                "causal": causal, "dtype": xd, "qk_transposed": qk_t,
                "max_abs_err": err,
                "tol": tol, "rel_l2": l2, "rel_l2_limit": FLASH_REL_L2[xd],
                "runs": runs, "ms": ms, "plain_ms": plain_ms,
                "plain": plain.__name__, "library_ms": library_ms,
                "bytes": nbytes, "operations": ops, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "flop_per_s": ops / (ms * 1e-3)}
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "flash_attention", **case})
        del q, k, v
        torch.cuda.empty_cache()
    return {"phase": "kernels.flash_attention", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


# name, (B, L, H, P, N), dtype, b and c one group expanded to every head
# (stride 0), D-skip, inputs ("model": a = -(1..H) and dt from the init's
# dt_bias, as in a mamba2 layer; "normal": tests/test_kernels.py:146-149;
# "strong": a = -e^3 and dt in [1, 5]), timed runs.  The main path is one
# mamba2-2.7b layer of the mamba_prefill phase; the 32k layer is
# SHAPES["prefill_32k"] for one request; then tests/test_kernels.py:137-141
# in f32 and bf16, ragged lengths, contiguous b and c, a strongly decaying
# head.
SSD_CASES = [
    ("main_path", (4, 2048, 80, 64, 128), "bfloat16", True, True, "model",
     TIMED_RUNS),
    ("prefill_32k_layer", (1, 32768, 80, 64, 128), "bfloat16", True, True,
     "model", 3),
    *[(f"{name}_{dt}", shape, dt, False, skip, "normal", TIMED_RUNS)
      for dt in ("float32", "bfloat16")
      for name, shape, skip in [
          ("p16_n8", (2, 128, 4, 16, 8), False),
          ("p32_n16", (1, 256, 8, 32, 16), True),
          ("p64_n128", (2, 64, 2, 64, 128), True)]],
    ("ragged_1", (1, 1, 3, 64, 128), "float32", True, True, "normal",
     TIMED_RUNS),
    ("ragged_63", (2, 63, 4, 32, 16), "float32", True, True, "normal",
     TIMED_RUNS),
    ("ragged_1000", (1, 1000, 2, 64, 128), "float32", True, True, "normal",
     TIMED_RUNS),
    ("contiguous_bc", (4, 512, 80, 64, 128), "bfloat16", False, True,
     "model", TIMED_RUNS),
    ("strong_decay", (1, 2048, 4, 64, 128), "float32", True, True, "strong",
     TIMED_RUNS),
]
#: the SSD kernel's output against its plain version, relative L2 over the
#: whole case: in bf16 the output's rounding on a few elements, in f32 the
#: sum orders and the cumulative sums' rounding inside exp()
SSD_REL_L2 = {"float32": 1e-4, "bfloat16": 5e-3}
#: the elementwise tolerances: tests/test_kernels.py:150 and bf16's
SSD_TOL = {"float32": 5e-4, "bfloat16": 2e-2}
#: the plain version chunked at the TPU kernel's chunk, where it divides L;
#: the operations are counted at the same chunk
SSD_CHUNK = 128


def ssd_inputs(torch, shape, dtype, grouped: bool, skip: bool, kind: str,
               g):
    """x, dt, a, b, c, d on the card (see SSD_CASES)."""
    import math

    B, L, H, P, N = shape
    F = torch.nn.functional
    x = torch.randn((B, L, H, P), generator=g, device="cuda", dtype=dtype)
    if kind == "model":
        a = -torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
        u = torch.rand((H,), generator=g, device="cuda")
        dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
        dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
        dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda")
                        + dt_bias)
    else:
        dt = F.softplus(torch.randn((B, L, H), generator=g, device="cuda"))
        a = -torch.exp(torch.randn((H,), generator=g, device="cuda"))
        if kind == "strong":
            a = torch.full_like(a, -math.exp(3.0))
            dt = 1.0 + 4.0 * torch.rand((B, L, H), generator=g,
                                        device="cuda")
    heads = 1 if grouped else H
    b = torch.randn((B, L, heads, N), generator=g, device="cuda", dtype=dtype)
    c = torch.randn((B, L, heads, N), generator=g, device="cuda", dtype=dtype)
    d = (torch.randn((H,), generator=g, device="cuda") if kind == "normal"
         else torch.ones((H,), device="cuda")) if skip else None
    return x, dt, a, b.expand(B, L, H, N), c.expand(B, L, H, N), d


def ssd_bound(shape, x_bytes: int, grouped: bool):
    """Bytes and operations the function needs, and the least time: x, dt,
    a, d and the distinct elements of b and c (one group's when they are
    expanded) read once, y written once; the operations of the chunked
    algorithm at Q = 128 over the causal pairs only: per head, W x on the
    q(q+1)/2 pairs j <= i, then c S and the state update, q(q+1)P + 4qNP a
    chunk of q tokens; c.b once per group (one when b and c are shared by
    every head), q(q+1)N a chunk; at the inputs' type's peak."""
    B, L, H, P, N = shape
    groups = 1 if grouped else H
    bc = 2 * B * L * N * groups * x_bytes
    nbytes = 2 * B * L * H * P * x_bytes + B * L * H * 4 + 2 * H * 4 + bc
    ops = 0
    for q0 in range(0, L, SSD_CHUNK):
        q = min(SSD_CHUNK, L - q0)
        ops += H * (q * (q + 1) * P + 4 * q * N * P) + groups * q * (q + 1) * N
    ops *= B
    peak = PEAK_BF16_OPS_PER_S if x_bytes == 2 else PEAK_F32_OPS_PER_S
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / peak * 1e3
    return nbytes, ops, max(bytes_ms, ops_ms), (
        "bytes" if bytes_ms >= ops_ms else "operations")


def phase_ssd(torch, seed: int, copy_rate: float) -> dict:
    from functools import partial

    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as kssd

    t0 = time.perf_counter()
    cases = []
    for i, (name, shape, xd, grouped, skip, kind, runs) in enumerate(
            SSD_CASES):
        dtype = getattr(torch, xd)
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + 900 + i)
        x, dt, a, b, c, d = ssd_inputs(torch, shape, dtype, grouped, skip,
                                       kind, g)
        check(grouped == (b.stride(2) == 0), f"ssd {name}: b's head stride")
        B, L, H, P, N = shape
        # the sequential recurrence at small L, chunked at the long ones
        plain = (partial(ref.ssd_scan_chunked, chunk=SSD_CHUNK)
                 if L >= 2048 else ref.ssd_scan)
        got = kssd.ssd_scan(x, dt, a, b, c, d_skip=d)
        want = plain(x, dt, a, b, c, d_skip=d)
        torch.cuda.synchronize()
        check(tuple(got.shape) == (B, L, H, P) and got.dtype == dtype
              and got.is_contiguous(), f"ssd {name}: shape or dtype")
        check(bool(torch.isfinite(got).all()), f"ssd {name}: non-finite")
        tol = SSD_TOL[xd]
        err = float((got.float() - want.float()).abs().max())
        l2 = rel_l2(torch, got, want)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol, msg=f"ssd_scan {name}")
        check(l2 < SSD_REL_L2[xd],
              f"ssd {name}: relative L2 {l2} >= {SSD_REL_L2[xd]}")
        del got, want
        nbytes, ops, bound_ms, bound_by = ssd_bound(shape, x.element_size(),
                                                    grouped)
        ms = median_ms(torch, lambda: kssd.ssd_scan(x, dt, a, b, c, d_skip=d),
                       runs=runs, warmup=1)
        plain_ms = median_ms(torch, lambda: plain(x, dt, a, b, c, d_skip=d),
                             runs=runs, warmup=1)
        case = {"name": name, "shape": [B, L, H, P, N], "dtype": xd,
                "b_c_head_stride": b.stride(2), "d_skip": skip,
                "inputs": kind, "max_abs_err": err, "tol": tol,
                "rel_l2": l2, "rel_l2_limit": SSD_REL_L2[xd], "runs": runs,
                "ms": ms, "plain_ms": plain_ms,
                "plain": getattr(plain, "func", plain).__name__,
                "library_ms": None, "bytes": nbytes, "operations": ops,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "copy_bound_ms": nbytes / copy_rate * 1e3,
                "flop_per_s": ops / (ms * 1e-3)}
        cases.append(case)
        emit({"phase": "kernels.case", "kernel": "ssd_scan", **case})
        del x, dt, a, b, c, d
        torch.cuda.empty_cache()
    return {"phase": "kernels.ssd_scan", "cases": len(cases),
            "seconds": time.perf_counter() - t0, "results": cases}


#: kernel group (and source, csrc/<group>.cu) -> a substring of the name of
#: every CUDA kernel in that source (checked in phase 0): the SSD's c.b
#: kernel and scan both fall in the ssd_scan group
KERNEL_SYMBOLS = {"flash_attention": "flash_attention_kernel",
                  "ssd_scan": "ssd_scan_kernel"}


def profile_breakdown(torch, fn, runs: int = 3,
                      kernel: str = "flash_attention") -> dict:
    """Device time of ``runs`` calls of ``fn`` by kernel group, from a
    ``torch.profiler`` trace: the port's ``kernel``, matmuls (cuBLAS), and
    the rest; the device's idle share between the window's first kernel
    start and last kernel end; the five kernels that take the most time.  A
    trace with no device events reports ``device_events: 0``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t
    groups = {kernel: 0.0, "matmul": 0.0, "other": 0.0}
    by_name: dict = {}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        low = e.name.lower()
        if KERNEL_SYMBOLS[kernel] in e.name:
            group = kernel
        elif any(w in low for w in ("gemm", "nvjet", "xmma", "cutlass")):
            group = "matmul"
        else:
            group = "other"
        groups[group] += us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    out = {"runs": runs, "wall_ms_per_run": wall_s / runs * 1e3,
           "device_events": len(spans)}
    if not spans:
        return out
    spans.sort()
    busy, cur_start, cur_end = 0.0, spans[0][0], spans[0][1]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out.update({
        "kernels_per_run": len(spans) / runs,
        "device_ms_per_run": {k: v / runs / 1e3 for k, v in groups.items()},
        "busy_ms_per_run": busy / runs / 1e3,
        "idle_share": 1.0 - busy / window,
        "top_kernels_ms_per_run": {n[:80]: v / runs / 1e3 for n, v in top}})
    return out


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


def param_leaves(params):
    if isinstance(params, dict):
        for v in params.values():
            yield from param_leaves(v)
    elif isinstance(params, list):
        for v in params:
            yield from param_leaves(v)
    else:
        yield params


def logits_diff(torch, got, want, rows: int = 256) -> dict:
    """Relative L2 error, max abs difference and argmax agreement of two
    [B, S, V] logits tensors, in f32 a slice of ``rows`` positions at a
    time (the full logits are 2.1 GB in bf16)."""
    num = den = max_abs = 0.0
    agree = 0
    B, S, _ = got.shape
    for b in range(B):
        for s0 in range(0, S, rows):
            a = got[b, s0:s0 + rows].float()
            w = want[b, s0:s0 + rows].float()
            d = a - w
            num += float((d * d).sum(dtype=torch.float64))
            den += float((w * w).sum(dtype=torch.float64))
            max_abs = max(max_abs, float(d.abs().max()))
            agree += int((a.argmax(-1) == w.argmax(-1)).sum())
    return {"rel_l2": (num / den) ** 0.5, "max_abs_diff": max_abs,
            "argmax_agreement": agree / (B * S)}


def plain_llama_prefill(model, params, tokens):
    """The same llama weights with attention_impl="chunked" (the flash
    kernel's plain version)."""
    from repro_torch.models import build
    from repro_torch.train import make_prefill

    plain = make_prefill(build(dataclasses.replace(
        model.cfg, attention_impl="chunked")))
    return plain(params, tokens=tokens)


def plain_mamba_prefill(model, params, tokens):
    """The same mamba weights with the SSD's chunked plain version."""
    from repro_torch.train import make_prefill

    return make_prefill(model)(params, tokens=tokens, ssd_impl="chunked")


# phase name -> (arch, its kernel, the plain run, the prefill logits'
# relative L2 limit against the plain run, the activations' dtype of the
# decode-against-prefill check: None for the model's own).  mamba2-2.7b's
# 64 bf16 layers amplify one-ulp differences past PREFILL_REL_L2 and the
# decode criterion, whatever the SSD's implementation: see PERF.md §6 for
# tools/depth_spread.py's readings and the chip's.  So its kernel is held
# layer by layer on the bf16 serving run (ssd_layers), its logits to
# MAMBA_PREFILL_REL_L2, and its decode check runs with f32 activations over
# the same bf16-stored weights.  Both kernels are held layer by layer
# (LAYER_HOLDS): the bf16 tensor-core flash kernel rounds P to bf16, so its
# depth error is read per layer as well as in the logits.
LM_PHASES = {
    "llama": (LLAMA, "flash_attention", plain_llama_prefill, PREFILL_REL_L2,
              None),
    "mamba": (MAMBA, "ssd_scan", plain_mamba_prefill, MAMBA_PREFILL_REL_L2,
              "float32")}


def held_layers(torch, model, params, tokens, op: str, plain, tol,
                l2_limit) -> dict:
    """One bf16 prefill with each layer's kernel held: ``ops.<op>`` against
    ``plain`` on that layer's own inputs, within ``tol`` elementwise and
    ``l2_limit`` relative L2.  Returns the largest and median errors over
    the layers."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill

    kernel = getattr(ops, op)
    errs, l2s = [], []

    def held(*args, impl="auto", chunk=None, **kw):
        check(impl == "auto" and args[0].is_cuda, f"{op} layers: impl {impl}")
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        xd = str(got.dtype).removeprefix("torch.")
        layer = len(errs)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol[xd],
                                   atol=tol[xd], msg=f"{op}, layer {layer}")
        errs.append(float((got.float() - want.float()).abs().max()))
        l2s.append(rel_l2(torch, got, want))
        check(l2s[-1] < l2_limit[xd], f"{op}, layer {layer}: relative L2 "
              f"{l2s[-1]} >= {l2_limit[xd]}")
        return got

    setattr(ops, op, held)
    try:
        make_prefill(model)(params, tokens=tokens)
    finally:
        setattr(ops, op, kernel)
    check(len(errs) == model.cfg.num_layers, f"{op} layers: {len(errs)}")
    return {"layers": len(errs), "max_abs_err": max(errs),
            "median_abs_err": statistics.median(errs),
            "max_rel_l2": max(l2s), "median_rel_l2": statistics.median(l2s),
            "tol": tol["bfloat16"], "rel_l2_limit": l2_limit["bfloat16"]}


def plain_ssd(x, dt, a, b, c, *, d_skip=None):
    from repro_torch.kernels import ref

    return ref.ssd_scan_chunked(x, dt, a, b, c, chunk=SSD_CHUNK,
                                d_skip=d_skip)


def plain_attention(q, k, v, causal=True):
    from repro_torch.kernels import ref

    return ref.attention_chunked(q, k, v, causal=causal)


# kernel -> (its line's key, its ops entry point, the plain version, the
# elementwise and relative-L2 limits) for the per-layer hold
LAYER_HOLDS = {
    "flash_attention": ("flash_layers", "flash_attention", plain_attention,
                        TOL, FLASH_REL_L2),
    "ssd_scan": ("ssd_layers", "ssd", plain_ssd, SSD_TOL, SSD_REL_L2)}


def phase_prefill(torch, seed: int, backend, which: str):
    """An LM at full width and depth: 4 requests of 2048 tokens through
    ``make_prefill``, one kernel launch a layer, logits held against the
    plain run.  Returns (line, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    from repro_torch.models.model_zoo import padded_vocab
    from repro_torch.train import make_prefill

    arch, kernel, plain_prefill, limit, _ = LM_PHASES[which]
    t0 = time.perf_counter()
    cfg = get_config(arch)
    check(cfg.dtype == "bfloat16" and cfg.attention_impl == "auto",
          f"{arch}: dtype {cfg.dtype}, attention_impl {cfg.attention_impl}")
    model = build(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s = synced(torch, lambda: model.init(seed))
    leaves = list(param_leaves(params))
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(all(t.is_cuda for t in leaves), f"{arch}: params off the card")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN),
                           generator=g, device="cuda")
    prefill = make_prefill(model)
    _, first_s = synced(torch, lambda: prefill(params, tokens=tokens))
    backend.reset_launch_counts()
    logits, prefill_s = synced(torch, lambda: prefill(params, tokens=tokens))
    launches = backend.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches[kernel] == cfg.num_layers,
          f"{which} prefill: launches {launches}")
    check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_LEN,
                                  padded_vocab(cfg))
          and logits.dtype == torch.bfloat16, f"{which} prefill: logits shape")
    check(bool(torch.isfinite(logits).all()), f"{which} prefill: non-finite")
    repeat_s = [synced(torch, lambda: prefill(params, tokens=tokens))[1]
                for _ in range(2)]

    want, plain_s = synced(torch, lambda: plain_prefill(model, params,
                                                        tokens))
    diff = logits_diff(torch, logits, want)
    check(diff["rel_l2"] < limit, f"{which} prefill: relative L2 "
          f"{diff['rel_l2']} against the plain run")
    del want, logits
    torch.cuda.empty_cache()
    key, op, plain, tol, l2_limit = LAYER_HOLDS[kernel]
    extra = {key: held_layers(torch, model, params, tokens, op, plain, tol,
                              l2_limit)}
    breakdown = profile_breakdown(torch, lambda: prefill(params,
                                                         tokens=tokens),
                                  kernel=kernel)
    tokens_n = PREFILL_BATCH * PREFILL_LEN
    return {"phase": f"{which}_prefill", "arch": arch, "kernel": kernel,
            "requests": PREFILL_BATCH, "tokens_each": PREFILL_LEN,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "params": n_params, "param_bytes": param_bytes,
            "init_s": init_s, "first_prefill_s": first_s,
            "prefill_s": prefill_s, "repeat_prefill_s": repeat_s,
            "tokens_per_s": tokens_n / prefill_s, "launches": launches,
            "plain_prefill_s": plain_s, "vs_plain": diff,
            "rel_l2_limit": limit, **extra,
            "peak_device_bytes": peak,
            "breakdown": breakdown,
            "seconds": time.perf_counter() - t0}, model, params


def phase_generate(torch, seed: int, backend, model, params,
                   which: str) -> dict:
    """greedy_generate twice on the same prompts, then the prompts' decode
    logits against make_prefill's.  The decode path launches no kernel (the
    JAX package has no decode kernel); the check's prefill launches one a
    layer."""
    from repro_torch.train import (greedy_generate, make_decode_step,
                                   make_prefill)

    from repro_torch.models import build

    arch, kernel, _, _, check_dtype = LM_PHASES[which]
    t0 = time.perf_counter()
    cfg = model.cfg
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    prompt = torch.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT),
                           generator=g, device="cuda", dtype=torch.int32)
    max_len = GEN_PROMPT + GEN_NEW + 1

    def generate():
        return greedy_generate(model, params, prompt, GEN_NEW, max_len=max_len)

    backend.reset_launch_counts()
    out, gen_s = synced(torch, generate)
    gen_launches = backend.launch_counts()
    again, again_s = synced(torch, generate)
    check(tuple(out.shape) == (GEN_BATCH, GEN_NEW) and out.dtype == torch.int32,
          "generate: tokens shape or dtype")
    check(0 <= int(out.min()) and int(out.max()) < cfg.vocab_size,
          "generate: token outside the vocabulary")
    check(torch.equal(out, again), "generate: two runs differ")
    check(gen_launches[kernel] == 0,
          f"{which} generate: decode launched {gen_launches}")
    steps = GEN_PROMPT + GEN_NEW

    checked = model if check_dtype is None else build(
        dataclasses.replace(cfg, dtype=check_dtype))
    step = make_decode_step(checked)
    state = checked.init_decode(params, GEN_BATCH, max_len)
    outs = []
    for t in range(GEN_PROMPT):
        state, logits = step(params, state, prompt[:, t:t + 1])
        outs.append(logits)
    decoded = torch.cat(outs, dim=1)
    backend.reset_launch_counts()
    full = make_prefill(checked)(params, tokens=prompt)
    torch.cuda.synchronize()
    prefill_launches = backend.launch_counts()
    check(prefill_launches[kernel] == cfg.num_layers,
          f"{which} generate: prefill launches {prefill_launches}")
    diff = logits_diff(torch, decoded, full)
    check(diff["argmax_agreement"] > DECODE_AGREEMENT,
          f"decode/prefill argmax agreement {diff['argmax_agreement']}")
    torch.testing.assert_close(decoded.float(), full.float(),
                               rtol=DECODE_RTOL, atol=DECODE_ATOL,
                               msg="decode path against prefill")
    del decoded, full
    step = make_decode_step(model)
    state = model.init_decode(params, GEN_BATCH, max_len)
    for t in range(GEN_PROMPT):
        state, _ = step(params, state, prompt[:, t:t + 1])
    token = prompt[:, -1:]
    breakdown = profile_breakdown(
        torch, lambda: step(params, list(state), token), kernel=kernel)
    return {"phase": f"{which}_generate", "arch": arch, "requests": GEN_BATCH,
            "prompt_tokens": GEN_PROMPT, "new_tokens": GEN_NEW,
            "decode_steps": steps, "generate_s": gen_s,
            "repeat_generate_s": again_s, "step_ms": gen_s / steps * 1e3,
            "new_tokens_per_s": GEN_BATCH * GEN_NEW / gen_s,
            "decode_tokens_per_s": GEN_BATCH * steps / gen_s,
            "identical_twice": True, "generated": out[0].tolist(),
            "launches": gen_launches,
            "prefill_check_launches": prefill_launches,
            "decode_vs_prefill": diff,
            "criterion": {"argmax_agreement": DECODE_AGREEMENT,
                          "rtol": DECODE_RTOL, "atol": DECODE_ATOL},
            "checked_in": str(checked.cfg.dtype),
            "decode_step_breakdown": breakdown,
            "seconds": time.perf_counter() - t0}


def kernel_line(name: str, results, tol, launches: int) -> dict:
    """One kernel's entry in the ``kernels`` line: its main-path case's
    times and bound, its f32 cases' largest error."""
    main_case = next(c for c in results if c["name"] == "main_path")
    return {
        "name": name, "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": REPLACES[name], "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in results
                           if c.get("images", c.get("dtype")) == "float32"),
        "tol": tol["float32"], "shape": main_case["shape"],
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": main_case["bound_by"],
        "copy_bound_ms": main_case["copy_bound_ms"],
        "library_ms": main_case["library_ms"]}


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

    # full-precision matmuls: no TF32 for f32 (the plain versions are the
    # f32 references), no reduced-precision reductions inside bf16 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    device = phase_device(torch, build)
    emit(device)
    kernels = phase_kernels(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in kernels.items() if k != "results"})
    grad = phase_grad_mag(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in grad.items() if k != "results"})
    flash = phase_flash(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in flash.items() if k != "results"})
    ssd = phase_ssd(torch, args.seed, device["copy_bytes_per_s"])
    emit({k: v for k, v in ssd.items() if k != "results"})
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
    peak = max(peak, torch.cuda.max_memory_allocated())
    prefill, model, params = phase_prefill(torch, args.seed, backend, "llama")
    emit(prefill)
    generate = phase_generate(torch, args.seed, backend, model, params,
                              "llama")
    emit(generate)
    del model, params
    torch.cuda.empty_cache()
    peak = max(peak, torch.cuda.max_memory_allocated())  # reset next
    m_prefill, model, params = phase_prefill(torch, args.seed, backend,
                                             "mamba")
    emit(m_prefill)
    m_generate = phase_generate(torch, args.seed, backend, model, params,
                                "mamba")
    emit(m_generate)
    del model, params

    emit({"kernels": [
        kernel_line("composite", kernels["results"], TOL,
                    tile["launches"]["composite"]
                    + campaign["launches"]["composite"]),
        kernel_line("grad_mag", grad["results"], GRAD_TOL,
                    seg_tile["launches"]["grad_mag"]
                    + seg_campaign["launches"]["grad_mag"]),
        kernel_line("flash_attention", flash["results"], TOL,
                    prefill["launches"]["flash_attention"]
                    + generate["launches"]["flash_attention"]
                    + generate["prefill_check_launches"]["flash_attention"]),
        kernel_line("ssd_scan", ssd["results"], SSD_TOL,
                    m_prefill["launches"]["ssd_scan"]
                    + m_generate["launches"]["ssd_scan"]
                    + m_generate["prefill_check_launches"]["ssd_scan"])]})
    emit({"max_memory_allocated": max(peak,
                                      torch.cuda.max_memory_allocated())})
    print(device["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
