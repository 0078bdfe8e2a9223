"""A kernel of this checkout against another version of its source, on the
card: are the outputs bit-identical, and are the times the same?

    PYTHONPATH=src python tools/kernel_ab.py --kernel NAME --other PATH
        [--rounds 4]

NAME is ``flash_attention`` (the flash forward) or ``ssd_scan_bwd`` (the
SSD backward).  PATH is another checkout of the repository (e.g. the
parent commit unpacked with ``git archive``), whose
``src/repro_torch/kernels/csrc/NAME.cu`` is taken, or such a source file
itself; it is compiled with this checkout's ``nvcc`` flags into
``build/kernel_ab/``.  The flash forward's two libraries take the same C
call.  The SSD backward's C signature and scratch change with its design,
so each side goes through its own wrapper: PATH's
``src/repro_torch/kernels/ssd_scan.py`` is loaded by path (PATH must then
be a checkout) and its ``_ARGTYPES``, ``bwd_workspace`` and
``bwd_call_args`` bind, size and call that side.  For each case the two
kernels run on the same inputs and their outputs are compared bit for bit
and, where they differ, by each output's relative L2 between the two sides
(``rel_l2``, over max(1, |other|)); then ``--rounds`` rounds of other,
this, this, other, each timed with CUDA events (median of 10 runs; the 32k
layer, 3), so that a drift of the card's clock falls on both.  One JSON
line per case: ``identical``, each side's medians and their median, and
this / other.  The last line is the card's name and power limit from
``nvidia-smi``.

The cases.  ``flash_attention``: chip_smoke.py's serving layers
(llama3-8b's main path and its 32k prefill layer, dbrx-132b, internvl2-1b,
gemma-7b and seamless-m4t-large-v2's four), bf16, q and k as transposed
views as the layers hand them over, compared once without the log-sum-exp
(serving's call) and once with it (training's: ``identical_lse``), timed
without.  ``ssd_scan_bwd``: chip_smoke.py's timed ``ssd_bwd`` cases (the
mamba2-2.7b training layer in bf16 and f32, the jamba-v0.1-52b training
layer, mamba's serving layer; b and c one group, the D-skip, mamba2's a
and dt), all six gradients compared.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# name, (B, Hq, Hkv, Sq, Sk, D), causal, timed runs
FLASH_CASES = [
    ("main_path", (4, 32, 8, 2048, 2048, 128), True, 10),
    ("prefill_32k_layer", (1, 32, 8, 32768, 32768, 128), True, 3),
    ("dbrx_layer", (4, 48, 8, 2048, 2048, 128), True, 10),
    ("internvl_layer", (4, 14, 2, 2048, 2048, 64), True, 10),
    ("gemma_layer", (4, 16, 16, 2048, 2048, 256), True, 10),
    ("seamless_enc", (4, 16, 16, 512, 512, 64), False, 10),
    ("seamless_dec_self", (4, 16, 16, 2048, 2048, 64), True, 10),
    ("seamless_cross", (4, 16, 16, 2048, 512, 64), False, 10),
    ("seamless_cross_decode", (4, 16, 16, 1, 512, 64), False, 10),
]
# name, (B, L, H, P, N), dtype
SSD_BWD_CASES = [
    ("main_path", (2, 4096, 80, 64, 128), "bfloat16"),
    ("train_layer_f32", (2, 4096, 80, 64, 128), "float32"),
    ("jamba_train_layer", (2, 4096, 128, 64, 16), "bfloat16"),
    ("serving_layer", (4, 2048, 80, 64, 128), "bfloat16"),
]


def bind_flash(path: Path):
    fn = ctypes.CDLL(str(path)).repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 15
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


class _NoLibrary:
    """Another checkout's ``torch.library.Library`` while it loads: its ops
    are this checkout's already, so it defines and registers nothing."""

    def __init__(self, *_args, **_kwargs):
        pass

    def define(self, *_args, **_kwargs):
        pass

    def impl(self, *_args, **_kwargs):
        pass


def wrapper_at(checkout: Path, module: str):
    """``src/repro_torch/kernels/<module>.py`` of another checkout, loaded
    by path under its own name (its imports of the package resolve to this
    checkout's, which it uses only for building and binding; the ops and
    flop formulas it would register, if it has them, are this checkout's
    already and are not registered again)."""
    import torch

    path = checkout / "src" / "repro_torch" / "kernels" / f"{module}.py"
    spec = importlib.util.spec_from_file_location(f"kernel_ab_other_{module}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    lib, flops = torch.library, torch.utils.flop_counter
    saved = lib.Library, lib.register_fake, flops.register_flop_formula
    lib.Library = _NoLibrary
    lib.register_fake = flops.register_flop_formula = (
        lambda *_args, **_kwargs: (lambda f: f))
    try:
        spec.loader.exec_module(mod)
    finally:
        lib.Library, lib.register_fake, flops.register_flop_formula = saved
    return mod


def bind_ssd_bwd(path: Path, wrapper):
    """The SSD backward's C entry in the library at ``path``, as
    ``wrapper`` (that side's ssd_scan module) declares it."""
    fn = ctypes.CDLL(str(path)).repro_ssd_scan_bwd
    fn.argtypes = wrapper._ARGTYPES["ssd_scan_bwd"] + [ctypes.c_int,
                                                       ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_cases(torch, sides):
    """Per case: (name, its fields, {side: timed call}, {check: identical})."""
    from repro_torch.kernels import flash_attention as kflash

    for i, (name, shape, causal, runs) in enumerate(FLASH_CASES):
        B, Hq, Hkv, Sq, Sk, D = shape
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        q, k, v = (torch.randn((B, S, H, D), generator=g, device="cuda",
                               dtype=torch.bfloat16).transpose(1, 2)
                   for H, S in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
        strides = (*kflash._strides(q), *kflash._strides(k),
                   *kflash._strides(v))
        outs = {s: torch.empty((B, Hq, Sq, D), device="cuda",
                               dtype=torch.bfloat16) for s in sides}
        lses = {s: torch.empty((B, Hq, Sq), device="cuda",
                               dtype=torch.float32) for s in sides}

        def call(side, with_lse=False):
            err = sides[side](
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                outs[side].data_ptr(),
                lses[side].data_ptr() if with_lse else 0,
                B, Hq, Hkv, Sq, Sk, D, *strides, 1, int(causal), D ** -0.5,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{side} {name}: cudaError {err}")

        identical = {}
        for with_lse, key in ((False, "identical"), (True, "identical_lse")):
            for side in sides:
                call(side, with_lse)
            torch.cuda.synchronize()
            identical[key] = torch.equal(outs["other"], outs["this"]) and (
                not with_lse or torch.equal(lses["other"], lses["this"]))
        yield (name, {"shape": list(shape), "causal": causal, "runs": runs},
               {s: (lambda s=s: call(s)) for s in sides}, identical)
        del q, k, v, outs, lses
        torch.cuda.empty_cache()


def rel_l2(torch, got, want) -> float:
    return float((got.double() - want.double()).norm()) / max(
        1.0, float(want.double().norm()))


def ssd_bwd_cases(torch, sides, wrappers):
    """Per case: (name, its fields, {side: timed call}, {check: result}).
    Each side sizes its scratch and builds its arguments with its own
    wrapper (``wrappers[side]``)."""
    grads = ("dx", "ddt", "da", "db", "dc", "dd")
    for i, (name, shape, xd) in enumerate(SSD_BWD_CASES):
        B, L, H, P, N = shape
        dtype = getattr(torch, xd)
        x, dt, a, b, c, dy, d = ssd_inputs(torch, shape, dtype, 2000 + i)
        outs = {s: (torch.empty_like(x),
                    torch.empty((B, L, H), device="cuda"),
                    torch.empty((H,), device="cuda"), torch.empty_like(b),
                    torch.empty_like(c), torch.empty((H,), device="cuda"))
                for s in sides}
        work = {}
        for s, w in wrappers.items():
            takes_groups = "groups" in inspect.signature(
                w.bwd_workspace).parameters
            work[s] = w.bwd_workspace(x, N, *([b.shape[2]] if takes_groups
                                              else []))

        def call(side):
            err = sides[side](*wrappers[side].bwd_call_args(
                x, dt, a, b, c, dy, d, outs[side], work[side]))
            if err:
                raise RuntimeError(f"{side} {name}: cudaError {err}")

        for side in sides:
            call(side)
        torch.cuda.synchronize()
        checks = {"identical": all(torch.equal(u, v) for u, v in
                                   zip(outs["other"], outs["this"]))}
        if not checks["identical"]:
            checks["rel_l2"] = {g: rel_l2(torch, u, v) for g, u, v in
                                zip(grads, outs["this"], outs["other"])}
        yield (name, {"shape": list(shape), "dtype": xd, "runs": 10},
               {s: (lambda s=s: call(s)) for s in sides}, checks)
        del x, dt, a, b, c, dy, d, outs, work
        torch.cuda.empty_cache()


def ssd_inputs(torch, shape, dtype, seed):
    """mamba2's SSD inputs at a layer (chip_smoke.py:ssd_inputs, "model"),
    b and c one group [B, L, 1, N], and dy."""
    B, L, H, P, N = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((B, L, H, P), generator=g, device="cuda", dtype=dtype)
    a = -torch.arange(1, H + 1, device="cuda", dtype=torch.float32)
    u = torch.rand((H,), generator=g, device="cuda")
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    dt = torch.nn.functional.softplus(
        torch.randn((B, L, H), generator=g, device="cuda") + dt_bias)
    b = torch.randn((B, L, 1, N), generator=g, device="cuda", dtype=dtype)
    c = torch.randn((B, L, 1, N), generator=g, device="cuda", dtype=dtype)
    d = torch.ones((H,), device="cuda")
    dy = torch.randn((B, L, H, P), generator=g, device="cuda", dtype=dtype)
    return x, dt, a, b, c, dy, d


#: kernel -> (its wrapper module, whether each side binds through its own
#: wrapper, its cases)
KERNELS = {"flash_attention": ("flash_attention", False, flash_cases),
           "ssd_scan_bwd": ("ssd_scan", True, ssd_bwd_cases)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", required=True, choices=sorted(KERNELS))
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import importlib

    import torch

    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        sys.exit("kernel_ab: CUDA is not available")
    module, own_wrapper, cases = KERNELS[args.kernel]
    wrapper = importlib.import_module(f"repro_torch.kernels.{module}")
    out_dir = ROOT / "build" / "kernel_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    other_src = args.other if args.other.suffix == ".cu" else (
        args.other / "src" / "repro_torch" / "kernels" / "csrc"
        / f"{args.kernel}.cu")
    other_lib = out_dir / f"libother_{args.kernel}.so"
    subprocess.run(build.nvcc_command(other_src, other_lib,
                                      build.find_nvcc()),
                   check=True, capture_output=True)
    this_fn = wrapper._bind(args.kernel)[0]
    if own_wrapper:
        if args.other.suffix == ".cu":
            sys.exit("kernel_ab: --kernel ssd_scan_bwd needs a checkout, "
                     "whose wrapper binds its side")
        wrappers = {"other": wrapper_at(args.other, module), "this": wrapper}
        sides = {"other": bind_ssd_bwd(other_lib, wrappers["other"]),
                 "this": this_fn}
        side_cases = cases(torch, sides, wrappers)
    else:
        sides = {"other": bind_flash(other_lib), "this": this_fn}
        side_cases = cases(torch, sides)

    def timed(fn, runs):
        for _ in range(2):
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

    for name, fields, calls, identical in side_cases:
        ms = {s: [] for s in sides}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                ms[side].append(timed(calls[side], fields["runs"]))
        med = {s: statistics.median(v) for s, v in ms.items()}
        print(json.dumps({
            "kernel": args.kernel, "case": name, **fields, **identical,
            "other_ms": ms["other"], "this_ms": ms["this"],
            "other_median_ms": med["other"], "this_median_ms": med["this"],
            "this_over_other": med["this"] / med["other"]}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
