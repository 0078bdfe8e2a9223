"""The flash forward kernel of this checkout against another checkout's, on
the card: are the outputs bit-identical, and are the times the same?

    PYTHONPATH=src python tools/flash_ab.py --other DIR [--rounds 4]

DIR is another checkout of the repository (e.g. the parent commit unpacked
with ``git archive``); its ``src/repro_torch/kernels/csrc/flash_attention.cu``
is compiled with this checkout's ``nvcc`` flags into ``build/flash_ab/``.
Both libraries take the same C call.  For each case (chip_smoke.py's
serving layers: llama3-8b's main path and its 32k prefill layer, dbrx-132b,
internvl2-1b, gemma-7b and seamless-m4t-large-v2's four) the two kernels
run on the same inputs, bf16, q and k as transposed views as the layers
hand them over: once without the log-sum-exp (serving's call) and once with
it (training's), each output compared bit for bit.  Then ``--rounds``
rounds of other, this, this, other, each timed with CUDA events (median of
10 runs; the 32k layer, 3), so that a drift of the card's clock falls on
both.  One JSON line per case: ``identical``, ``identical_lse``, each
side's medians and their median, and this / other.  The last line is the
card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# name, (B, Hq, Hkv, Sq, Sk, D), causal, timed runs
CASES = [
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


def bind(path: Path):
    fn = ctypes.CDLL(str(path)).repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 15
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, required=True)
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()

    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kflash

    if not torch.cuda.is_available():
        sys.exit("flash_ab: CUDA is not available")
    out_dir = ROOT / "build" / "flash_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    other_src = (args.other / "src" / "repro_torch" / "kernels" / "csrc"
                 / "flash_attention.cu")
    other_lib = out_dir / "libother_flash_attention.so"
    subprocess.run(build.nvcc_command(other_src, other_lib,
                                      build.find_nvcc()),
                   check=True, capture_output=True)
    sides = {"other": bind(other_lib), "this": kflash._bind(
        "flash_attention")[0]}

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

    for i, (name, shape, causal, runs) in enumerate(CASES):
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
        for with_lse in (False, True):
            for side in sides:
                call(side, with_lse)
            torch.cuda.synchronize()
            identical[with_lse] = torch.equal(outs["other"], outs["this"]) \
                and (not with_lse or torch.equal(lses["other"],
                                                 lses["this"]))
        ms = {s: [] for s in sides}
        for _ in range(args.rounds):
            for side in ("other", "this", "this", "other"):
                ms[side].append(timed(lambda: call(side), runs))
        med = {s: statistics.median(v) for s, v in ms.items()}
        print(json.dumps({
            "case": name, "shape": list(shape), "causal": causal,
            "identical": identical[False], "identical_lse": identical[True],
            "other_ms": ms["other"], "this_ms": ms["this"],
            "other_median_ms": med["other"], "this_median_ms": med["this"],
            "this_over_other": med["this"] / med["other"]}), flush=True)
        del q, k, v, outs, lses
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
