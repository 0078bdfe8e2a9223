#!/usr/bin/env python3
"""What the kernels' custom-op dispatch costs on the card.

    PYTHONPATH=src python tools/op_dispatch.py [--src DIR] [--runs N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``), so
that two checkouts (one with the LM kernels behind ``torch.library``
custom ops, one that calls them directly) can be timed in one call,
alternating.  On one H100 it prints one JSON line:

* ``flash_call_us``: host microseconds per ``flash_attention`` call at one
  decode step's cross-attention (q [4, 16, 1, 64], k and v [4, 16, 512,
  64] bf16, non-causal: seamless-m4t-large-v2's), the mean over 2000
  calls from a synchronise to a synchronise (the launch is ~11 µs of
  device time: the host's cost shows);
* ``llama_step_ms`` and ``seamless_step_ms``: greedy_generate's seconds
  per decode step, 4 requests of 64 prompt and 32 new tokens, at full
  width and depth (random bf16 weights from a seed; the median of
  ``--runs``): llama3-8b's decode path launches no kernel, seamless's
  launches the flash kernel in each decoder layer's cross-attention (24 a
  step).

It needs the card and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def synced(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("op_dispatch: CUDA is not available")
    sys.path.insert(0, args.src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kflash
    from repro_torch.models import build
    from repro_torch.train import greedy_generate

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    q = torch.randn((4, 16, 1, 64), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k, v = (torch.randn((4, 16, 512, 64), generator=g, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    for _ in range(50):
        kflash.flash_attention(q, k, v, causal=False)
    calls = 2000
    _, seconds = synced(torch, lambda: [kflash.flash_attention(
        q, k, v, causal=False) for _ in range(calls)])
    out = {"src": args.src, "flash_call_us": seconds / calls * 1e6}

    new, prompt_len = 32, 64
    for arch, key in (("llama3-8b", "llama_step_ms"),
                      ("seamless-m4t-large-v2", "seamless_step_ms")):
        cfg = get_config(arch)
        model = build(cfg)
        params = model.init(args.seed)
        prompt = torch.randint(0, cfg.vocab_size, (4, prompt_len),
                               generator=g, device="cuda")
        frontend = (torch.randn((4, 512, cfg.frontend_dim or cfg.d_model),
                                generator=g, device="cuda",
                                dtype=torch.bfloat16)
                    if cfg.is_encdec else None)
        times = []
        for _ in range(args.runs + 1):
            _, s = synced(torch, lambda: greedy_generate(
                model, params, prompt, new, max_len=prompt_len + new,
                frontend=frontend))
            times.append(s / (prompt_len + new) * 1e3)
        out[key] = statistics.median(times[1:])
        out[key + "_runs"] = times[1:]
        del model, params
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
