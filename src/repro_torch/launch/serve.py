"""Serving CLI: batched greedy generation against a ported arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
        --variant smoke --batch 4 --prompt-len 16 --gen 32 [--device cpu]

The flags of ``repro/launch/serve.py`` plus ``--device`` (default: the
card).  Weights are random, drawn from ``--seed``; so is the prompt.  Prints
one ``[serve]`` JSON line: the JAX CLI's keys plus the device's name.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs.base import get_config
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build
from repro_torch.train.serve_step import greedy_generate


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, args.variant)
    model = build(cfg, device=dev)
    params = model.init(args.seed)
    g = torch.Generator(device=dev).manual_seed(args.seed)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=g, device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = greedy_generate(model, params, prompt, args.gen,
                          max_len=args.prompt_len + args.gen + 1).cpu()
    dt = time.perf_counter() - t0
    print("[serve]", json.dumps({
        "arch": args.arch, "batch": args.batch,
        "generated": [int(x) for x in out[0][:16]],
        "tokens_per_s": round(args.batch * args.gen / dt, 1),
        "device": device_name(dev),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
