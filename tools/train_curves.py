"""The nll curves of chip_smoke.py's SSM training runs with the SSD kernel
and with the plain chunked SSD under autograd, on the same seed and
batches, on the card: does the kernel's curve alone rise?

    PYTHONPATH=src python tools/train_curves.py [--which mamba jamba]
        [--seed 0]

For each of ``--which`` (chip_smoke.py's TRAIN: mamba2-2.7b at full
width and 32 of its 64 layers, jamba-v0.1-52b at full width and 2 layers)
it runs
launch.train's code path for TRAIN_STEPS steps of 2 x 4096 tokens at
TRAIN_LR, as the ``mamba_train`` and ``jamba_train`` phases do (no
checkpoint): once with the SSD kernels and once with every ``ops.ssd``
call on the plain SSD chunked as the kernels chunk
(``kernels/ssd_scan.py:CHUNK``), its gradient from autograd.  One JSON
line per run: each step's nll, gradient norm and learning rate, the shard
of the token corpus each step's batch comes from, and the launches.  The
last line is the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--which", nargs="+", default=["mamba", "jamba"],
                    choices=["mamba", "jamba"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from repro_torch.kernels import backend
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import train as ptrain

    if not torch.cuda.is_available():
        sys.exit("train_curves: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    for which in args.which:
        arch = cs.TRAIN[which].arch
        cfg = cs.train_config(which)
        targs = cs.train_args(args.seed, arch=arch)
        spec = ptrain.corpus_spec(targs, cfg)
        rows = spec.shard_tokens // (targs.seq + 1)
        shards = [(step * targs.batch // rows) % spec.num_shards
                  for step in range(targs.steps)]
        for ssd in ("kernel", "plain"):
            backend.reset_launch_counts()
            with contextlib.ExitStack() as stack:
                if ssd == "plain":
                    stack.enter_context(cs.plain_ssd_at(kssd.CHUNK))
                stack.enter_context(cs.patched(
                    ptrain, "checkpoints",
                    lambda _: lambda *a: cs.NoCheckpoints()))
                stack.enter_context(cs.patched(
                    ptrain, "state_to_numpy", lambda _: lambda *a: None))
                out = ptrain.run(targs, cfg, ptrain.make_store(None))
            hist = out["history"]
            del out
            torch.cuda.empty_cache()
            print(json.dumps({
                "arch": cfg.arch_id, "layers": cfg.num_layers, "ssd": ssd,
                "chunk": kssd.CHUNK if ssd == "plain" else None,
                "seed": args.seed, "lr": targs.lr, "warmup": targs.warmup,
                "shard": shards, "nll": [h["nll"] for h in hist],
                "grad_norm": [h["grad_norm"] for h in hist],
                "lr_at_step": [h["lr"] for h in hist],
                "launches": backend.launch_counts()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
