#!/usr/bin/env python3
"""Where a training step's device memory goes, on the card.

    PYTHONPATH=src python tools/step_memory.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``;
another checkout's shows what it held) and runs this checkout's
``chip_smoke.py`` ``mesh_train`` phase (llama3-8b at full width, 2
layers, a 1 x 1 NCCL mesh, two trainers through an elastic pre-emption)
with the allocator's history recorded, and prints one JSON line: each
elastic step's memory allocated at its start and its peak, and, for the
first step that starts above the first step's start by more than 1 GB,
the live blocks at that moment summed by the port's frames that allocated
them (the largest ten).  It needs the card and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def live_by_site(snapshot, top: int = 10) -> list:
    """The snapshot's allocated blocks summed by the chain of repository
    frames that allocated them -> [(bytes, frames)], largest first."""
    sites = collections.Counter()
    for segment in snapshot["segments"]:
        for block in segment["blocks"]:
            if block["state"] != "active_allocated":
                continue
            frames = [f"{Path(f['filename']).name}:{f['line']}:{f['name']}"
                      for f in block.get("frames", [])
                      if "repro" in f["filename"]
                      or "chip_smoke" in f["filename"]]
            sites[" <- ".join(frames[:6])] += block["size"]
    return [[n, site] for site, n in sites.most_common(top)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("step_memory: CUDA is not available")
    sys.path[:0] = [args.src, str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import backend

    steps, found = [], {}
    measure = chip_smoke.StepPeaks.__call__

    def call(self, fn):
        start = torch.cuda.memory_allocated()
        if steps and start > steps[0][0] + 1e9 and not found:
            found["start"] = start
            found["live"] = live_by_site(torch.cuda.memory._snapshot())
        out = measure(self, fn)
        steps.append((start, self.steps[-1]))
        return out

    chip_smoke.StepPeaks.__call__ = call
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.memory._record_memory_history(max_entries=400000)
    try:
        chip_smoke.phase_mesh_train(torch, 0, backend)
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    print(json.dumps({"src": args.src,
                      "device": torch.cuda.get_device_name(0),
                      "steps": steps, "grown_step": found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
