#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the machine it is started
on, and print the result as the last line of standard output.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a profiled run.  Either
way the check of what the timed path produced against the plain reference
decides ``correct``; each compared number and its limit are printed last
on standard error and under ``checks`` in the result.  Exits 2 without a
result where CUDA or the cell's cards are missing, 3 where JAX or the
JAX package was loaded, and 4 where a metric the manifest gives the cell
read nothing (a reader that has lost sight of its operation).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness import manifest, session

    session.prepare_env(manifest.ROOT)
    import torch

    cell = manifest.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(manifest.ROOT / "src"))
    result = session.run_cell(torch, cell, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0)
    loaded = session.forbidden_modules()
    if loaded:
        print(f"loaded in this process: {', '.join(loaded)}", file=sys.stderr)
        return 3
    missing = result.pop("missing")
    if missing:
        print(f"metrics of {args.workload} that read nothing: "
              f"{', '.join(missing)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
