#!/usr/bin/env python3
"""Readings of the output check's control and planted faults, on several
seeds in one process; the benchmark's own runs do not run these.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3 [--what control]

``--what control`` reads the control: the plain reference put in the
program's place one precision below the configuration's (the loop's
``control_numbers``: training, bfloat16 master weights and moments where
the configuration states float32; prefill, weight-only fp8 e4m3 where it
states bfloat16 weights), held to the float32 reference by the cell's own
comparison.  ``--what
<fault>`` (``harness.faults.KINDS``) runs the cell with that fault planted
under the timed path for ``--seconds``.  Each seed prints one JSON line:
the numbers compared, the cell's limits and the numbers over them.  The
CPU tests read both at smoke size (``tests/test_port_bench_cells.py``).
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", default="control")
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)

    from harness import manifest, session
    from harness.context import Context
    from reference.model import Spec

    session.prepare_env(manifest.ROOT)
    sys.path.insert(0, str(manifest.ROOT / "src"))
    import torch

    cell = manifest.cell(args.workload)
    model, traffic, limits = session.sizes(cell, smoke=False)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.what == "control":
            ctx = Context(torch=torch, cell=cell.name,
                          arch=cell.config["port"]["arch"], model=model,
                          spec=Spec.from_dict(model), traffic=traffic,
                          seed=seed, seconds=0.0, trace=False,
                          device=torch.device("cuda:0"), t0=t)
            numbers = manifest.loop_module(
                traffic["kind"]).control_numbers(ctx)
        else:
            numbers = {k: c["value"] for k, c in session.run_cell(
                torch, cell, seed, args.seconds, False, "cuda:0", t,
                fault=args.what)["checks"].items()}
        over = session.verdict(numbers, limits, 0)
        print(json.dumps({"workload": cell.name, "what": args.what,
                          "seed": seed, "numbers": numbers, "limits": limits,
                          "over": over,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
