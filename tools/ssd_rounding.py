"""How far the bf16 SSD kernel's rounding moves y, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/ssd_rounding.py

Runs ``kernel_arithmetic`` of tests/test_torch_ssd.py, the plain model of
the arithmetic of csrc/ssd_scan.cu's bf16 path, over that file's
``ROUNDING_CASES`` with the kernel's operands split into bf16 hi + lo (as
built) and rounded once to bf16 (the alternative), and prints one JSON line
a case: against ``ref.ssd_scan`` (the f32 sequential recurrence), the
largest ``|err| / (2e-2 + 2e-2 |want|)`` (at most 1 meets the card's bf16
elementwise gate) and the relative L2 (gate 5e-3).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))

import test_torch_ssd as t  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402


def main() -> None:
    for case in t.ROUNDING_CASES:
        x, dt, a, b, c, d = t._torch(t._case_arrays(case), "bfloat16")
        want = ref.ssd_scan(x, dt, a, b, c, d_skip=d)
        row = {"case": case[0], "shape": list(case[1:6]), "inputs": case[6]}
        for name, split in (("hi_lo", True), ("one_bf16", False)):
            got = t.kernel_arithmetic(x, dt, a, b, c, d_skip=d, split=split)
            ratio, l2 = t._gate_ratio(got, want)
            row[name] = {"gate_ratio": ratio, "rel_l2": l2}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
