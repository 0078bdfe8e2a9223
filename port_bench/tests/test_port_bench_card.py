"""Every cell at its smoke size on the card: the port's kernels under the
harness, traced, with the output check passing.  Skips without a card
(run on the card with ``python -m pytest -m cuda port_bench/tests``)."""

import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import manifest, session  # noqa: E402

CELLS = [w["name"] for w in manifest.load_json(
    BENCH.parent / "BENCHMARK.json")["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card_at_smoke_size(card, name):
    result = session.run_cell(torch, manifest.cell(name), 4_012_345_678, 0.5,
                              True, "cuda:0", time.perf_counter(),
                              smoke=True)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
