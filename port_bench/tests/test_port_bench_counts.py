"""The frozen arithmetic: the bounds equal the port's ``kernels/bounds.py``
at the cells' shapes, and the model FLOPs equal counts made by hand from
the configurations' widths."""

import math
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from counts import bounds, model_flops, peaks  # noqa: E402
from harness import manifest, weights  # noqa: E402
from reference.model import Spec  # noqa: E402

from repro_torch.core import perfmodel  # noqa: E402
from repro_torch.kernels import bounds as port_bounds  # noqa: E402
from repro_torch.kernels import ssd_scan  # noqa: E402

MAMBA = Spec.from_dict(manifest.load_json(
    BENCH / "configs" / "mamba2-2.7b.json")["model"])
JAMBA = Spec.from_dict(manifest.load_json(
    BENCH / "configs" / "jamba-v0.1-52b.json")["model"])


def test_peaks_are_the_ports():
    assert peaks.BF16_OPS_PER_S == perfmodel.H100_PEAK_BF16_OPS_PER_S
    assert peaks.F32_OPS_PER_S == perfmodel.H100_PEAK_F32_OPS_PER_S
    assert peaks.HBM_BYTES_PER_S == perfmodel.H100_HBM_BYTES_PER_S


@pytest.mark.parametrize("shape", [(4, 2048, 80, 64, 128),
                                   (4, 2048, 128, 64, 16),
                                   (2, 4096, 80, 64, 128), (1, 100, 3, 16, 8)])
@pytest.mark.parametrize("x_bytes", [2, 4])
def test_ssd_bounds_equal_the_ports(shape, x_bytes):
    assert bounds.ssd_bound(shape, x_bytes, True) == port_bounds.ssd_bound(
        shape, x_bytes, True, chunk=port_bounds.SSD_CHUNK)
    assert bounds.ssd_bwd_bound(shape, x_bytes, True, True) == \
        port_bounds.ssd_bwd_bound(shape, x_bytes, True, True,
                                  chunk=ssd_scan.CHUNK)


def test_hand_worked_bounds():
    assert bounds.ssd_bound((4, 2048, 80, 64, 128), 2, True)[:2] == (
        174_588_544, 27_020_754_944)
    assert bounds.ssd_bound((4, 2048, 128, 64, 16), 2, True)[0] == 273_155_072
    assert bounds.ssd_bwd_bound((2, 4096, 80, 64, 128), 2, True,
                                True)[0] == 265_291_008
    n = sum(math.prod(s) for layer in
            weights.layers(MAMBA) for _, s, _ in layer)
    assert n == 2_702_968_320
    assert bounds.adamw_bound_ms(n) == pytest.approx(32 * n / 3.35e12 * 1e3)


def test_model_flops_by_hand():
    # mamba2-2.7b: a token's multiply-adds, then the SSD's products
    layer = 2560 * (2 * 5120 + 2 * 128 + 80) + 5120 * 2560
    assert model_flops.matmul_macs_per_token(MAMBA) == 64 * layer + 2560 * 50277
    chunk = 80 * (128 * 129 * 64 + 4 * 128 * 128 * 64) + 128 * 129 * 128
    train = 3 * (2 * 2_700_341_760 * 8192 + 2 * 64 * 32 * chunk)
    assert model_flops.step_flops(MAMBA, 2, 4096, True) == train \
        == 137_915_183_136_768
    assert model_flops.step_flops(MAMBA, 4, 2048, False) == \
        45_971_727_712_256
    # jamba-v0.1-52b at 16 layers: 2 attention, 14 Mamba, 8 FFN, 8 MoE
    attn = 4096 * (4096 + 2 * 1024) + 4096 * 4096
    mamba = 4096 * (2 * 8192 + 2 * 16 + 128) + 8192 * 4096
    ffn = 3 * 4096 * 14336
    moe = 4096 * 16 + 2 * ffn
    per_token = 2 * attn + 14 * mamba + 8 * ffn + 8 * moe + 4096 * 65536
    assert model_flops.matmul_macs_per_token(JAMBA) == per_token \
        == 5_999_165_440
    pairs = 2048 * 2049 // 2
    ssd = 16 * (128 * (128 * 129 * 64 + 4 * 128 * 16 * 64) + 128 * 129 * 16)
    want = 2 * per_token * 8192 + 8 * 4 * 128 * 32 * pairs + 56 * ssd
    assert model_flops.step_flops(JAMBA, 4, 2048, False) == want \
        == 98_746_903_560_192
