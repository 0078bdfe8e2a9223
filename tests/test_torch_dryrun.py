"""``launch/dryrun.py``: the port's dry run on fake tensors and torch's fake
process group, against the JAX package's dry run where they mean the same
thing.

* The counterpart of ``test_mini_dryrun_smoke_arch``
  (``tests/test_sharding.py:100``): four archs' smoke train steps on a
  (2, 4) fake world, each a fresh process as the CLI is run: status ok,
  collectives recorded, the kernels' custom ops called.
* ``params`` equals the JAX package's parameter count for all ten archs'
  full configs; ``model_flops`` equals the JAX dry run's formula
  (``repro/launch/dryrun.py:305-311``); ``long_500k`` skips where the JAX
  dry run skips it.
* The collective pricer on synthetic recorded events (as
  ``tests/test_system.py:62-78`` holds the HLO parser), and the counter on
  real c10d ops of a fake world.
* The kernels' custom ops: their fake outputs' shapes and their flops
  equal ``kernels/bounds.py``'s formulas; on the CPU each gives its plain
  version's result.
* The live-storage peak on a function whose allocations are known.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_config as jget_config
from repro.models import build as jbuild
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import SHAPES
from repro_torch.core import perfmodel
from repro_torch.kernels import bounds, ref
from repro_torch.kernels import flash_attention as kflash
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]
SMOKE_ARCHS = ["llama3-8b", "dbrx-132b", "mamba2-2.7b", "jamba-v0.1-52b"]


def _cli(*argv, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_mini_dryrun_smoke_arch(arch):
    """A smoke train step on a (2, 4) mesh of the fake world: the rule
    table places the state, the step runs, collectives are issued."""
    proc = _cli("--arch", arch, "--variant", "smoke", "--shape", "train_4k",
                "--mesh", "local", "--mesh-data", "2", "--mesh-model", "4",
                "--batch", "8", "--seq", "128")
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["mesh"] == {"data": 2, "model": 4}
    coll = rec["collective_bytes_per_device"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert coll["total"] == pytest.approx(sum(
        v for k, v in coll.items() if k != "total"))
    assert rec["rows_per_device"] == 4
    cfg = get_config(arch, "smoke")
    calls = rec["kernel_calls"]
    n_attn = sum(1 for mixer, _ in _plan(cfg) if mixer == "attn")
    n_mamba = cfg.num_layers - n_attn
    # remat: each forward twice, one backward
    assert calls.get("flash_attention_fwd", 0) == 2 * n_attn
    assert calls.get("flash_attention_bwd", 0) == n_attn
    assert calls.get("ssd_scan_fwd", 0) == 2 * n_mamba
    assert calls.get("ssd_scan_bwd", 0) == n_mamba
    bpd = rec["bytes_per_device"]
    assert bpd["peak_estimate"] == bpd["arguments"] + bpd["temps"]
    assert rec["hbm_ok"] == (bpd["peak_estimate"] < rec["hbm_bytes"])
    assert rec["roofline"]["step_s"] == max(
        rec["roofline"][k] for k in ("compute_s", "memory_s",
                                     "collective_s"))


def _plan(cfg):
    from repro_torch.models.transformer import layer_plan
    return layer_plan(cfg)


def test_cli_refuses_seqpar_and_skips_long_500k():
    """``--seqpar`` is refused no more: it sets ``cfg.sequence_parallel``
    and the step runs with the stream sharded over the sequence (the
    model axis's activation all-reduces become reduce-scatters and
    all-gathers, as many bytes on the wire: Megatron's sequence
    parallelism saves memory, not wire); no flag is refused now.
    ``long_500k`` still skips where the JAX dry run skips it."""
    argv = ("--arch", "llama3-8b", "--variant", "smoke", "--shape",
            "train_4k", "--mesh", "local", "--mesh-data", "2",
            "--mesh-model", "4", "--batch", "8", "--seq", "128")
    recs = {}
    for flag in ((), ("--seqpar",)):
        proc = _cli(*argv, *flag)
        assert proc.returncode == 0, proc.stderr[-3000:]
        recs[flag] = json.loads(proc.stdout.strip().splitlines()[-1])
    on, off = recs[("--seqpar",)], recs[()]
    assert on["status"] == "ok" and on["options"]["seqpar"] is True
    assert off["options"]["seqpar"] is False
    assert on["options"]["step"] == "tensor-parallel"
    wire_on = on["collective_bytes_per_device"]
    wire_off = off["collective_bytes_per_device"]
    assert wire_on["all-reduce"] < wire_off["all-reduce"]
    assert wire_on["reduce-scatter"] > wire_off["reduce-scatter"]
    assert wire_on["all-gather"] > wire_off["all-gather"]
    rec = dryrun.lower_cell("llama3-8b", "long_500k")
    assert rec["status"] == "skip" and "long_500k" in rec["reason"]


def test_train_4k_on_16x16_fits_an_h100_for_llama_and_mamba():
    """The tensor-parallel step's peak per device at train_4k on the
    16 x 16 mesh, llama3-8b and mamba2-2.7b at full width and depth (the
    two cells run at once, a process each): under 80 GB (the gather-whole
    step held 187.7 and 87.2 GB)."""
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--mesh", "single"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in ("llama3-8b", "mamba2-2.7b")}
    for arch, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["status"] == "ok" and rec["mesh"] == {"data": 16,
                                                          "model": 16}
        assert rec["bytes_per_device"]["peak_estimate"] < 80e9, arch
        assert rec["hbm_ok"]
        assert rec["options"]["step"] == "tensor-parallel"


def test_decode_on_16x16_fits_an_h100_for_qwen2_dbrx_and_jamba():
    """The tensor-parallel decode step's peak per device on the 16 x 16
    mesh, caches split by sequence: qwen2-72b and dbrx-132b at decode_32k
    and jamba-v0.1-52b at long_500k (batch 1: the positions over all 256
    ranks), full width and depth, a process each, run at once: under 80 GB
    (the gather-whole step held 239.6, 312.2 and 116.5 GB)."""
    cells = {"qwen2-72b": "decode_32k", "dbrx-132b": "decode_32k",
             "jamba-v0.1-52b": "long_500k"}
    procs = {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch, shape in cells.items()}
    for arch, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["status"] == "ok" and rec["shape"] == cells[arch]
        assert rec["mesh"] == {"data": 16, "model": 16}
        assert rec["options"]["step"] == "tensor-parallel"
        assert rec["bytes_per_device"]["peak_estimate"] < 80e9, arch
        assert rec["hbm_ok"]


def test_dbrx_int8_step_on_a_one_rank_mesh_fits_an_h100():
    """dbrx-132b at full width, 1 layer, int8 moments, 2 x 4096 tokens, on
    a local 1 x 1 mesh (whose step passes the optimizer its layouts) and
    with no mesh, a process each, run at once: on the mesh the predicted
    step peak is under 80 GB and within 1.05x of the one without, as the
    update takes its [16, 6144, 10752] expert stacks in parts of rows
    either way (taken whole on the mesh, they put the peak at 1.36x)."""
    procs = {mesh: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "dbrx-132b", "--shape", "train_4k", "--mesh", mesh, "--layers",
         "1", "--batch", "2", "--moments", "int8"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for mesh in ("local", "none")}
    peak = {}
    for mesh, p in procs.items():
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["status"] == "ok" and rec["batch"] == [2, 4096]
        assert rec["layers"] == 1 and rec["options"]["moments"] == "int8"
        assert rec["mesh"] == ({"data": 1, "model": 1} if mesh == "local"
                               else None)
        peak[mesh] = rec["bytes_per_device"]["peak_estimate"]
    assert peak["local"] < 80e9
    assert peak["none"] / 1.05 <= peak["local"] <= 1.05 * peak["none"], peak


def test_decode_cache_shard_changes_the_step():
    """``--cache-shard`` picks the decode step's layout: split by sequence
    over a (1, 4) mesh each rank holds a quarter of the positions and
    reduces the softmax's statistics and P·V over ``model``; by KV head
    (two on four ranks: the guard keeps them whole) each rank holds every
    position of every KV head and reduces nothing of the attention."""
    recs = {shard: dryrun.lower_cell(
        "llama3-8b", "decode_32k", mesh_shape=(1, 4), variant="smoke",
        batch=4, seq=256, cache_shard=shard) for shard in ("seq", "heads")}
    seq, heads = recs["seq"], recs["heads"]
    assert seq["status"] == heads["status"] == "ok"
    assert heads["bytes_per_device"]["arguments"] \
        > seq["bytes_per_device"]["arguments"]
    assert seq["collective_bytes_per_device"]["all-reduce"] \
        > heads["collective_bytes_per_device"]["all-reduce"]


@pytest.mark.parametrize("arch", list_archs())
def test_params_equal_the_jax_count(arch):
    jparams = jbuild(jget_config(arch)).abstract_params()
    import jax
    want = sum(math.prod(leaf.shape) if leaf.shape else 1
               for leaf in jax.tree.leaves(jparams))
    assert dryrun.param_count(get_config(arch)) == want


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_jax_formula(arch):
    """repro/launch/dryrun.py:305-311, on each shape the arch runs."""
    cfg = get_config(arch)
    n = dryrun.param_count(cfg)
    for name in cfg.shape_names:
        shape = SHAPES[name]
        want = 6 * n * shape.tokens if shape.kind == "train" \
            else 2 * n * (shape.tokens if shape.kind == "prefill"
                          else shape.global_batch)
        if cfg.is_moe:
            active = jget_config(arch).param_count(active_only=True)
            dense_total = jget_config(arch).param_count(active_only=False)
            want = int(want * active / max(1, dense_total))
        assert dryrun.model_flops(cfg, cfg, shape, n) == want


def test_collective_pricer_on_synthetic_events():
    """Ring factors as the JAX dry run's (all-reduce 2x its operand,
    all-gather its result, reduce-scatter its operand), each priced at its
    link: NVLink within a node of 8, a GPU's NIC across nodes; a group of
    one puts nothing on the wire."""
    node = tuple(range(8))
    across = (0, 8)
    events = [("all-reduce", 16 * 128 * 4, 16 * 128 * 4, node),
              ("all-gather", 32 * 32 * 2, 64 * 32 * 2, across),
              ("reduce-scatter", 16 * 128 * 4, 4 * 128 * 4, node),
              ("all-reduce", 1 << 20, 1 << 20, (3,))]
    out = dryrun.price_collectives(events)
    assert out["all-reduce"] == 2.0 * 16 * 128 * 4
    assert out["all-gather"] == 64 * 32 * 2
    assert out["reduce-scatter"] == 16 * 128 * 4
    assert out["total"] == (out["all-reduce"] + out["all-gather"]
                            + out["reduce-scatter"])
    nvlink, nic = perfmodel.H100_NVLINK_BYTES_PER_S, \
        perfmodel.H100_NIC_BYTES_PER_S
    assert out["seconds"] == pytest.approx(
        (out["all-reduce"] + out["reduce-scatter"]) / nvlink
        + out["all-gather"] / nic)
    assert perfmodel.link_bytes_per_s(range(8, 16)) == nvlink
    assert perfmodel.link_bytes_per_s(range(4, 12)) == nic


def test_counter_records_c10d_ops_of_a_fake_world():
    """dist.all_reduce over a mesh axis, a DTensor gathered whole: their
    kinds, operand and result bytes and global ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard, Replicate

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        counter = dryrun.StepCounter()
        with FakeTensorMode():
            t = torch.empty(256)
            d = DTensor.from_local(torch.empty(16, 8), mesh,
                                   [Shard(0), Replicate()], run_check=False)
            with counter:
                dist.all_reduce(t, group=mesh.get_group("model"))
                d.full_tensor()
    finally:
        dist.destroy_process_group()
    kinds = [(k, op, res, ranks) for k, op, res, ranks in counter.events]
    assert ("all-reduce", 1024, 1024, (0, 1, 2, 3)) in kinds
    assert ("all-gather", 16 * 8 * 4, 32 * 8 * 4, (0, 4)) in kinds


def _fake_counts(fn):
    flops = FlopCounterMode(display=False)
    with FakeTensorMode(), flops:
        out = fn()
    return out, flops.get_total_flops()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_lse", [True, False])
def test_flash_ops_fake_shapes_and_flops(causal, with_lse):
    B, Hq, Hkv, Sq, Sk, D = 2, 8, 2, 384, 512, 128

    def run():
        q = torch.empty(B, Hq, Sq, D, dtype=torch.bfloat16)
        k = torch.empty(B, Hkv, Sk, D, dtype=torch.bfloat16)
        v = torch.empty_like(k)
        out, lse = kflash.fwd_op(q, k, v, causal, with_lse)
        return out, lse

    (out, lse), flops = _fake_counts(run)
    assert tuple(out.shape) == (B, Hq, Sq, D) and out.dtype == torch.bfloat16
    assert tuple(lse.shape) == ((B, Hq, Sq) if with_lse else (0,))
    assert lse.dtype == torch.float32
    assert flops == bounds.flash_bound((B, Hq, Hkv, Sq, Sk, D), causal, 2)[1]

    def run_bwd():
        q = torch.empty(B, Hq, Sq, D, dtype=torch.bfloat16)
        k = torch.empty(B, Hkv, Sk, D, dtype=torch.bfloat16)
        o = torch.empty_like(q)
        lse = torch.empty(B, Hq, Sq, dtype=torch.float32)
        return kflash.bwd_op(q, k, torch.empty_like(k), o, lse,
                             torch.empty_like(q), causal)

    (dq, dk, dv), flops = _fake_counts(run_bwd)
    assert tuple(dq.shape) == (B, Hq, Sq, D)
    assert tuple(dk.shape) == tuple(dv.shape) == (B, Hkv, Sk, D)
    assert flops == bounds.bwd_bound((B, Hq, Hkv, Sq, Sk, D), causal, 2)[1]


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("skip", [True, False])
def test_ssd_ops_fake_shapes_and_flops(grouped, skip):
    B, L, H, P, N = 2, 200, 8, 64, 16

    def inputs():
        x = torch.empty(B, L, H, P, dtype=torch.bfloat16)
        dt = torch.empty(B, L, H)
        a = torch.empty(H)
        G = 1 if grouped else H
        b = torch.empty(B, L, G, N, dtype=torch.bfloat16)
        c = torch.empty_like(b)
        return x, dt, a, b, c, (torch.empty(H) if skip else None)

    def run():
        x, dt, a, b, c, d = inputs()
        return kssd.fwd_op(x, dt, a, kssd.expand_heads(b, H),
                           kssd.expand_heads(c, H), d)

    y, flops = _fake_counts(run)
    assert tuple(y.shape) == (B, L, H, P) and y.dtype == torch.bfloat16
    assert flops == bounds.ssd_bound((B, L, H, P, N), 2, grouped,
                                     chunk=kssd.CHUNK)[1]

    def run_bwd():
        x, dt, a, b, c, d = inputs()
        return kssd.bwd_op(x, dt, a, b, c, torch.empty_like(x), d)

    grads, flops = _fake_counts(run_bwd)
    shapes = [tuple(g.shape) for g in grads]
    G = 1 if grouped else H
    assert shapes == [(B, L, H, P), (B, L, H), (H,), (B, L, G, N),
                      (B, L, G, N), (H,) if skip else (0,)]
    assert flops == bounds.ssd_bwd_bound((B, L, H, P, N), 2, grouped, skip,
                                         kssd.CHUNK)[1]


def test_fake_ops_refuse_what_the_kernels_refuse():
    with FakeTensorMode():
        q = torch.empty(1, 2, 16, 8)  # head_dim 8
        with pytest.raises(ValueError, match="head_dim"):
            kflash.fwd_op(q, q, q, True, False)


def _rng_tensors(shapes, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=g, dtype=torch.float32).to(dtype)
            for s in shapes]


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ops_on_the_cpu_give_the_plain_versions(causal):
    q, k, v, do = _rng_tensors([(1, 4, 24, 16), (1, 2, 32, 16),
                                (1, 2, 32, 16), (1, 4, 24, 16)])
    out, lse = torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal,
                                                         True)
    torch.testing.assert_close(out, ref.attention(q, k, v, causal=causal),
                               rtol=0, atol=0)
    s = torch.einsum("bhqd,bhkd->bhqk", q,
                     k.repeat_interleave(2, dim=1)) * 16 ** -0.5
    if causal:
        hidden = torch.ones(24, 32, dtype=torch.bool).triu(32 - 24 + 1)
        s = s.masked_fill(hidden, float("-inf"))
    torch.testing.assert_close(lse, ref.attention_lse(q, k, causal=causal),
                               rtol=0, atol=0)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-4,
                               atol=1e-4)
    grads = torch.ops.repro_torch.flash_attention_bwd(q, k, v, out, lse, do,
                                                      causal)
    for got, want in zip(grads, ref.attention_bwd(q, k, v, do,
                                                  causal=causal)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("grouped", [True, False])
def test_ssd_ops_on_the_cpu_give_the_plain_versions(grouped):
    B, L, H, P, N = 1, 80, 4, 16, 8
    G = 1 if grouped else H
    x, dy, b, c, d = _rng_tensors([(B, L, H, P), (B, L, H, P), (B, L, G, N),
                                   (B, L, G, N), (H,)])
    dt = torch.nn.functional.softplus(_rng_tensors([(B, L, H)], seed=1)[0])
    a = -torch.rand(H, generator=torch.Generator().manual_seed(2)) - 0.5
    y = torch.ops.repro_torch.ssd_scan_fwd(x, dt, a, kssd.expand_heads(b, H),
                                           kssd.expand_heads(c, H), d)
    torch.testing.assert_close(
        y, ref.ssd_scan(x, dt, a, kssd.expand_heads(b, H),
                        kssd.expand_heads(c, H), d_skip=d), rtol=0, atol=0)
    grads = torch.ops.repro_torch.ssd_scan_bwd(x, dt, a, b, c, dy, d)
    want = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d, chunk=kssd.CHUNK)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_wrappers_still_refuse_cpu_tensors():
    """The wrappers check the device before the op: a CPU tensor reaches
    the plain version only through a direct call of the op."""
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, q, q, impl="pallas")


def test_peak_counts_live_storages():
    """Two 4 KiB tensors live at once, then one freed before a third: the
    peak is 8 KiB over 4 KiB of arguments; views share their storage."""
    counter = dryrun.StepCounter()
    with FakeTensorMode():
        arg = torch.empty(1024)
        held = counter.hold([arg])
        with counter:
            a = arg * 2.0
            view = a.view(32, 32)
            del a
            b = view + 1.0
            del view, b
            c = arg + 1.0
        del c
    assert held == 4096
    assert counter.peak == 3 * 4096
    assert counter.live == 4096
    # arg read + a written, a read + b written, arg read + c written
    assert counter.hbm_bytes == 6 * 4096


def test_fake_tensors_take_the_kernel_ops_under_auto():
    """On the CPU, "auto" runs the plain versions for real tensors and the
    kernels' ops for fake ones (one op each, with the kernels' shapes)."""
    counter = dryrun.StepCounter()
    with FakeTensorMode():
        q = torch.empty((1, 2, 256, 64), dtype=torch.bfloat16)
        x = torch.empty((1, 256, 2, 64), dtype=torch.bfloat16)
        dt = torch.empty((1, 256, 2))
        bc = torch.empty((1, 256, 1, 16), dtype=torch.bfloat16)
        with counter:
            out = ops.flash_attention(q, q, q, impl="auto")
            y = ops.ssd(x, dt, torch.empty(2), bc, bc, impl="auto")
    assert out.shape == q.shape and y.shape == x.shape
    assert counter.kernel_calls == {"flash_attention_fwd": 1,
                                    "ssd_scan_fwd": 1}


def test_record_keys_as_the_jax_dry_run():
    rec = dryrun.lower_cell("mamba2-2.7b", "decode_32k", mesh_shape=(2, 2),
                            variant="smoke", batch=4, seq=256)
    for key in ("status", "chips", "bytes_per_device", "hbm_ok", "params",
                "flops_per_device", "collective_bytes_per_device",
                "roofline", "traffic_model_bytes_global", "model_flops",
                "model_vs_hlo_flops"):
        assert key in rec, key
    assert set(rec["bytes_per_device"]) == {"arguments", "outputs", "temps",
                                            "peak_estimate"}
    assert not dist.is_initialized()
    assert np.isfinite(rec["roofline"]["step_s"])
