"""End-to-end training CLI on one card (or the CPU).

The single-device counterpart of ``repro/launch/train.py``: chunk-store
corpus -> festivus-backed reads -> ``PrefetchLoader`` onto the device ->
the train step on autograd (the hand-written flash attention and SSD
forward and backward kernels on the card) -> chunk-store checkpoints,
manifest last, in the JAX package's layout (``{"params": ...,
"opt": AdamState(...)}``, so either package restores them) -> resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --variant smoke --steps 20 --batch 8 --seq 128 [--device cpu]

The JAX CLI's flags, plus ``--device`` (default: the card),
``--warmup`` (its warmup steps, 10 there) and ``--ckpt-codec`` (``zlib``
as there, or ``raw``).  Parameters are f32 masters.  ``--mesh-data`` and
``--mesh-model`` above 1 raise: meshes are ``ROADMAP.md`` queue 1 item 8.
Every family trains on the card: an ssm or hybrid arch runs the SSD's
forward kernel and its backward kernel (``kernels.ssd_scan.SsdScanFn``)
in each mamba layer.  Fault tolerance is exercised with ``--preempt-at
N``, as there.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import Festivus, InMemoryObjectStore, LocalDirObjectStore
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.data import (PrefetchLoader, TokenDataset, TokenDatasetSpec,
                              write_corpus)
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import build
from repro_torch.train import CheckpointManager, OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt_mod


def make_store(path: Optional[str]):
    store = LocalDirObjectStore(path) if path else InMemoryObjectStore()
    fs = Festivus(store)
    if path:
        fs.sync_metadata()
    return ChunkStore(fs, "data")


def _map_layout(fn, layout):
    return {k: _map_layout(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in layout.items()}


def state_to_numpy(params, opt_state: opt_mod.AdamState,
                   cfg: ModelConfig) -> dict:
    """The train state in the JAX package's layout, as numpy arrays."""
    return {"params": convert.params_to_numpy(params, cfg),
            "opt": opt_mod.AdamState(
                step=opt_state.step.cpu().numpy(),
                mu=convert.params_to_numpy(opt_state.mu, cfg),
                nu=convert.params_to_numpy(opt_state.nu, cfg))}


def restore_state(ckpt: CheckpointManager, cfg: ModelConfig,
                  opt_cfg: OptimizerConfig, device, step=None):
    """The checkpointed train state in the JAX layout -> (params, opt
    state) on ``device``: f32 masters, moments as ``opt_cfg`` keeps
    them."""
    int8 = opt_cfg.moments_dtype == "int8"

    def moment(shape):
        if int8 and opt_mod.quantizable(shape):
            return opt_mod.QTensor(q=np.zeros((), np.int8),
                                   scale=np.zeros((), np.float32),
                                   shape=shape)
        return np.zeros((), np.float32)

    layout = convert.jax_layout(cfg)
    template = {"params": _map_layout(lambda _: np.zeros((), np.float32),
                                      layout),
                "opt": opt_mod.AdamState(step=np.zeros((), np.int32),
                                         mu=_map_layout(moment, layout),
                                         nu=_map_layout(moment, layout))}
    restored = ckpt.restore(template, step=step)
    f32 = torch.float32
    params = convert.params_from_numpy(restored["params"], cfg, device, f32)
    opt = restored["opt"]
    state = opt_mod.AdamState(
        step=torch.as_tensor(opt.step, dtype=torch.int32, device=device),
        mu=convert.params_from_numpy(opt.mu, cfg, device, f32),
        nu=convert.params_from_numpy(opt.nu, cfg, device, f32))
    return params, state


def corpus_spec(args, cfg: ModelConfig) -> TokenDatasetSpec:
    """The synthetic corpus a run reads, sized as repro/launch/train.py sizes it."""
    return TokenDatasetSpec(num_shards=args.data_shards,
                            shard_tokens=max(4 * (args.seq + 1) * args.batch,
                                             16384),
                            vocab_size=min(cfg.vocab_size, 512))


def optimizer_config(args) -> OptimizerConfig:
    return OptimizerConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                           decay_steps=max(args.steps, 20),
                           moments_dtype=args.moments)


def checkpoints(args, cs: ChunkStore) -> CheckpointManager:
    return CheckpointManager(cs, name=f"ckpt-{args.arch}", keep=2,
                             codec=args.ckpt_codec)


def run(args, cfg: Optional[ModelConfig] = None,
        cs: Optional[ChunkStore] = None) -> dict:
    """One training run; ``cfg`` stands in for ``--arch``/``--variant``'s
    config and ``cs`` for ``--store``'s chunk store where given (a caller
    that resumes in the same process passes the same store).  Returns the
    logged history, the final step, the checkpoints kept and the final
    ``params`` and ``opt_state``."""
    if args.mesh_data > 1 or args.mesh_model > 1:
        raise NotImplementedError(
            "--mesh-data/--mesh-model > 1: the port trains on one card; "
            "meshes and sharding are ROADMAP.md queue 1 item 8")
    dev = resolve_device(args.device)
    cfg = cfg or get_config(args.arch, args.variant)
    model = build(cfg, device=dev)

    cs = cs if cs is not None else make_store(args.store)
    spec = corpus_spec(args, cfg)
    if not cs.exists(spec.name):
        write_corpus(cs, spec)
    ckpt = checkpoints(args, cs)
    opt_cfg = optimizer_config(args)
    train_step = make_train_step(model, opt_cfg,
                                 num_microbatches=args.microbatches)

    start_step = 0
    if args.resume and ckpt.latest_step() is not None:
        params, opt_state = restore_state(ckpt, cfg, opt_cfg, dev)
        start_step = int(ckpt.latest_step())
        print(f"[train] resumed from step {start_step}")
    else:
        params = model.init(args.seed, param_dtype=torch.float32)
        opt_state = opt_mod.init(params, opt_cfg,
                                 convert.reference_shapes(cfg))

    data = TokenDataset(cs, spec, rank=0, num_ranks=1)
    batches = ({"tokens": b["tokens"], "labels": b["labels"]}
               for b in data.batches(args.batch, args.seq,
                                     start_step=start_step))
    loader = PrefetchLoader(batches, depth=2, device=dev)

    history = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = next(loader)
        params, opt_state, metrics = train_step(params, opt_state, batch)
        if args.preempt_at and step == args.preempt_at:
            print(f"[train] simulating pre-emption at step {step}")
            # flush in-flight async saves so tests are deterministic; a
            # real pre-emption may lose them — either way the
            # manifest-last protocol only exposes complete checkpoints
            ckpt.wait()
            return {"preempted_at": step,
                    "resume_from": ckpt.latest_step(),
                    "params": params, "opt_state": opt_state}
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            ckpt.wait()
            ckpt.save_async(step + 1, state_to_numpy(params, opt_state, cfg))
        if (step + 1) % args.log_every == 0 or step == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["tok_per_s"] = round(
                args.batch * args.seq * (step + 1 - start_step)
                / max(1e-9, time.time() - t0), 1)
            history.append(m)
            print("[train]", json.dumps(
                {k: (round(v, 4) if isinstance(v, float) else v)
                 for k, v in m.items()}))
    ckpt.wait()
    return {"history": history, "final_step": args.steps,
            "checkpoints": ckpt.steps(), "params": params,
            "opt_state": opt_state}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--variant", default="smoke",
                    help="smoke (CPU-sized) or full")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moments", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--data-shards", type=int, default=8)
    ap.add_argument("--store", default=None,
                    help="local dir for the object store (default in-memory)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-codec", default="zlib", choices=["zlib", "raw"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preempt-at", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    return ap


def main(argv=None):
    out = run(parser().parse_args(argv))
    print("[train] done:", json.dumps(
        {k: v for k, v in out.items()
         if k not in ("history", "params", "opt_state")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
