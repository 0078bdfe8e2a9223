"""End-to-end example: train a ~100M-parameter model for a few hundred steps.

Counterpart of ``examples/train_lm.py``: the full training path of
``launch/train.py`` (chunk-store corpus, festivus reads, prefetch onto the
device, the train step, manifest-committed checkpoints) with a
purpose-built ~100M llama-family config, which attends with the plain
version (``attention_impl="ref"``) as the JAX example's does.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \\
        [--device cpu]
"""

import argparse

from repro_torch.configs.base import _REGISTRY, ConfigEntry, ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import train as train_mod

M100 = ModelConfig(
    arch_id="llama-100m",
    family="dense",
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=512,  # matches the synthetic corpus
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    attention_impl="ref",
    remat=False,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # before any output: the card, or the CPU

    # register the example config so launch.train can select it
    if "llama-100m" not in _REGISTRY:
        _REGISTRY["llama-100m"] = ConfigEntry(full=M100, smoke=M100)

    n = M100.param_count()
    print(f"[train_lm] {M100.arch_id}: {n / 1e6:.1f}M params, "
          f"{args.steps} steps at batch {args.batch} x seq {args.seq}")
    out = train_mod.run(argparse.Namespace(
        arch="llama-100m", variant="full", steps=args.steps,
        batch=args.batch, seq=args.seq, lr=1e-3, warmup=10, seed=0,
        moments="fp32", microbatches=1, mesh=False, mesh_data=1,
        mesh_model=1, data_shards=8, store=None, ckpt_every=max(50, args.steps // 4),
        ckpt_codec="zlib", log_every=max(10, args.steps // 10),
        resume=False, preempt_at=0, device=args.device))
    hist = out["history"]
    print(f"[train_lm] nll {hist[0]['nll']:.3f} -> {hist[-1]['nll']:.3f} "
          f"over {out['final_step']} steps; "
          f"checkpoints at {out['checkpoints']}")
    assert hist[-1]["nll"] < hist[0]["nll"]
    print("TRAIN_LM_OK")


if __name__ == "__main__":
    main()
