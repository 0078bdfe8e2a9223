"""Quickstart: the whole stack in a few minutes, on the card or the CPU.

Counterpart of ``examples/quickstart.py``:

1. Spin up an in-memory "cloud": object store + metadata KV + festivus.
2. Store imagery through the chunk store; read it back at 4 MiB blocks.
3. Run the paper's composite + segmentation on a synthetic tile (the
   ``composite`` and ``grad_mag`` kernels on the card).
4. Train a few steps of a (smoke-sized) assigned LM architecture on the
   festivus-backed token pipeline (f32 masters, AdamW; the smoke config
   attends with its plain version, ``attention_impl="ref"``, as in JAX).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import torch

from repro_torch.apps import composite, segmentation
from repro_torch.configs import get_config
from repro_torch.configs.festivus_imagery import SMOKE as IMG_CFG
from repro_torch.convert import reference_shapes
from repro_torch.core import ChunkStore, Festivus, InMemoryObjectStore
from repro_torch.data import TokenDataset, TokenDatasetSpec, imagery, write_corpus
from repro_torch.examples import device_arg
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import build
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt_mod


def main(device: DeviceLike = None):
    dev = resolve_device(device)
    # -- 1. the cloud --------------------------------------------------------
    store = InMemoryObjectStore()
    fs = Festivus(store)
    cs = ChunkStore(fs, "bucket")
    print("[1] festivus mounted over the object store")

    # -- 2. imagery in, imagery out -----------------------------------------
    spec = imagery.SceneSpec(tile_px=96, temporal_depth=6, seed=42)
    imagery.write_scene_stack(cs, "tiles/quickstart", spec, chunk_px=32)
    imgs, valid = imagery.read_scene_stack(cs, "tiles/quickstart")
    print(f"[2] stored+read a {imgs.shape} scene stack "
          f"({store.stats.bytes_written / 1e6:.1f} MB written, "
          f"cache hit rate {fs.stats.hit_rate():.0%})")

    # -- 3. the paper's analytics -------------------------------------------
    comp = composite.composite_tile(imgs, IMG_CFG, device=dev)
    labels, geo = segmentation.segment_tile(imgs, valid, IMG_CFG, device=dev)
    print(f"[3] cloud-free composite mean={comp.mean():.3f}; "
          f"segmentation found {len(geo['features'])} fields "
          f"(ground truth {spec.num_fields}; {dev})")

    # -- 4. train an assigned arch on the same data plane --------------------
    cfg = get_config("llama3-8b", "smoke")
    model = build(cfg, device=dev)
    tds = TokenDatasetSpec(num_shards=4, shard_tokens=16384,
                           vocab_size=cfg.vocab_size)
    write_corpus(cs, tds)
    ds = TokenDataset(cs, tds)
    opt_cfg = OptimizerConfig(learning_rate=3e-3, warmup_steps=5,
                              decay_steps=50)
    params = model.init(0, param_dtype=torch.float32)
    state = opt_mod.init(params, opt_cfg, reference_shapes(cfg))
    step = make_train_step(model, opt_cfg)
    first = last = None
    for i, batch in enumerate(ds.batches(8, 64)):
        if i >= 30:
            break
        params, state, m = step(params, state, {
            "tokens": torch.as_tensor(batch["tokens"]).to(dev),
            "labels": torch.as_tensor(batch["labels"]).to(dev)})
        first = first if first is not None else float(m["nll"])
        last = float(m["nll"])
    print(f"[4] trained {cfg.arch_id} (smoke) 30 steps: "
          f"nll {first:.2f} -> {last:.2f}")
    assert last < first
    print("QUICKSTART_OK")


if __name__ == "__main__":
    main(device_arg(__doc__))
