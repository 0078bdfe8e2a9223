"""How far bf16 rounding moves a deep Mamba-2 model's logits, on the CPU.

    PYTHONPATH=src python tools/depth_spread.py --package port [--layers 4,16,64]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/depth_spread.py --package jax

mamba2-2.7b's configuration cut to ``--d-model`` (default 256) and each of
``--layers``, random weights from seed 0, tokens from a numpy seed.  For each
depth and each of bf16 and f32 it prints one JSON line:

* ``decode_vs_forward``: the logits of 64 prompt tokens fed one by one
  through the decode path against one full forward pass, with
  tests/test_models.py:115-126's criterion (argmax agreement > 0.9,
  |decode - forward| <= 0.3 + 0.15 |forward|; ``excess`` > 0 fails it);
* ``plain_spread`` (``--package port`` only): the logits of one forward
  pass of 256 tokens with the SSD's two plain versions, sequential
  (``ssd_impl="ref"``) against chunked (``ssd_impl="chunked"``), which
  differ only in the order of their f32 sums.

Each run imports one package: the port (``repro_torch``) or the JAX
package (``repro``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

ARCH = "mamba2-2.7b"
VOCAB = 4096
DECODE_LEN, SPREAD_LEN, BATCH = 64, 256, 2


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    got, want = got.astype(np.float64), want.astype(np.float64)
    return {"rel_l2": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .mean()),
            "max_abs_diff": float(np.abs(got - want).max()),
            "excess": float((np.abs(got - want)
                             - (0.3 + 0.15 * np.abs(want))).max())}


def tokens(length: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, VOCAB, (BATCH, length),
                                             dtype=np.int32)


def run_port(cfg_change: dict) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build

    cfg = dataclasses.replace(get_config(ARCH), **cfg_change)
    model = build(cfg, device="cpu")
    params = model.init(0)
    out = {}
    with torch.no_grad():
        toks = torch.from_numpy(tokens(DECODE_LEN))
        full, _ = model.forward(params, tokens=toks)
        state = model.init_decode(params, BATCH, DECODE_LEN + 1)
        steps = []
        for t in range(DECODE_LEN):
            state, logits = model.decode_step(params, state, toks[:, t:t + 1])
            steps.append(logits)
        out["decode_vs_forward"] = compare(
            torch.cat(steps, 1).float().numpy(), full.float().numpy())
        toks = torch.from_numpy(tokens(SPREAD_LEN))
        seq, _ = model.forward(params, tokens=toks, ssd_impl="ref")
        chunked, _ = model.forward(params, tokens=toks, ssd_impl="chunked")
        out["plain_spread"] = compare(seq.float().numpy(),
                                      chunked.float().numpy())
    return out


def run_jax(cfg_change: dict) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import build

    cfg = dataclasses.replace(get_config(ARCH), **cfg_change)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(tokens(DECODE_LEN))
    full, _ = model.forward(params, tokens=toks)
    state = model.init_decode(params, BATCH, DECODE_LEN + 1)
    steps = []
    for t in range(DECODE_LEN):
        state, logits = model.decode_step(params, state, toks[:, t:t + 1])
        steps.append(logits)
    dec = np.asarray(jnp.concatenate(steps, 1).astype(jnp.float32))
    return {"decode_vs_forward": compare(
        dec, np.asarray(full.astype(jnp.float32)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), required=True)
    ap.add_argument("--layers", default="4,16,64")
    ap.add_argument("--d-model", type=int, default=256)
    args = ap.parse_args(argv)
    run = run_port if args.package == "port" else run_jax
    for layers in (int(n) for n in args.layers.split(",")):
        for dtype in ("bfloat16", "float32"):
            change = dict(num_layers=layers, d_model=args.d_model,
                          vocab_size=VOCAB, dtype=dtype)
            print(json.dumps({"package": args.package, "layers": layers,
                              "d_model": args.d_model, "dtype": dtype,
                              **run(change)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
