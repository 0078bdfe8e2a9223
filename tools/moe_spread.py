"""How far bf16 rounding moves an MoE or hybrid model's logits through its
routing: a router near-tie sends a token to another expert.

    PYTHONPATH=src python tools/moe_spread.py --package port [--arch ...]
        [--scale 8] [--device cpu] [--batch 2] [--seq 256]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/moe_spread.py --package jax

Each arch's configuration at ``chip_smoke.py``'s depth (dbrx-132b 8
layers, llama4-maverick 1, jamba-v0.1-52b 16; llama3-8b 8, a dense
yardstick), its widths (d_model, heads, d_ff, the experts' d_ff) divided by
``--scale`` (1: full width, for the card) and its vocabulary cut to 4096,
random weights from seed 0, tokens from a numpy seed.  One JSON line per
arch:

* ``plain_spread`` (``--package port``): one bf16 prefill with each of the
  port's plain versions (attention ``ref`` and the SSD's sequential
  ``ref``, then both ``chunked``), which differ only in the order of their
  f32 sums: the logits' relative L2 distance and argmax agreement, and the
  share of (token, k) MoE assignments whose expert is not among the other
  run's top-k; ``held_routes``: the same with the second run routed, layer
  by layer, to the first run's experts (what the rounding does outside the
  routing);
* ``decode_vs_prefill`` (``--package port``): f32 activations over the
  bf16-stored weights at capacity factor E, ``--batch`` x 64 prompt tokens
  fed one by one through the decode path against one prefill, once with
  the bf16 KV cache (the JAX package's, whatever the activations' dtype)
  and once with an f32 one: tests/test_models.py:117-124's count of
  positions whose logits differ by more than 0.3, the argmax agreement,
  and the tokens routed differently in some layer;
* ``compiled_vs_op_by_op`` (``--package jax``): the JAX package's bf16
  forward compiled against the same forward run op by op
  (``jax.disable_jit``): XLA rounds fused elementwise chains at other
  places.

Each run imports one package: the port (``repro_torch``) or the JAX
package (``repro``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

DEPTH = {"dbrx-132b": 8, "llama4-maverick-400b-a17b": 1,
         "jamba-v0.1-52b": 16, "llama3-8b": 8}
VOCAB = 4096
DECODE_LEN = 64
NEAR_TIE_ATOL = 0.3  # tests/test_models.py:124


def cut(cfg, scale: int):
    return dataclasses.replace(
        cfg, num_layers=DEPTH[cfg.arch_id], d_model=cfg.d_model // scale,
        num_heads=max(1, cfg.num_heads // scale),
        num_kv_heads=max(1, cfg.num_kv_heads // scale),
        head_dim=cfg.head_dim, d_ff=cfg.d_ff // scale,
        moe_d_ff=cfg.moe_d_ff // scale, vocab_size=VOCAB)


def tokens(batch: int, length: int) -> np.ndarray:
    return np.random.default_rng(1).integers(0, VOCAB, (batch, length),
                                             dtype=np.int32)


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    got, want = got.astype(np.float64), want.astype(np.float64)
    return {"rel_l2": float(np.linalg.norm(got - want)
                            / np.linalg.norm(want)),
            "argmax_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .mean()),
            "max_abs_diff": float(np.abs(got - want).max())}


def run_port(arch: str, args) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build, moe, transformer

    def routed(fn):
        """fn's result and each MoE layer's top-k experts, in call order."""
        seen = []
        route = moe.route

        def record(*a, **kw):
            r = route(*a, **kw)
            seen.append(r.topk_idx)
            return r

        moe.route = record
        try:
            with torch.no_grad():
                return fn(), seen
        finally:
            moe.route = route

    def held(routes, fn):
        """fn's result with each MoE layer routed to ``routes``' experts."""
        top_k = moe.top_k
        given = iter(routes)

        def held_top_k(probs, k):
            idx = next(given)
            return probs.gather(-1, idx), idx

        moe.top_k = held_top_k
        try:
            with torch.no_grad():
                return fn()
        finally:
            moe.top_k = top_k

    def missing(a, b):
        """[B, S, K]: a's experts that are not among b's top-k."""
        return ~(a[..., :, None] == b[..., None, :]).any(-1)

    cfg = cut(get_config(arch), args.scale)
    model = build(cfg, device=args.device)
    params = model.init(0)
    out = {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "scale": args.scale, "device": args.device}

    toks = torch.from_numpy(tokens(args.batch, args.seq)).to(args.device)
    plain = {impl: build(dataclasses.replace(cfg, attention_impl=impl),
                         device=args.device) for impl in ("ref", "chunked")}

    def prefill(impl):
        return plain[impl].forward(params, tokens=toks,
                                   ssd_impl=impl)[0].float()

    (a, ra), (b, rb) = routed(lambda: prefill("ref")), routed(
        lambda: prefill("chunked"))
    spread = compare(a.cpu().numpy(), b.cpu().numpy())
    if ra:
        flips = [missing(x, y) for x, y in zip(ra, rb)]
        spread["route_flip_share"] = (sum(int(m.sum()) for m in flips)
                                      / sum(m.numel() for m in flips))
        b = held(ra, lambda: prefill("chunked"))
        spread["held_routes"] = compare(a.cpu().numpy(), b.cpu().numpy())
    out["plain_spread"] = spread
    del a, b

    if not cfg.is_moe:
        return out
    checked = build(dataclasses.replace(
        cfg, dtype="float32", capacity_factor=float(cfg.num_experts)),
        device=args.device)
    toks = torch.from_numpy(tokens(args.batch, DECODE_LEN)).to(args.device)
    full, prefill_routes = routed(
        lambda: checked.forward(params, tokens=toks)[0])
    out["decode_vs_prefill"] = {}
    for name, kv in (("bf16_kv_cache", torch.bfloat16),
                     ("f32_kv_cache", torch.float32)):
        def decode():
            state = transformer.init_block_caches(
                checked.cfg, args.batch, DECODE_LEN + 1, args.device, kv)
            steps = []
            for t in range(DECODE_LEN):
                state, logits = checked.decode_step(params, state,
                                                    toks[:, t:t + 1])
                steps.append(logits)
            return torch.cat(steps, 1)

        dec, step_routes = routed(decode)
        layers = len(prefill_routes)
        flipped = torch.zeros(toks.shape, dtype=torch.bool,
                              device=toks.device)
        for i, want in enumerate(prefill_routes):
            got = torch.cat(step_routes[i::layers], 1)  # [B, S, K]
            flipped |= missing(got, want).any(-1)
        pos_diff = (dec - full).abs().amax(dim=(0, 2))
        out["decode_vs_prefill"][name] = {
            "positions_over_atol": int((pos_diff > NEAR_TIE_ATOL).sum()),
            "positions": DECODE_LEN,
            "argmax_agreement": float((dec.argmax(-1) == full.argmax(-1))
                                      .double().mean()),
            "max_abs_diff": float(pos_diff.max()),
            "tokens_routed_differently": int(flipped.sum()),
            "tokens": int(flipped.numel())}
    return out


def run_jax(arch: str, args) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import build

    cfg = cut(get_config(arch), args.scale)
    model = build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(tokens(args.batch, args.seq))
    compiled, _ = model.forward(params, tokens=toks)
    with jax.disable_jit():
        op_by_op, _ = model.forward(params, tokens=toks)
    return {"arch": arch, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "scale": args.scale, "compiled_vs_op_by_op": compare(
                np.asarray(compiled.astype(jnp.float32)),
                np.asarray(op_by_op.astype(jnp.float32)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "jax"), default="port")
    ap.add_argument("--arch", default=",".join(DEPTH))
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    run = run_port if args.package == "port" else run_jax
    for arch in args.arch.split(","):
        print(json.dumps(run(arch, args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
