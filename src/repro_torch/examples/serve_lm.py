"""Serving example: batched greedy generation with KV caches.

Counterpart of ``examples/serve_lm.py``: the decode step at smoke scale for
two architecture families, dense GQA (llama3-8b) and attention-free SSM
(mamba2-2.7b), to show the cache-against-state contrast.  Weights are
random, drawn from a seed.  The smoke configs attend with
``attention_impl="ref"`` and generation runs the decode path, so this
example launches no kernel, on the card as on the CPU.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

import time

import torch

from repro_torch.configs import get_config
from repro_torch.examples import device_arg
from repro_torch.kernels.backend import DeviceLike, resolve_device
from repro_torch.models import build
from repro_torch.train import greedy_generate

ARCHS = ("llama3-8b", "mamba2-2.7b")
BATCH, PROMPT, STEPS, MAX_LEN = 4, 8, 24, 64


def state_bytes(state) -> int:
    """Bytes of the tensors in a decode state (KV caches or SSM states)."""
    if isinstance(state, torch.Tensor):
        return state.numel() * state.element_size()
    if isinstance(state, (list, tuple)):
        return sum(state_bytes(s) for s in state)
    return 0


def main(device: DeviceLike = None):
    dev = resolve_device(device)
    for arch in ARCHS:
        cfg = get_config(arch, "smoke")
        model = build(cfg, device=dev)
        params = model.init(0)
        g = torch.Generator(device=dev).manual_seed(1)
        prompt = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT),
                               generator=g, device=dev, dtype=torch.int32)
        t0 = time.perf_counter()
        out = greedy_generate(model, params, prompt, num_steps=STEPS,
                              max_len=MAX_LEN).cpu()
        dt = time.perf_counter() - t0
        nbytes = state_bytes(model.init_decode(params, BATCH, MAX_LEN))
        kind = ("KV cache grows with context" if cfg.num_heads
                else "O(1) SSM state")
        print(f"[{arch:12s}] generated {tuple(out.shape)} in {dt:.1f}s "
              f"({BATCH * STEPS / dt:.1f} tok/s, {dev}); decode state "
              f"{nbytes / 1e6:.2f} MB ({kind})")
    print("SERVE_LM_OK")


if __name__ == "__main__":
    main(device_arg(__doc__))
