"""Decode on a mesh (``launch/train.py:make_mesh_decode_step``) on gloo,
several ranks on the CPU, every family, both cache layouts.

Each case feeds a prompt token by token through the mesh's decode step
(the prompt crosses at least one boundary between the caches' sequence
shards) and then decodes a few tokens greedily, from the JAX package's
initial parameters (a smoke config, f32 weights, bf16 KV caches) placed by
the rule table, the caches by ``decode_shardings``.  The tests hold what
the ranks wrote

* against the port's single-process ``decode_step`` on the same
  parameters and tokens, and against the JAX package's jitted
  ``decode_step`` on the same numpy parameters and tokens: every step's
  logits under ``tests/test_torch_lm.py``'s ``DECODE_TOL``, and the greedy
  tokens identical (also those of ``greedy_generate`` run on the
  ``MeshModel``);
* the decode state gathered whole after the run against the
  single-process state: every stored value within ``DECODE_TOL`` of the
  single process's before its rounding to the cache's dtype (one step of
  bf16 apart at most beyond it), every position past the caches' length
  untouched (zero).

A module fixture starts the ranks once (``tests/torch_tp_cases.py``: one
world a mesh shape, all at once, the references computed while they
run).  The cases: llama3-8b and dbrx-132b at 1 x 2, 1 x 4 and 2 x 2
under ``cache_shard`` "seq" (split-K) and "heads" (the KV heads over
``model`` where they divide it, else replicated and written whole on
every rank), six query heads on two KV heads at 1 x 4, a ``max_len`` the
axis does not divide (the guard leaves the positions whole), batch 1 at
2 x 2 (the ``long_500k`` layout: positions over data x model, reductions
over the whole world) for mamba2-2.7b and jamba, mamba2 with 6 heads on 4
ranks (its caches replicated or sharded unlike its heads), and seamless
(its cross
K/V split by sequence, the flash kernel's LSE combine; and by KV head)
and internvl2-1b at 1 x 2.

``test_split_k_pieces_match_decode_attention`` holds the split-K pieces
of ``ref.decode_attention`` on 1, 2 and 4 shards of f32 caches against
the whole, and at one shard bit for bit; the flash-with-LSE entry and its
merge are held on the CPU against the whole attention, and its kernel
route refuses to fall back.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as jbuild
from repro.models import encdec as jencdec
from repro.models.model_zoo import _padded_cfg as jpadded_cfg
from repro.train.serve_step import greedy_generate as jgreedy_generate
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import build, encdec
from repro_torch.models.model_zoo import _padded_cfg
from repro_torch.train.checkpoint import flatten_with_path
from torch_tp_cases import HEADS_6_2, cfgs, inputs, run_ranks

DECODE_TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_torch_lm.py
PROMPT, STEPS = 6, 4
LLAMA, DBRX = "llama3-8b", "dbrx-132b"
#: 6 SSM heads of 16 channels on 4 ranks (2, 2, 1, 1 heads): the guard
#: replicates the state over ``model`` (6 heads), while the conv tail's 96
#: channels shard evenly across the heads' (24 a rank against 32 or 16)
MAMBA_6_HEADS = {"d_model": 48}

#: name -> (arch, config change, (data, model), frontend frames,
#: cache_shard, batch, max_len)
CASES = {
    **{f"{tag}_{d}x{m}_{shard}": (arch, {}, (d, m), 0, shard, 4, 16)
       for tag, arch in (("llama", LLAMA), ("dbrx", DBRX))
       for d, m in ((1, 2), (1, 4), (2, 2))
       for shard in ("seq", "heads")},
    **{f"heads62_1x4_{shard}": (LLAMA, HEADS_6_2, (1, 4), 0, shard, 4, 16)
       for shard in ("seq", "heads")},
    "llama_1x2_len15": (LLAMA, {}, (1, 2), 0, "seq", 4, 15),
    "mamba_b1_2x2": ("mamba2-2.7b", {}, (2, 2), 0, "seq", 1, 16),
    "mamba_6heads_1x4": ("mamba2-2.7b", MAMBA_6_HEADS, (1, 4), 0, "seq", 4,
                         16),
    "jamba_b1_2x2": ("jamba-v0.1-52b", {}, (2, 2), 0, "seq", 1, 16),
    "seamless_1x2_seq": ("seamless-m4t-large-v2", {}, (1, 2), 24, "seq", 4,
                         16),
    "seamless_1x2_heads": ("seamless-m4t-large-v2", {}, (1, 2), 24, "heads",
                           4, 16),
    "internvl_1x2_seq": ("internvl2-1b", {}, (1, 2), 0, "seq", 4, 16),
}


def _ref_key(case):
    arch, change, _, frames, _, batch, max_len = case
    return arch, tuple(sorted(change.items())), frames, batch, max_len


@functools.lru_cache(maxsize=None)
def references(arch, change_items, frames, batch, max_len):
    """The port's single-process decode and the JAX package's on a case's
    parameters: each step's logits, the greedy tokens, the final state
    (the port's, whole, by path) and the JAX greedy tokens."""
    jcfg, cfg = cfgs(arch, dict(change_items))
    jparams, tokens, front = inputs(arch, change_items, frames)
    prompt = tokens[:batch, :PROMPT]
    model = build(cfg, device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                               "cpu", torch.float32)
    jmodel = jbuild(jcfg)
    with torch.no_grad():
        if cfg.is_encdec:
            memory = encdec.encode(params, _padded_cfg(cfg),
                                   torch.from_numpy(front[:batch]))
            state = model.init_decode(params, batch, max_len, memory=memory)
            jmem = jencdec.encode(jparams, jpadded_cfg(jcfg),
                                  jnp.asarray(front[:batch]))
            jstate = jmodel.init_decode(jparams, batch, max_len, memory=jmem)
        else:
            state = model.init_decode(params, batch, max_len)
            jstate = jmodel.init_decode(jparams, batch, max_len)
        jstep = jax.jit(jmodel.decode_step)
        logits, jlogits, generated = [], [], []
        token = torch.from_numpy(prompt[:, :1])
        for t in range(PROMPT + STEPS):
            if t < PROMPT:
                token = torch.from_numpy(prompt[:, t:t + 1])
            else:
                generated.append(token)
            jstate, jout = jstep(jparams, jstate, jnp.asarray(token.numpy()))
            state, out = model.decode_step(params, state, token)
            logits.append(out.numpy().copy())
            jlogits.append(np.asarray(jout, dtype=np.float32))
            token = out[:, -1:, :cfg.vocab_size].argmax(dim=-1).to(
                torch.int32)
    jtokens = jgreedy_generate(
        jmodel, jparams, jnp.asarray(prompt), STEPS, max_len=max_len,
        frontend=None if not cfg.is_encdec else jnp.asarray(front[:batch]))
    whole = {"/".join(str(k) for k in path): t.float().numpy().copy()
             for path, t in flatten_with_path(state)
             if isinstance(t, torch.Tensor)}
    return {"logits": np.stack(logits, axis=1),
            "jax_logits": np.stack(jlogits, axis=1),
            "tokens": torch.cat(generated, dim=1).numpy(),
            "jax_tokens": np.asarray(jtokens), "state": whole}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    others = {name: ("decode", (arch, change, mesh, frames))
              for name, (arch, change, mesh, frames, *_) in CASES.items()}
    options = {name: {"cache_shard": case[4], "batch": case[5],
                      "max_len": case[6], "prompt": PROMPT, "steps": STEPS}
               for name, case in CASES.items()}

    def refs():
        for case in CASES.values():
            references(*_ref_key(case))

    return run_ranks(tmp_path_factory.mktemp("tp_decode"), {}, others,
                     options, refs)


def _assemble(results, key):
    """Each rank's rows of ``key`` put back in the global batch's order."""
    batch = max(int(r["rows"].max()) for r in results) + 1
    first = results[0][key]
    out = np.zeros((batch,) + first.shape[1:], dtype=first.dtype)
    for r in results:
        out[r["rows"]] = r[key]
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_logits_match_the_single_process_and_jax(ranks, name):
    want = references(*_ref_key(CASES[name]))
    got = _assemble(ranks[name], "logits")
    assert got.shape == want["logits"].shape
    np.testing.assert_allclose(got, want["logits"], **DECODE_TOL)
    np.testing.assert_allclose(got, want["jax_logits"], **DECODE_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_tokens_equal_the_single_process_and_jax(ranks, name):
    want = references(*_ref_key(CASES[name]))
    for key in ("tokens", "greedy"):
        got = _assemble(ranks[name], key)
        np.testing.assert_array_equal(got, want["tokens"], err_msg=key)
        np.testing.assert_array_equal(got, want["jax_tokens"], err_msg=key)


def _bf16_step(x: np.ndarray) -> np.ndarray:
    """One bf16 step (unit in the last place) at each value's magnitude."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return 2.0 ** (np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_decode_state_matches_the_single_process(ranks, name):
    """The state gathered whole: the same on every rank; each value within
    DECODE_TOL of the single process's, and a value the cache stores in
    bf16 at most one bf16 step further (the two runs round values that
    agree to DECODE_TOL); every KV position past the length zero."""
    case = CASES[name]
    want = references(*_ref_key(case))["state"]
    results = ranks[name]
    for r in results[1:]:
        assert r["state"].keys() == results[0]["state"].keys()
        for k, v in r["state"].items():
            np.testing.assert_array_equal(v, results[0]["state"][k])
    got = results[0]["state"]
    assert got.keys() == want.keys()
    n = PROMPT + STEPS
    if "mamba" not in name:  # the KV caches' host-int lengths
        assert set(results[0]["lengths"]) == {n}
    for k, v in got.items():
        w = want[k]
        assert v.shape == w.shape, k
        limit = DECODE_TOL["atol"] + DECODE_TOL["rtol"] * np.abs(w)
        if k.endswith(("/k", "/v")) or "cross" in k:
            limit = limit + _bf16_step(w)
        assert (np.abs(v - w) <= limit).all(), (k, np.abs(v - w).max())
        if k.endswith(("/k", "/v")) and "cross" not in k:
            assert not v[:, :, n:].any(), k


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_split_k_pieces_match_decode_attention(shards):
    """ref.decode_attention's split-K pieces over ``shards`` shards of f32
    caches of 24 positions, 17 of them valid (the last shard partly, one
    shard empty at 4), combined as ``attention.attn_decode_step`` combines
    them over ranks (max, then the sum of exponentials, then P·V partials
    summed) -> the whole to f32 3e-5; at one shard bit for bit."""
    g = torch.Generator().manual_seed(shards)
    B, Hq, Hkv, S, D, n = 2, 8, 2, 24, 16, 17
    q = torch.randn((B, Hq, 1, D), generator=g)
    k = torch.randn((B, Hkv, S, D), generator=g)
    v = torch.randn((B, Hkv, S, D), generator=g)
    want = ref.decode_attention(q, k, v, n)
    width = S // shards
    parts = []
    for r in range(shards):
        valid = min(max(n - r * width, 0), width)
        sk = k[:, :, r * width:(r + 1) * width]
        parts.append((ref.decode_scores(q, sk, valid),
                      v[:, :, r * width:(r + 1) * width]))
    m = torch.stack([ref.decode_max(s) for s, _ in parts]).amax(dim=0)
    es = [ref.decode_exp(s, m) for s, _ in parts]
    total = sum(e.sum(dim=-1) for e in es)
    out = sum(ref.decode_pv(e, total, sv) for e, (_, sv) in zip(es, parts))
    got = out.reshape(B, Hq, 1, D).to(q.dtype)
    if shards == 1:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, want, rtol=3e-5, atol=3e-5)
    if shards == 4:
        assert parts[-1][0].shape[-1] == 0  # positions 18-23: none valid


def test_cases_cross_a_shard_boundary():
    """Each split case's prompt and tokens run past its first sequence
    shard."""
    for name, (_, _, (d, m), _, shard, batch, max_len) in CASES.items():
        ranks_split = (d * m if batch == 1 else m) if shard == "seq" else 1
        if max_len % ranks_split:
            ranks_split = 1
        if ranks_split > 1:
            assert PROMPT + STEPS > max_len // ranks_split, name


@pytest.mark.parametrize("shards", [1, 2, 4, 16])
def test_flash_lse_shards_combine_to_the_whole(shards):
    """``ops.flash_attention_lse`` on shards of the keys (its plain version
    on CPU tensors: ``ref.attention`` and ``ref.attention_lse``), merged by
    ``ops.combine_lse``, against attention over all the keys: a decode
    step's cross-attention (one query row, full) over 64 frames, f32, to
    3e-5; the merged log-sum-exp the whole one's."""
    g = torch.Generator().manual_seed(shards)
    q = torch.randn((2, 4, 1, 16), generator=g)
    k = torch.randn((2, 2, 64, 16), generator=g)
    v = torch.randn((2, 2, 64, 16), generator=g)
    n = 64 // shards
    pieces = [ops.flash_attention_lse(q, k[:, :, i:i + n], v[:, :, i:i + n],
                                      causal=False)
              for i in range(0, 64, n)]
    outs = torch.stack([o for o, _ in pieces])
    lses = torch.stack([lse for _, lse in pieces])
    got = ops.combine_lse(outs, lses)
    torch.testing.assert_close(got, ref.attention(q, k, v, causal=False),
                               rtol=3e-5, atol=3e-5)
    torch.testing.assert_close(torch.logsumexp(lses, dim=0),
                               ref.attention_lse(q, k, causal=False),
                               rtol=3e-5, atol=3e-5)


def test_flash_lse_kernel_route_never_takes_the_plain_version():
    """``impl="pallas"`` is the kernel: on CPU tensors it raises (the
    wrapper refuses them) rather than run the plain version, and under
    autograd it raises before that (no backward for the merge)."""
    q = torch.randn((1, 2, 1, 16))
    k = v = torch.randn((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention_lse(q, k, v, causal=False, impl="pallas")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention_lse(q.requires_grad_(), k, v, causal=False,
                                impl="pallas")
