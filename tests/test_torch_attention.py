"""The port's attention (repro_torch.kernels: ref.attention,
ref.attention_chunked, ref.decode_attention, ops.flash_attention and the
flash kernel's wrapper checks) against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both packages (bf16
inputs are the same f32 numbers rounded to bf16 on each side).  The JAX side
runs its Pallas kernel in interpret mode and its jnp oracles; the port is
given CPU tensors, so it runs its plain PyTorch versions (the CUDA kernel is
held against those on the card, in tests/test_torch_cuda.py and
chip_smoke.py).  Tolerances are those of tests/test_kernels.py:45-47: f32
3e-5, bf16 2e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attention as kflash

# B, Hq, Hkv, Sq, Sk, D, causal: tests/test_kernels.py:53-60
ATTN_CASES = [
    (2, 4, 2, 128, 128, 64, True),
    (1, 8, 8, 256, 256, 128, True),
    (1, 4, 1, 128, 384, 64, True),    # GQA 4:1, chunked prefill (Sk > Sq)
    (2, 2, 2, 128, 128, 32, False),   # bidirectional (encoder)
    (1, 16, 2, 64, 64, 256, True),    # gemma-style head_dim=256
]
# lengths no block size divides, which the port's kernel takes
RAGGED_CASES = [
    (1, 4, 2, 100, 100, 64, True),
    (3, 5, 5, 1, 77, 32, True),       # one query row against 77 keys
    (1, 2, 1, 37, 53, 16, False),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _qkv(case, seed=7):
    B, Hq, Hkv, Sq, Sk, D, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, Sq, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32))


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(DTYPES[dtype][0]) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrays]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


# ---------------------------------------------------------------------------
# plain versions against the Pallas kernel (interpret) and the jnp oracles
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention_matches_jax_kernel_and_oracle(case, dtype):
    causal = case[-1]
    arrays = _qkv(case)
    jq, jk, jv = _jax(arrays, dtype)
    kernel = flash_attention_fwd(jq, jk, jv, causal=causal, block_q=64,
                                 block_k=64, interpret=True)
    oracle = jref.attention(jq, jk, jv, causal=causal)
    got = ref.attention(*_torch(arrays, dtype), causal=causal)
    assert got.dtype == DTYPES[dtype][1] and got.shape == case[:2] + case[3:4] + case[5:6]
    np.testing.assert_allclose(_f32(got), _f32(kernel), **TOL[dtype])
    np.testing.assert_allclose(_f32(got), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention_chunked_matches_jax(case, dtype):
    """A chunk of 32 so that every case is cut into several chunks."""
    causal = case[-1]
    arrays = _qkv(case, seed=8)
    jq, jk, jv = _jax(arrays, dtype)
    want = jref.attention_chunked(jq, jk, jv, causal=causal, chunk=32)
    got = ref.attention_chunked(*_torch(arrays, dtype), causal=causal,
                                chunk=32)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    np.testing.assert_allclose(
        _f32(got), _f32(ref.attention(*_torch(arrays, dtype), causal=causal)),
        **TOL[dtype])


@pytest.mark.parametrize("case", RAGGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_attention_ragged_lengths_match_jax_oracle(case, dtype):
    causal = case[-1]
    arrays = _qkv(case, seed=9)
    want = jref.attention(*_jax(arrays, dtype), causal=causal)
    got = ref.attention(*_torch(arrays, dtype), causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])
    # a chunk that does not divide Sq sends the whole call to attention
    chunked = ref.attention_chunked(*_torch(arrays, dtype), causal=causal,
                                    chunk=64)
    np.testing.assert_allclose(_f32(chunked), _f32(got), rtol=0, atol=0)


def test_ref_attention_takes_transposed_views():
    """The attention layer hands over [B, S, H, D] projections transposed
    to [B, H, S, D]; the plain version gives what it gives on copies."""
    case = (2, 4, 2, 48, 48, 32, True)
    q, k, v = (torch.from_numpy(a).transpose(1, 2).contiguous().transpose(1, 2)
               for a in _qkv(case, seed=10))
    assert not v.is_contiguous() and v.stride(-1) == 1
    torch.testing.assert_close(
        ref.attention(q, k, v), ref.attention(q.contiguous(), k.contiguous(),
                                              v.contiguous()),
        rtol=0, atol=0)


@pytest.mark.parametrize("cache_len", [1, 5, 16])
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(cache_len, q_dtype):
    """q [B, Hq, 1, D] against bf16 caches of S = 24 > cache_len, whose
    tail beyond cache_len holds garbage both sides must ignore."""
    rng = np.random.default_rng(cache_len)
    B, Hq, Hkv, S, D = 2, 8, 2, 24, 32
    q = rng.standard_normal((B, Hq, 1, D), dtype=np.float32)
    kc = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    vc = rng.standard_normal((B, Hkv, S, D), dtype=np.float32)
    kc[:, :, cache_len:] = 1e4
    vc[:, :, cache_len:] = -1e4
    want = jref.decode_attention(
        jnp.asarray(q).astype(DTYPES[q_dtype][0]),
        jnp.asarray(kc).astype(jnp.bfloat16),
        jnp.asarray(vc).astype(jnp.bfloat16), cache_len)
    got = ref.decode_attention(
        torch.from_numpy(q).to(DTYPES[q_dtype][1]),
        torch.from_numpy(kc).to(torch.bfloat16),
        torch.from_numpy(vc).to(torch.bfloat16), cache_len)
    assert got.dtype == DTYPES[q_dtype][1] and got.shape == (B, Hq, 1, D)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[q_dtype])


# ---------------------------------------------------------------------------
# ops.flash_attention routing on the CPU
# ---------------------------------------------------------------------------
def _record(monkeypatch):
    calls = []
    for name in ("attention", "attention_chunked"):
        fn = getattr(ref, name)
        monkeypatch.setattr(
            ref, name,
            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    return calls


@pytest.mark.parametrize("seq,path", [(1023, "attention"),
                                      (1024, "attention_chunked")])
def test_auto_on_cpu_takes_chunked_from_1024(monkeypatch, seq, path):
    calls = _record(monkeypatch)
    q = torch.randn(1, 2, seq, 16)
    kv = torch.randn(1, 1, seq, 16)
    before = kflash.launches.count
    out = ops.flash_attention(q, kv, kv, causal=True, impl="auto")
    assert calls[0] == path and out.shape == q.shape
    assert kflash.launches.count == before


@pytest.mark.parametrize("impl,path", [("ref", "attention"),
                                       ("chunked", "attention_chunked")])
def test_explicit_plain_impls(monkeypatch, impl, path):
    calls = _record(monkeypatch)
    q = torch.randn(1, 2, 64, 16)
    kv = torch.randn(1, 2, 64, 16)
    ops.flash_attention(q, kv, kv, impl=impl)
    assert calls == [path]


def test_pallas_impl_raises_on_cpu_tensors():
    q = torch.randn(1, 2, 64, 32)
    kv = torch.randn(1, 2, 64, 32)
    before = kflash.launches.count
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, kv, kv, impl="pallas")
    assert kflash.launches.count == before


def test_unknown_impl_raises():
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="impl"):
        ops.flash_attention(q, q, q, impl="kernel")


# ---------------------------------------------------------------------------
# causal with Sq > Sk: refused on every path (the JAX pair disagree there)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("call", [
    lambda q, k, v: ref.attention(q, k, v, causal=True),
    lambda q, k, v: ref.attention_chunked(q, k, v, causal=True, chunk=8),
    lambda q, k, v: ops.flash_attention(q, k, v, causal=True, impl="auto"),
    lambda q, k, v: ops.flash_attention(q, k, v, causal=True, impl="ref"),
    lambda q, k, v: ops.flash_attention(q, k, v, causal=True, impl="chunked"),
    lambda q, k, v: ops.flash_attention(q, k, v, causal=True, impl="pallas"),
    lambda q, k, v: kflash.flash_attention(q, k, v, causal=True),
], ids=["ref", "chunked", "ops_auto", "ops_ref", "ops_chunked", "ops_pallas",
        "wrapper"])
def test_causal_with_more_queries_than_keys_raises(call):
    q = torch.randn(1, 2, 32, 16)
    kv = torch.randn(1, 2, 16, 16)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        call(q, kv, kv)


def test_non_causal_with_more_queries_than_keys_matches_jax():
    case = (1, 4, 2, 40, 24, 32, False)
    arrays = _qkv(case, seed=12)
    want = jref.attention(*_jax(arrays, "float32"), causal=False)
    got = ops.flash_attention(*_torch(arrays, "float32"), causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["float32"])


# ---------------------------------------------------------------------------
# the kernel wrapper's checks raise before any launch
# ---------------------------------------------------------------------------
def _bad_inputs():
    q = torch.randn(1, 4, 16, 64)
    kv = torch.randn(1, 2, 16, 64)
    wide = torch.randn(1, 4, 16, 128)
    return {
        "dtype": ((q.half(), kv.half(), kv.half()), TypeError, "dtype"),
        "mixed_dtype": ((q, kv.to(torch.bfloat16), kv), TypeError, "dtype"),
        "head_dim": ((torch.randn(1, 4, 16, 48), torch.randn(1, 2, 16, 48),
                      torch.randn(1, 2, 16, 48)), ValueError, "head_dim"),
        "head_dim_8": ((torch.randn(1, 4, 16, 8), torch.randn(1, 2, 16, 8),
                        torch.randn(1, 2, 16, 8)), ValueError, "head_dim"),
        "d_stride": ((wide[..., ::2], kv, kv), ValueError, "stride"),
        "groups": ((torch.randn(1, 3, 16, 64), kv, kv), ValueError,
                   "multiple"),
        "shape": ((q, kv, torch.randn(1, 2, 15, 64)), ValueError, "fit"),
        "rank": ((q[0], kv, kv), ValueError, r"\[B, H, S, D\]"),
        "device": ((q, kv, kv), ValueError, "CUDA"),
        # TMA takes bf16 only at 16-byte base pointers and strides
        "bf16_seq_stride": (_tma_misaligned("seq_stride"), ValueError,
                            "16 bytes"),
        "bf16_base_pointer": (_tma_misaligned("base_pointer"), ValueError,
                              "16 bytes"),
    }


def _tma_misaligned(what, dtype=torch.bfloat16):
    """bf16-sized q, k, v whose q TMA could not take: a sequence stride of
    68 elements (136 bytes in bf16), or a base pointer 2 elements in."""
    kv = torch.randn(1, 2, 16, 64).to(dtype)
    if what == "seq_stride":
        q = torch.randn(1, 4, 16, 68).to(dtype)[..., :64]
    else:
        q = torch.randn(4 * 16 * 64 + 2).to(dtype)[2:].reshape(1, 4, 16, 64)
    return q, kv, kv


@pytest.mark.parametrize("name", list(_bad_inputs()))
def test_wrapper_rejects_before_any_launch(name):
    (q, k, v), exc, match = _bad_inputs()[name]
    before = kflash.launches.count
    with pytest.raises(exc, match=match):
        kflash.flash_attention(q, k, v, causal=True)
    assert kflash.launches.count == before


@pytest.mark.parametrize("what", ["seq_stride", "base_pointer"])
def test_tma_alignment_is_checked_for_bf16_only(what):
    """The same misaligned views: bf16 is refused for TMA, f32 passes every
    check but the device (the f32 kernel reads through plain loads)."""
    q, k, v = _tma_misaligned(what)
    with pytest.raises(ValueError, match="16 bytes"):
        kflash.check_inputs(q, k, v, causal=True)
    q, k, v = _tma_misaligned(what, torch.float32)
    with pytest.raises(ValueError, match="CUDA device"):
        kflash.check_inputs(q, k, v, causal=True)


def test_tma_strides_of_size_one_dims_are_not_checked():
    """A dimension of size 1 is never stepped along: its stride may be
    anything (a one-row query slice of a wider tensor)."""
    q = torch.randn(1, 4, 3, 64).to(torch.bfloat16)[:, :, 1:2]
    kv = torch.randn(1, 2, 16, 64).to(torch.bfloat16)
    assert kflash._strides(q)[2] == 64
    with pytest.raises(ValueError, match="CUDA device"):
        kflash.check_inputs(q, kv, kv, causal=True)


def test_wrapper_supported_head_dims_cover_the_dense_archs():
    from repro_torch.configs import get_config

    for arch in ("llama3-8b", "gemma-7b", "qwen1.5-4b", "qwen2-72b"):
        assert get_config(arch).head_dim in kflash.HEAD_DIMS
