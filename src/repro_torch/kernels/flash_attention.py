"""Grouped-query flash attention on the card: the ctypes wrapper of
``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``:
``flash_attention_fwd`` / ``_attn_kernel``.  Its plain versions are
:func:`repro_torch.kernels.ref.attention` and
:func:`repro_torch.kernels.ref.attention_chunked`.

The kernel is bound by operations (see the source).  bf16 inputs run on the
bf16 tensor cores: a thread block owns a (batch, query head, tile of 128
query rows); a producer warpgroup streams K and V tiles with TMA into a
two-stage ring in shared memory, and two consumer warpgroups, 64 rows each,
compute Q·Kᵀ and P·V with ``wgmma`` (P rounded to bf16 in registers) and
keep the online-softmax state in registers.  f32 inputs run on a second
instantiation on the f32 cores, held to 3e-5.  Both walk the key tiles from
0 upward and skip the tiles the causal mask hides, and both read q, k and v
through their strides, so the transposed views the attention layer hands
over are not copied.

The wrapper checks shapes, dtype, head_dim and the strides and raises on
anything the kernel does not take (for bf16, TMA needs the base pointers
and the batch, head and sequence strides in multiples of 16 bytes),
allocates the output with ``torch.empty``, launches on the current stream
without synchronising, raises if the launch is refused, and counts its
launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import LaunchCounter
from repro_torch.kernels.ref import check_causal

HEAD_DIMS = (16, 32, 64, 128, 256)
#: blockIdx.y carries batch * query heads
MAX_BATCH_HEADS = 65535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: TMA's alignment of a tensor's base address and strides, in bytes
TMA_ALIGN = 16

launches = LaunchCounter("flash_attention")

_bind_lock = threading.Lock()
_bound = None


def _bind():
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = build.load("flash_attention")
            fn = lib.repro_flash_attention
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 15
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = lib.repro_flash_attention_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound = (fn, err)
    return _bound


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of [B, H, S, D] along B, H and S; a dimension of
    size 1 is never stepped along, so its stride is given as D (any
    multiple of 16 bytes would do)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else t.shape[3]
                 for i in range(3))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Raise on anything the kernel does not take.  The device is checked
    last, so each of the other checks can be seen on CPU tensors."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, H, S, D]")
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype}: "
                        f"need one of {list(_DTYPE_CODES)} for all three")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("q, k and v need stride 1 along head_dim (the "
                         "wrapper does not copy)")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            size = t.element_size()
            if (t.data_ptr() % TMA_ALIGN
                    or any(st <= 0 or st * size % TMA_ALIGN
                           for st in _strides(t))):
                raise ValueError(
                    f"bf16 {name}: base pointer and batch, head and sequence "
                    f"strides {t.stride()[:3]} must be positive multiples of "
                    f"{TMA_ALIGN} bytes (TMA); the wrapper does not copy")
    if B * Hq > MAX_BATCH_HEADS:
        raise ValueError(f"B*Hq={B * Hq} > {MAX_BATCH_HEADS}")
    check_causal(Sq, Sk, causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], f32 or bf16, on the card
    -> [B, Hq, Sq, D] contiguous in q's dtype; scores scaled by D^-1/2."""
    check_inputs(q, k, v, causal)
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn, err_string = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Hq, Hkv, Sq, Sk, D,
                 *_strides(q), *_strides(k), *_strides(v),
                 _DTYPE_CODES[q.dtype], int(causal), D ** -0.5, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{err_string(err).decode()} (cudaError {err})")
    launches.add()
    return out
