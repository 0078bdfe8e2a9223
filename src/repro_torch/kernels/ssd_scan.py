"""Mamba-2 SSD chunked scan on the card: the ctypes wrapper of
``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``:
``ssd_scan_fwd`` / ``_ssd_kernel``.  Its plain versions are
:func:`repro_torch.kernels.ref.ssd_scan` (the sequential recurrence) and
:func:`repro_torch.kernels.ref.ssd_scan_chunked`.

One thread block walks the chunks of one (batch, head) in order with the
state on chip (see the source).  In bf16 the products run on the tensor
cores, and c·b is computed once per (batch, chunk, group) by a first kernel
into an f32 scratch tile that every head's block reads; in f32 the f32
cores hold the result to 5e-4.  The kernel reads x, dt, b and c through
their strides, so the model's ``[B, L, H, ·]`` views, b and c expanded to
every head with stride 0, are not copied; the JAX wrapper transposes all
four to head-major instead.  Any L >= 1 is taken (the last chunk is
masked).  The D-skip is applied in f32 inside the kernel, before y is
rounded to x's dtype.

The wrapper checks shapes, dtypes, strides, alignment and the device, and
raises on anything the kernel does not take, allocates y (and in bf16 the
c·b scratch) with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch is refused, and counts one launch a
call.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import LaunchCounter

#: P and N the kernel takes: those of tests/test_kernels.py:137-141 and of
#: the mamba2 and jamba configs
HEAD_DIMS = (16, 32, 64, 128)
STATE_DIMS = (8, 16, 128)
#: the grid carries the heads and the batch in dimensions of at most 65535
MAX_GRID_YZ = 65535
#: bf16 x, b and c are copied with 16-byte cp.async: base pointers and
#: batch, sequence and head strides must be multiples of this many bytes
CP_ASYNC_ALIGN = 16
#: tokens per chunk, and floats of one chunk's packed c·b tile (the ten
#: 16x16 blocks on or below the diagonal of [64, 64])
CHUNK = 64
CB_TILE_FLOATS = 10 * 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter("ssd_scan")

_bind_lock = threading.Lock()
_bound = None


def _bind():
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = build.load("ssd_scan")
            fn = lib.repro_ssd_scan
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6
                           + [ctypes.c_int64] * 14
                           + [ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = lib.repro_ssd_scan_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound = (fn, err)
    return _bound


def check_inputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 d_skip: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the kernel does not take.  The device is checked
    last, so each of the other checks can be seen on CPU tensors."""
    if x.dim() != 4 or b.dim() != 4 or c.dim() != 4:
        raise ValueError("x, b and c must be [B, L, H, P] and [B, L, H, N]")
    if dt.dim() != 3 or a.dim() != 1:
        raise ValueError("dt must be [B, L, H] and a [H]")
    B, L, H, P = x.shape
    N = b.shape[3]
    if (tuple(b.shape[:3]) != (B, L, H) or c.shape != b.shape
            or tuple(dt.shape) != (B, L, H) or tuple(a.shape) != (H,)):
        raise ValueError(f"shapes do not fit x {tuple(x.shape)}: dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}")
    if d_skip is not None and (d_skip.dim() != 1
                               or tuple(d_skip.shape) != (H,)):
        raise ValueError(f"d_skip {tuple(d_skip.shape)} must be [H={H}]")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"x, b, c dtypes {x.dtype}, {b.dtype}, {c.dtype}: "
                        f"need one of {list(_DTYPE_CODES)} for all three")
    for name, t in (("dt", dt), ("a", a), ("d_skip", d_skip)):
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if P not in HEAD_DIMS:
        raise ValueError(f"head dim P={P} not in {HEAD_DIMS}")
    if N not in STATE_DIMS:
        raise ValueError(f"state dim N={N} not in {STATE_DIMS}")
    if x.stride(3) != 1 or b.stride(3) != 1 or c.stride(3) != 1:
        raise ValueError("x, b and c need stride 1 along their last "
                         "dimension (the wrapper does not copy)")
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("b", b), ("c", c)):
            size = t.element_size()
            if (t.data_ptr() % CP_ASYNC_ALIGN
                    or any(t.stride(i) * size % CP_ASYNC_ALIGN
                           for i in range(3) if t.shape[i] > 1)):
                raise ValueError(
                    f"bf16 {name}: base pointer and batch, sequence and head "
                    f"strides {t.stride()[:3]} must be multiples of "
                    f"{CP_ASYNC_ALIGN} bytes (cp.async); the wrapper does not "
                    f"copy")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"B={B} and H={H} must be <= {MAX_GRID_YZ}")
    tensors = [x, dt, a, b, c] + ([d_skip] if d_skip is not None else [])
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the kernel needs every input on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")


def cb_groups(b: torch.Tensor, c: torch.Tensor) -> int:
    """How many distinct c·b products a (batch, chunk) has: 1 where b and c
    are the same for every head (stride 0 along H, or one head), else one
    per head."""
    H = b.shape[2]
    return 1 if H == 1 or (b.stride(2) == 0 and c.stride(2) == 0) else H


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor,
             d_skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, L, H, P] and b, c [B, L, H, N] (f32 or bf16, one dtype), dt
    [B, L, H] f32, a [H] f32, d_skip [H] f32 or None, on the card -> y
    [B, L, H, P] contiguous in x's dtype (see ``ref.ssd_scan``)."""
    check_inputs(x, dt, a, b, c, d_skip)
    B, L, H, P = x.shape
    N = b.shape[3]
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    groups = cb_groups(b, c)
    cb = (torch.empty((B, -(-L // CHUNK), groups, CB_TILE_FLOATS),
                      dtype=torch.float32, device=x.device)
          if x.dtype == torch.bfloat16 else None)
    fn, err_string = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), d_skip.data_ptr() if d_skip is not None else 0,
                 y.data_ptr(), cb.data_ptr() if cb is not None else 0,
                 B, L, H, groups, P, N,
                 x.stride(0), x.stride(1), x.stride(2),
                 dt.stride(0), dt.stride(1), dt.stride(2), a.stride(0),
                 b.stride(0), b.stride(1), b.stride(2),
                 c.stride(0), c.stride(1), c.stride(2),
                 d_skip.stride(0) if d_skip is not None else 0,
                 _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: "
                           f"{err_string(err).decode()} (cudaError {err})")
    launches.add()
    return y
