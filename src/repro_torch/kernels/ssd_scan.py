"""Mamba-2 SSD chunked scan on the card: the ctypes wrapper of
``csrc/ssd_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssd_scan.py``:
``ssd_scan_fwd`` / ``_ssd_kernel``.  Its plain versions are
:func:`repro_torch.kernels.ref.ssd_scan` (the sequential recurrence) and
:func:`repro_torch.kernels.ref.ssd_scan_chunked`.

One thread block owns a (batch, head, slice of 32 columns of P) and walks
the chunks of its sequence in order with the state in shared memory (see the
source).  The kernel reads x, dt, b and c through their strides, so the
model's ``[B, L, H, ·]`` views, b and c expanded to every head with stride 0,
are not copied; the JAX wrapper transposes all four to head-major instead.
Any L >= 1 is taken (the last chunk is masked).  The D-skip is applied in
f32 inside the kernel, before y is rounded to x's dtype.

The wrapper checks shapes, dtypes, strides and the device, and raises on
anything the kernel does not take, allocates y with ``torch.empty``,
launches on the current stream without synchronising, raises if the launch
is refused, and counts its launches.
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
#: gridDim.y carries the heads, gridDim.z the batch
MAX_GRID_YZ = 65535
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
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 5
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
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"B={B} and H={H} must be <= {MAX_GRID_YZ}")
    tensors = [x, dt, a, b, c] + ([d_skip] if d_skip is not None else [])
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"the kernel needs every input on one CUDA device, "
                         f"got {sorted({str(t.device) for t in tensors})}")


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
    fn, err_string = _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                 c.data_ptr(), d_skip.data_ptr() if d_skip is not None else 0,
                 y.data_ptr(), B, L, H, P, N,
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
