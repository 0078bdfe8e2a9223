"""Weighted temporal composite on the card (paper §V.C): the ctypes wrapper
of ``csrc/composite.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/composite.py``:
``composite_fwd`` / ``_composite_kernel``.  Its plain version is
:func:`repro_torch.kernels.ref.composite`.

The kernel is bound by memory: it reads each image and weight byte once
and does one multiply-add per image element.  So it makes no copy of its
inputs (a non-contiguous stack is refused rather than copied; at the
paper's depth a stack is 17 GB), keeps its sums in registers, reads a
pixel's channels in one vector load and coalesces every load along W (see
the source for the details).

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch is refused, and counts its launches.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build
from repro_torch.kernels.backend import LaunchCounter, refuse_autograd

MAX_CHANNELS = 8
EPS = 1e-6
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = LaunchCounter("composite")

_bind_lock = threading.Lock()
_bound = None


def _bind():
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = build.load("composite")
            fn = lib.repro_composite
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.repro_cuda_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound = (fn, err)
    return _bound


def check_inputs(images: torch.Tensor, weights: torch.Tensor) -> None:
    """Raise on anything the kernel does not take, and under autograd (the
    kernel has no backward).  The device is checked last."""
    if images.dim() != 4:
        raise ValueError(f"images must be [T, H, W, C], got {tuple(images.shape)}")
    T, H, W, C = images.shape
    if tuple(weights.shape) != (T, H, W):
        raise ValueError(f"weights {tuple(weights.shape)} != {(T, H, W)}")
    if images.dtype not in _DTYPE_CODES:
        raise TypeError(f"images dtype {images.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if weights.dtype not in (torch.float32, images.dtype):
        raise TypeError(f"weights dtype {weights.dtype} must be float32 or "
                        f"the images' {images.dtype}")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"C={C} outside 1..{MAX_CHANNELS}")
    if not (images.is_contiguous() and weights.is_contiguous()):
        raise ValueError("images and weights must be contiguous (the "
                         "wrapper does not copy a stack)")
    refuse_autograd("composite", (images, weights),
                    "the imagery path trains nothing")
    if images.device.type != "cuda" or weights.device != images.device:
        raise ValueError(f"the kernel needs both tensors on one CUDA device, "
                         f"got {images.device} and {weights.device}")


def composite(images: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """images [T, H, W, C] f32/bf16, weights [T, H, W] f32 or the images'
    dtype, on the card -> [H, W, C] in the images' dtype."""
    check_inputs(images, weights)
    T, H, W, C = images.shape
    out = torch.empty((H, W, C), dtype=images.dtype, device=images.device)
    if out.numel() == 0:
        return out
    fn, err_string = _bind()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = fn(images.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 T, H * W, C, _DTYPE_CODES[images.dtype],
                 _DTYPE_CODES[weights.dtype], EPS, stream)
    if err:
        raise RuntimeError(f"composite kernel launch failed: "
                           f"{err_string(err).decode()} (cudaError {err})")
    launches.add()
    return out
