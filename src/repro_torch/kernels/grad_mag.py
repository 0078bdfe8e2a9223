"""Cloud-masked temporal gradient accumulation on the card (paper §V.B): the
ctypes wrapper of ``csrc/grad_mag.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/grad_mag.py``:
``grad_mag_fwd`` / ``_grad_kernel``.  Its plain version is
:func:`repro_torch.kernels.ref.grad_mag`.

The kernel is bound by memory.  The TPU wrapper wrote four shifted copies
of the stack (east and south neighbours of the images and of the mask) and
widened the mask to the images' type; this one makes no copy at all: the
kernel reads each pixel's east and south neighbours straight from the
stack, and ``valid`` stays ``torch.bool``, one byte a pixel (see the source
for the details).

The wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take, allocates the outputs with
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

launches = LaunchCounter("grad_mag")

_bind_lock = threading.Lock()
_bound = None


def _bind():
    global _bound
    with _bind_lock:
        if _bound is None:
            lib = build.load("grad_mag")
            fn = lib.repro_grad_mag
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                           ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.repro_grad_mag_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound = (fn, err)
    return _bound


def check_inputs(images: torch.Tensor, valid: torch.Tensor) -> None:
    """Raise on anything the kernel does not take, and under autograd (the
    kernel has no backward).  The device is checked last."""
    if images.dim() != 4:
        raise ValueError(f"images must be [T, H, W, C], got {tuple(images.shape)}")
    T, H, W, C = images.shape
    if tuple(valid.shape) != (T, H, W):
        raise ValueError(f"valid {tuple(valid.shape)} != {(T, H, W)}")
    if images.dtype not in _DTYPE_CODES:
        raise TypeError(f"images dtype {images.dtype} not in "
                        f"{list(_DTYPE_CODES)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid dtype {valid.dtype} must be torch.bool")
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"C={C} outside 1..{MAX_CHANNELS}")
    if not (images.is_contiguous() and valid.is_contiguous()):
        raise ValueError("images and valid must be contiguous (the wrapper "
                         "does not copy a stack)")
    refuse_autograd("grad_mag", (images, valid),
                    "the imagery path trains nothing")
    if images.device.type != "cuda" or valid.device != images.device:
        raise ValueError(f"the kernel needs both tensors on one CUDA device, "
                         f"got {images.device} and {valid.device}")


def grad_mag(images: torch.Tensor, valid: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """images [T, H, W, C] f32/bf16, valid [T, H, W] bool, on the card ->
    (grad_sum [H, W], count [H, W]), both f32."""
    check_inputs(images, valid)
    T, H, W, C = images.shape
    grad_sum = torch.empty((H, W), dtype=torch.float32, device=images.device)
    count = torch.empty_like(grad_sum)
    if grad_sum.numel() == 0:
        return grad_sum, count
    fn, err_string = _bind()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = fn(images.data_ptr(), valid.data_ptr(), grad_sum.data_ptr(),
                 count.data_ptr(), T, H, W, C, _DTYPE_CODES[images.dtype],
                 EPS, stream)
    if err:
        raise RuntimeError(f"grad_mag kernel launch failed: "
                           f"{err_string(err).decode()} (cudaError {err})")
    launches.add()
    return grad_sum, count
