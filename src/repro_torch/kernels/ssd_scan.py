"""Mamba-2 SSD chunked scan on the card: the ctypes wrappers of
``csrc/ssd_scan.cu`` (the forward) and ``csrc/ssd_scan_bwd.cu`` (its
backward).

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

The backward (no TPU counterpart: the JAX package differentiates its plain
SSD) has the plain version :func:`repro_torch.kernels.ref.ssd_scan_bwd`.
It runs chunk-parallel: a first kernel computes, for every (batch, chunk,
head) at once, the chunk's local state and local adjoint into f32
workspaces; an elementwise pass turns them into the state entering each
chunk and the gradient of the state leaving it; a third kernel does every
per-chunk product, one block per (batch, chunk, tile of
:data:`BWD_HEAD_TILE` heads).  Partial sums (db and dc over the head tiles,
da and dd over the chunks) are added in a fixed order (no atomics: all six
gradients are bit-identical from run to run).  :class:`SsdScanFn` ties the
two together for autograd.  It takes b and c unexpanded, [B, L, G, N] with
G = 1 (one group shared by every head, what the model hands over) or G = H,
expands them to every head (stride 0) for the forward kernel, and returns
their gradients in that shape, summed over each group's heads inside the
backward, so no [B, L, H, N] gradient is made.  (Handed the expanded view,
autograd would sum a per-head gradient over the heads through ``expand``'s
backward.)

The wrappers check shapes, dtypes, strides, alignment and the device, and
raise on anything the kernels do not take, then call the kernel's custom
op (``torch.ops.repro_torch.ssd_scan_fwd`` and ``ssd_scan_bwd``): on CUDA
tensors it allocates outputs and scratch with ``torch.empty``, launches
on the current stream without synchronising, raises if a launch is
refused, and counts one launch a call.  On CPU tensors, which only a
direct call of the op reaches (the wrappers refuse them), the op runs the
plain versions; on fake tensors (``launch/dryrun.py``) its fake
implementation gives the outputs' shapes and launches nothing, and
``torch.utils.flop_counter`` counts its operations by
``kernels/bounds.py`` at the kernel's chunk.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import bounds, build, ref
from repro_torch.kernels.backend import LaunchCounter, is_fake

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
#: heads a thread block of the backward's per-chunk kernels takes; with one
#: group of b and c their db and dc are summed over the tile in the block
#: (csrc/ssd_scan_bwd.cu)
BWD_HEAD_TILE = 8

launches = LaunchCounter("ssd_scan")
bwd_launches = LaunchCounter("ssd_scan_bwd")

#: the kernels' ops, ``torch.ops.repro_torch.ssd_scan_{fwd,bwd}``, on
#: ``torch.library.Library`` (see ``flash_attention.py``)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("ssd_scan_fwd(Tensor x, Tensor dt, Tensor a, Tensor b, "
            "Tensor c, Tensor? d_skip) -> Tensor")
_LIB.define("ssd_scan_bwd(Tensor x, Tensor dt, Tensor a, Tensor b, "
            "Tensor c, Tensor dy, Tensor? d_skip) -> (Tensor, Tensor, "
            "Tensor, Tensor, Tensor, Tensor)")

_bind_lock = threading.Lock()
_bound = {}
#: each source's C entry: its pointer and 64-bit integer arguments
_ARGTYPES = {
    "ssd_scan": [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 20,
    "ssd_scan_bwd": [ctypes.c_void_p] * 20 + [ctypes.c_int64] * 24,
}


def _bind(name: str = "ssd_scan"):
    with _bind_lock:
        if name not in _bound:
            lib = build.load(name)
            fn = getattr(lib, f"repro_{name}")
            fn.argtypes = _ARGTYPES[name] + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = getattr(lib, f"repro_{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound[name] = (fn, err)
    return _bound[name]


def check_inputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 d_skip: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the kernel does not take.  The device is checked
    last, so each of the other checks can be seen on CPU tensors; fake
    tensors skip the base pointers and the device (:func:`backend.is_fake`)."""
    fake = is_fake(x)
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
            if ((not fake and t.data_ptr() % CP_ASYNC_ALIGN)
                    or any(t.stride(i) * size % CP_ASYNC_ALIGN
                           for i in range(3) if t.shape[i] > 1)):
                raise ValueError(
                    f"bf16 {name}: base pointer and batch, sequence and head "
                    f"strides {t.stride()[:3]} must be multiples of "
                    f"{CP_ASYNC_ALIGN} bytes (cp.async); the wrapper does not "
                    f"copy")
    if B > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"B={B} and H={H} must be <= {MAX_GRID_YZ}")
    if fake:
        return
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
    return fwd_op(x, dt, a, b, c, d_skip)


def _cb_scratch(x: torch.Tensor, groups: int):
    """The bf16 kernel's f32 c·b tiles, one per (batch, chunk, group);
    None for f32."""
    B, L = x.shape[:2]
    if x.dtype != torch.bfloat16:
        return None
    return torch.empty((B, -(-L // CHUNK), groups, CB_TILE_FLOATS),
                       dtype=torch.float32, device=x.device)


def _fwd_launch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor,
                d_skip: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward kernel on inputs :func:`check_inputs` took: the op's
    CUDA implementation."""
    B, L, H, P = x.shape
    N = b.shape[3]
    y = torch.empty((B, L, H, P), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    groups = cb_groups(b, c)
    cb = _cb_scratch(x, groups)
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


def _fwd_plain(x, dt, a, b, c, d_skip):
    """The plain version, ``ref.ssd_scan``."""
    return ref.ssd_scan(x, dt, a, b, c, d_skip=d_skip).contiguous()


def _fwd_fake(x, dt, a, b, c, d_skip):
    check_inputs(x, dt, a, b, c, d_skip)
    return x.new_empty(tuple(x.shape))


_LIB.impl("ssd_scan_fwd", _fwd_launch, "CUDA")
_LIB.impl("ssd_scan_fwd", _fwd_plain, "CPU")
torch.library.register_fake("repro_torch::ssd_scan_fwd", lib=_LIB)(_fwd_fake)
fwd_op = torch.ops.repro_torch.ssd_scan_fwd.default


def scan_shape(x: torch.Tensor, b: torch.Tensor) -> tuple:
    """(B, L, H, P, N): ``bounds.ssd_bound``'s shape."""
    return (*x.shape, b.shape[3])


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd, get_raw=True)
def _fwd_flops(x, dt, a, b, c, d_skip, *args, **kwargs) -> int:
    return bounds.ssd_bound(scan_shape(x, b), x.element_size(),
                            cb_groups(b, c) == 1, chunk=CHUNK)[1]


def bwd_head_tiles(H: int) -> list:
    """The heads of each thread block of the backward's per-chunk kernels,
    in order: ``range(t T, min(H, (t + 1) T))`` for t < ceil(H / T), T =
    :data:`BWD_HEAD_TILE`, as the kernels compute them from T."""
    T = BWD_HEAD_TILE
    return [range(h, min(H, h + T)) for h in range(0, H, T)]


def check_bwd_inputs(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                     d_skip: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the backward kernel does not take: the forward's
    checks on b and c expanded to every head, b and c [B, L, G, N] with
    G = 1 or H, and dy [B, L, H, P] in x's dtype with stride 1 along P.
    The device is checked last."""
    if b.dim() != 4 or c.dim() != 4 or x.dim() != 4:
        raise ValueError("x must be [B, L, H, P] and b, c [B, L, G, N]")
    B, L, H, P = x.shape
    G = b.shape[2]
    if G not in (1, H) or c.shape != b.shape:
        raise ValueError(f"b {tuple(b.shape)} and c {tuple(c.shape)} must "
                         f"be [B, L, G, N] with G = 1 or H={H}")
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} must match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dy.stride(3) != 1:
        raise ValueError("dy needs stride 1 along P (the wrapper does not "
                         "copy)")
    N = b.shape[3]
    check_inputs(x, dt, a, b.expand(B, L, H, N), c.expand(B, L, H, N),
                 d_skip)
    if dy.device != x.device:
        raise ValueError(f"dy on {dy.device}, x on {x.device}")


def bwd_workspace(x: torch.Tensor, N: int, groups: int = 1):
    """The backward's f32 scratch for x [B, L, H, P], state dim N and b, c
    of ``groups`` groups, allocated with ``torch.empty`` (the kernels write
    every element they read), in the C entry's order: the local states,
    then the states entering each chunk, and the local adjoints, then the
    gradients of the states leaving each chunk, each [B, H, Z, N, P] (Z =
    ceil(L / CHUNK)); cum_Q of each chunk [B, H, Z]; the per-tile sums of db
    and dc [B, L, T, N] (T = ``len(bwd_head_tiles(H))``; empty where groups
    is H, whose db and dc the kernel writes directly); the per-chunk
    partials of da and dd [B, Z, H]."""
    B, L, H, P = x.shape
    Z = -(-L // CHUNK)
    T = len(bwd_head_tiles(H)) if groups == 1 else 0
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty((B, H, Z, N, P), **f32),
            torch.empty((B, H, Z, N, P), **f32),
            torch.empty((B, H, Z), **f32),
            torch.empty((B, L, T, N), **f32),
            torch.empty((B, L, T, N), **f32),
            torch.empty((B, Z, H), **f32), torch.empty((B, Z, H), **f32))


def bwd_call_args(x, dt, a, b, c, dy, d_skip, outs, work) -> tuple:
    """The C entry's arguments: inputs, the outputs (dx, ddt, da, db, dc,
    dd), the workspace, sizes, the head tile, strides, dtype and the
    current stream."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), ptr(d_skip), dy.data_ptr(), *map(ptr, outs),
            *(t.data_ptr() for t in work), B, L, H, G, P, N, BWD_HEAD_TILE,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2), a.stride(0),
            b.stride(0), b.stride(1), b.stride(2),
            c.stride(0), c.stride(1), c.stride(2),
            d_skip.stride(0) if d_skip is not None else 0,
            dy.stride(0), dy.stride(1), dy.stride(2),
            _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream
            if x.is_cuda else 0)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                 d_skip: Optional[torch.Tensor] = None):
    """The backward kernel: the forward's inputs, b and c [B, L, G, N]
    (G = 1 or H), and the output's gradient dy -> (dx, ddt, da, db, dc,
    dd), contiguous: dx, db and dc in x's dtype (db and dc summed over each
    group's heads), ddt, da and dd in f32, dd None without ``d_skip`` (see
    ``ref.ssd_scan_bwd``).  Four kernels (the local states, the state
    pass, the per-chunk products, the fixed-order sums of da and dd) and,
    with one group, a fifth (the sums of db and dc over the head tiles),
    counted as one launch; the scratch is :func:`bwd_workspace`'s."""
    check_bwd_inputs(x, dt, a, b, c, dy, d_skip)
    grads = bwd_op(x, dt, a, b, c, dy, d_skip)
    return grads[:5] + ((grads[5] if d_skip is not None else None),)


def _bwd_outputs(x: torch.Tensor, b: torch.Tensor, skip: bool):
    """dx, ddt, da, db, dc and dd (empty without the D-skip)."""
    B, L, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    f32 = dict(dtype=torch.float32, device=x.device)
    db = torch.empty((B, L, G, N), dtype=x.dtype, device=x.device)
    return (torch.empty((B, L, H, P), dtype=x.dtype, device=x.device),
            torch.empty((B, L, H), **f32), torch.empty((H,), **f32), db,
            torch.empty_like(db), torch.empty((H if skip else 0,), **f32))


def _bwd_launch(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
                d_skip: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on inputs :func:`check_bwd_inputs` took -> (dx,
    ddt, da, db, dc, dd; an empty dd without ``d_skip``): the op's CUDA
    implementation."""
    N = b.shape[3]
    G = b.shape[2]
    outs = _bwd_outputs(x, b, d_skip is not None)
    if outs[0].numel() == 0:
        return tuple(t.zero_() for t in outs)
    fn, err_string = _bind("ssd_scan_bwd")
    with torch.cuda.device(x.device):
        err = fn(*bwd_call_args(x, dt, a, b, c, dy, d_skip,
                                outs[:5] + ((outs[5] if d_skip is not None
                                             else None),),
                                bwd_workspace(x, N, G)))
    if err:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: "
                           f"{err_string(err).decode()} (cudaError {err})")
    bwd_launches.add()
    return outs


def _bwd_plain(x, dt, a, b, c, dy, d_skip):
    """The plain version, ``ref.ssd_scan_bwd`` at the kernel's chunk."""
    grads = ref.ssd_scan_bwd(x, dt, a, b, c, dy, d_skip=d_skip, chunk=CHUNK)
    outs = _bwd_outputs(x, b, d_skip is not None)
    for out, g in zip(outs, grads):
        if g is not None:
            out.copy_(g)
    return outs


def _bwd_fake(x, dt, a, b, c, dy, d_skip):
    check_bwd_inputs(x, dt, a, b, c, dy, d_skip)
    return _bwd_outputs(x, b, d_skip is not None)


_LIB.impl("ssd_scan_bwd", _bwd_launch, "CUDA")
_LIB.impl("ssd_scan_bwd", _bwd_plain, "CPU")
torch.library.register_fake("repro_torch::ssd_scan_bwd", lib=_LIB)(_bwd_fake)
bwd_op = torch.ops.repro_torch.ssd_scan_bwd.default


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _bwd_flops(x_shape, dt_shape, a_shape, b_shape, c_shape, dy_shape,
               d_skip_shape, *args, **kwargs) -> int:
    return bounds.ssd_bwd_bound((*x_shape, b_shape[3]), 2, b_shape[2] == 1,
                                d_skip_shape is not None, CHUNK)[1]


def expand_heads(b: torch.Tensor, heads: int) -> torch.Tensor:
    """b [B, L, G, N] with G = 1 or ``heads`` -> [B, L, heads, N]: one group
    expanded to every head with stride 0 (not copied)."""
    B, L, _, N = b.shape
    return b.expand(B, L, heads, N)


class SsdScanFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  b and
    c come unexpanded, [B, L, G, N] (G = 1 or H); the forward saves its
    inputs (views, not copies; under ``torch.utils.checkpoint`` those of
    the recompute) and the backward returns db and dc in that shape."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, d_skip):
        H = x.shape[2]
        y = ssd_scan(x, dt, a, expand_heads(b, H), expand_heads(c, H),
                     d_skip=d_skip)
        ctx.save_for_backward(x, dt, a, b, c, d_skip)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, a, b, c, d_skip = ctx.saved_tensors
        if dy.stride(3) != 1:
            dy = dy.contiguous()
        return ssd_scan_bwd(x, dt, a, b, c, dy, d_skip)
