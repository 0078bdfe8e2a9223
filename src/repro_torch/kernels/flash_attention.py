"""Grouped-query flash attention on the card: the ctypes wrappers of
``csrc/flash_attention.cu`` (the forward) and ``csrc/flash_attention_bwd.cu``
(its backward).

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

The backward (no TPU counterpart: the JAX package differentiates its plain
attention) recomputes P from q, k and the forward's row log-sum-exp; its
plain version is :func:`repro_torch.kernels.ref.attention_bwd`.  bf16
inputs run on the tensor cores, built from the forward's parts (TMA,
mbarrier rings, ``wgmma``): a prologue kernel writes each row's
``delta = rowsum(dO * O)`` and zeroes an f32 ``dq_acc``; the main kernel
owns a (batch, KV head, tile of keys), keeps dK and dV in registers while
one of its threads streams, with TMA, every query tile of the group that
sees its keys, computes S and dP once per visible pair and adds each
step's dQ tile into ``dq_acc`` with one bulk reduce-add; an epilogue
kernel rounds ``dq_acc · scale`` to bf16.  dk and dv are deterministic;
dq's last bits may vary from run to run (the order of the adds).  f32
inputs run on the f32 cores, held to 3e-5.
:class:`FlashAttentionFn` ties the two together for autograd.

The wrappers check shapes, dtype, head_dim and the strides and raise on
anything the kernels do not take (for bf16, TMA needs the base pointers
and the batch, head and sequence strides in multiples of 16 bytes),
then call the kernel's custom op (``torch.ops.repro_torch.
flash_attention_fwd`` and ``flash_attention_bwd``): on CUDA tensors it
allocates the outputs with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch is refused, and counts
its launches (the forward in ``launches``, the backward in
``bwd_launches``).  On CPU tensors, which only a direct call of the op
reaches (the wrappers refuse them), the op runs the plain versions; on
fake tensors (``launch/dryrun.py``) its fake implementation gives the
outputs' shapes and launches nothing, and ``torch.utils.flop_counter``
counts its operations by ``kernels/bounds.py``.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import bounds, build, ref
from repro_torch.kernels.backend import (LaunchCounter, is_fake,
                                         refuse_autograd)
from repro_torch.kernels.ref import check_causal

HEAD_DIMS = (16, 32, 64, 128, 256)
#: blockIdx.y carries batch * query heads
MAX_BATCH_HEADS = 65535
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: TMA's alignment of a tensor's base address and strides, in bytes
TMA_ALIGN = 16
#: query rows of one step of the backward kernel; the rows of its f32
#: scratch (delta; for bf16 also lse2 and dq_acc) are padded to a multiple
#: of it
BWD_BLOCK_M = 64

launches = LaunchCounter("flash_attention")
bwd_launches = LaunchCounter("flash_attention_bwd")

#: the kernels' ops, ``torch.ops.repro_torch.flash_attention_{fwd,bwd}``:
#: defined on ``torch.library.Library`` (a dispatch costs ~2 µs on the
#: host, where ``torch.library.custom_op`` adds ~25)
_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, "
            "bool with_lse) -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor o, "
            "Tensor lse, Tensor do, bool causal) -> (Tensor, Tensor, Tensor)")

_bind_lock = threading.Lock()
_bound = {}


def _bind(name: str):
    """(``repro_<name>``, its error-string function) from
    ``csrc/<name>.cu``'s library, bound once."""
    with _bind_lock:
        if name not in _bound:
            lib = build.load(name)
            fn = getattr(lib, f"repro_{name}")
            pointers = 5 if name == "flash_attention" else 12
            fn.argtypes = ([ctypes.c_void_p] * pointers
                           + [ctypes.c_int64] * 15
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            err = getattr(lib, f"repro_{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _bound[name] = (fn, err)
    return _bound[name]


def _strides(t: torch.Tensor) -> tuple:
    """Element strides of [B, H, S, D] along B, H and S; a dimension of
    size 1 is never stepped along, so its stride is given as D (any
    multiple of 16 bytes would do)."""
    return tuple(t.stride(i) if t.shape[i] > 1 else t.shape[3]
                 for i in range(3))


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool) -> None:
    """Raise on anything the kernels do not take.  The device is checked
    last, so each of the other checks can be seen on CPU tensors; fake
    tensors skip the base pointers and the device (:func:`backend.is_fake`)."""
    fake = is_fake(q)
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
            if ((not fake and t.data_ptr() % TMA_ALIGN)
                    or any(st <= 0 or st * size % TMA_ALIGN
                           for st in _strides(t))):
                raise ValueError(
                    f"bf16 {name}: base pointer and batch, head and sequence "
                    f"strides {t.stride()[:3]} must be positive multiples of "
                    f"{TMA_ALIGN} bytes (TMA); the wrapper does not copy")
    if B * Hq > MAX_BATCH_HEADS:
        raise ValueError(f"B*Hq={B * Hq} > {MAX_BATCH_HEADS}")
    check_causal(Sq, Sk, causal)
    if fake:
        return
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the kernel needs q, k, v on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")


def _raise_on(err: int, err_string, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           f"{err_string(err).decode()} (cudaError {err})")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, with_lse: bool):
    """Check the inputs and run the forward op -> (out, lse or None)."""
    check_inputs(q, k, v, causal)
    out, lse = fwd_op(q, k, v, causal, with_lse)
    return out, (lse if with_lse else None)


def _fwd_outputs(q: torch.Tensor, with_lse: bool):
    B, Hq, Sq, D = q.shape
    out = q.new_empty((B, Hq, Sq, D))
    lse = q.new_empty((B, Hq, Sq) if with_lse else (0,), dtype=torch.float32)
    return out, lse


def _fwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, with_lse: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on inputs :func:`check_inputs` took -> (out, lse;
    an empty lse unless ``with_lse``): the op's CUDA implementation."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    out, lse = _fwd_outputs(q, with_lse)
    if out.numel() == 0:
        return out, lse
    fn, err_string = _bind("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr() if with_lse else 0,
                 B, Hq, Hkv, Sq, Sk, D,
                 *_strides(q), *_strides(k), *_strides(v),
                 _DTYPE_CODES[q.dtype], int(causal), D ** -0.5, stream)
    _raise_on(err, err_string, "flash_attention")
    launches.add()
    return out, lse


def _fwd_plain(q, k, v, causal, with_lse):
    """The plain version (``ref.attention``) and its row log-sum-exp."""
    out, lse = _fwd_outputs(q, with_lse)
    out.copy_(ref.attention(q, k, v, causal=causal))
    if with_lse:
        lse.copy_(ref.attention_lse(q, k, causal=causal))
    return out, lse


def _fwd_fake(q, k, v, causal, with_lse):
    check_inputs(q, k, v, causal)
    return _fwd_outputs(q, with_lse)


_LIB.impl("flash_attention_fwd", _fwd_launch, "CUDA")
_LIB.impl("flash_attention_fwd", _fwd_plain, "CPU")
torch.library.register_fake("repro_torch::flash_attention_fwd",
                            lib=_LIB)(_fwd_fake)
fwd_op = torch.ops.repro_torch.flash_attention_fwd.default


def attention_shape(q_shape, k_shape) -> tuple:
    """(B, Hq, Hkv, Sq, Sk, D) of q [B, Hq, Sq, D] and k [B, Hkv, Sk, D]:
    ``bounds.flash_bound``'s shape."""
    B, Hq, Sq, D = q_shape
    return (B, Hq, k_shape[1], Sq, k_shape[2], D)


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, with_lse, *args,
               **kwargs) -> int:
    return bounds.flash_bound(attention_shape(q_shape, k_shape), causal,
                              2)[1]


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, causal: bool = True):
    """The forward kernel, also writing each row's log-sum-exp of its
    scaled scores: -> (out [B, Hq, Sq, D], lse [B, Hq, Sq] f32, natural
    log): the backward's inputs (:class:`FlashAttentionFn`), and what
    combines the attention of several shards of the keys
    (``models/attention.py``'s cross-attention over sequence-sharded
    memory; ``kernels.ops.flash_attention_lse``).  No autograd: raises
    where autograd records (:class:`FlashAttentionFn` calls it inside its
    forward, where it does not)."""
    refuse_autograd("flash_attention (with its log-sum-exp)", (q, k, v),
                    "FlashAttentionFn is the differentiable forward")
    return _forward(q, k, v, causal, with_lse=True)


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                     causal: bool) -> None:
    """Raise on anything the backward kernel does not take: o and do
    contiguous [B, Hq, Sq, D] in q's dtype, lse contiguous f32 [B, Hq, Sq],
    all on q's device, then :func:`check_inputs` (whose device check comes
    last, so each check can be seen on CPU tensors)."""
    if q.dim() == 4:
        B, Hq, Sq, D = q.shape
        for name, t in (("o", o), ("do", do)):
            if (tuple(t.shape) != (B, Hq, Sq, D) or t.dtype != q.dtype
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"{name} must be contiguous "
                                 f"{(B, Hq, Sq, D)} {q.dtype} on {q.device}, "
                                 f"got {tuple(t.shape)} {t.dtype} {t.device}")
        if (tuple(lse.shape) != (B, Hq, Sq) or lse.dtype != torch.float32
                or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError(f"lse must be contiguous {(B, Hq, Sq)} float32, "
                             f"got {tuple(lse.shape)} {lse.dtype}")
    check_inputs(q, k, v, causal)


def bwd_workspace(q: torch.Tensor):
    """The backward kernel's f32 scratch for q [B, Hq, Sq, D], allocated
    with ``torch.empty`` on q's device (the kernels write every element
    they read) -> (delta, lse2, dq_acc), with Sq_pad = Sq rounded up to a
    multiple of ``BWD_BLOCK_M``: delta [B, Hq, Sq_pad]; for bf16 also lse2
    (the log-sum-exp in the log2 domain, +inf on the padded rows) of the
    same shape and dq_acc [B, Hq, Sq_pad, D], where the steps add their dQ
    tiles (64 rows each, in the kernel's fragment order); None for f32,
    whose kernels need neither."""
    B, Hq, Sq, D = q.shape
    pad = -(-Sq // BWD_BLOCK_M) * BWD_BLOCK_M
    delta = torch.empty((B, Hq, pad), dtype=torch.float32, device=q.device)
    if q.dtype != torch.bfloat16:
        return delta, None, None
    return (delta, torch.empty_like(delta),
            torch.empty((B, Hq, pad, D), dtype=torch.float32,
                        device=q.device))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        causal: bool = True):
    """The backward kernel: q, k, v as the forward took them, its output o
    and log-sum-exp lse, and the output's gradient do -> (dq, dk, dv),
    contiguous in q's dtype (dk and dv summed over each KV head's group).
    o and do must be contiguous [B, Hq, Sq, D] in q's dtype and lse f32
    [B, Hq, Sq]: the wrapper copies nothing.  bf16 launches three kernels
    (delta and the zeroed ``dq_acc``; the walk over key tiles; dq from
    ``dq_acc``), f32 two (dq with delta, then dk and dv), counted as one
    launch; the scratch is :func:`bwd_workspace`'s."""
    check_bwd_inputs(q, k, v, o, lse, do, causal)
    return bwd_op(q, k, v, o, lse, do, causal)


def _bwd_outputs(q: torch.Tensor, k: torch.Tensor):
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = q.new_empty(tuple(k.shape))
    return dq, dk, torch.empty_like(dk)


def _bwd_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                causal: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on inputs :func:`check_bwd_inputs` took: the
    op's CUDA implementation."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    dq, dk, dv = _bwd_outputs(q, k)
    if dq.numel() == 0 or Sk == 0:
        return dq.zero_(), dk, dv
    delta, lse2, dq_acc = bwd_workspace(q)
    fn, err_string = _bind("flash_attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), delta.data_ptr(),
                 0 if dq_acc is None else dq_acc.data_ptr(),
                 0 if lse2 is None else lse2.data_ptr(),
                 B, Hq, Hkv, Sq, Sk, D,
                 *_strides(q), *_strides(k), *_strides(v),
                 _DTYPE_CODES[q.dtype], int(causal), D ** -0.5, stream)
    _raise_on(err, err_string, "flash_attention_bwd")
    bwd_launches.add()
    return dq, dk, dv


def _bwd_plain(q, k, v, o, lse, do, causal):
    """The plain version, ``ref.attention_bwd``."""
    return tuple(g.contiguous()
                 for g in ref.attention_bwd(q, k, v, do, causal=causal))


def _bwd_fake(q, k, v, o, lse, do, causal):
    check_bwd_inputs(q, k, v, o, lse, do, causal)
    return _bwd_outputs(q, k)


_LIB.impl("flash_attention_bwd", _bwd_launch, "CUDA")
_LIB.impl("flash_attention_bwd", _bwd_plain, "CPU")
torch.library.register_fake("repro_torch::flash_attention_bwd",
                            lib=_LIB)(_bwd_fake)
bwd_op = torch.ops.repro_torch.flash_attention_bwd.default


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape,
               causal, *args, **kwargs) -> int:
    return bounds.bwd_bound(attention_shape(q_shape, k_shape), causal, 2)[1]


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient.  The
    forward saves q, k, v (views, not copies), its output and the
    log-sum-exp; under ``torch.utils.checkpoint`` they are those of the
    recompute.  The backward makes the incoming gradient contiguous (it
    arrives as a transposed view from the attention layer) and launches
    ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention_with_lse(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q [B, Hq, Sq, D], k and v [B, Hkv, Sk, D], f32 or bf16, on the card
    -> [B, Hq, Sq, D] contiguous in q's dtype; scores scaled by D^-1/2.
    Where autograd records (grad mode on and an input requires grad) it
    runs through :class:`FlashAttentionFn`, whose backward is the backward
    kernel; otherwise the forward kernel alone, writing no log-sum-exp."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal)
    return _forward(q, k, v, causal, with_lse=False)[0]
