"""Sharding rules: logical parameter/activation layout -> mesh placements.

The counterpart of ``repro/launch/sharding.py``.  The rule table is the
JAX package's, copied unchanged (:data:`MATRIX_NAMES`,
:func:`param_logical_spec`, :func:`cache_logical_spec`, :func:`_resolve_axis`
and its ``"dp_only"`` policy), so one suffix-matching table covers every
architecture in the zoo.  Logical axes:

    "dp"    data parallel (+FSDP): maps to ("pod","data") on multi-pod
    "tp"    tensor/expert/sequence parallel: maps to "model"
    "flat"  fully flattened (quantized optimizer payloads): dp x tp

Where the JAX package builds a ``NamedSharding``, the port builds a
:class:`Sharding`: the ``DeviceMesh``, one DTensor placement per mesh
dimension, and the resolved spec they come from (one entry per tensor
dimension: None, a mesh axis, or a tuple of axes, as a ``PartitionSpec``
holds them).  The rank padding and the divisibility guard are the JAX
package's: a dimension that does not divide falls back to replication.  A
tensor dimension resolved to several axes, ``("pod", "data")``, is
``Shard(d)`` on each of those mesh dimensions; DTensor nests them in mesh
order, outermost first, which is JAX's major-to-minor order (so a rank's
shard is the one ``devices_indices_map`` gives its device:
:func:`shard_slices`).

Paths are named as the JAX package names them (``_path_names``): the
port's trees are walked by ``train.checkpoint.flatten_with_path``, a list
index is ``[i]`` and a NamedTuple field (``AdamState.mu``, ``QTensor.qv``)
its name.  The port's parameters are per layer where the JAX package's are
stacked; a layer's leaf has the trailing dimensions of its stack's leaf,
so the rank padding gives it the same placements.

The runtime half, for ``launch/train.py``'s mesh path: :func:`distribute`
(a full tensor -> its DTensor), :func:`gather` (a DTensor -> the full
tensor: checkpoints) and :func:`reduce_to` (a
full gradient summed over mesh axes, back to its storage placements: the
gather-whole path that :func:`gather_layer`'s backward is tested
against).

*Compute shards.*  Where GSPMD partitions the JAX package's compute by the
rule table, the port's layers run tensor-parallel over ``model``
(``models/common.py:TensorParallel``), each rank on its *compute slice*
of a leaf: for most leaves its storage shard along the model axis, but
not for three (:func:`compute_slice`):

* ``w_xz`` is sharded over its concatenated [x | z] columns, so at a model
  axis of 2 or more the low ranks store only x columns and the high ranks
  only z; a rank computes its heads' x *and* z columns;
* ``wk`` and ``wv`` (and their biases) where the KV heads are fewer than
  the axis (8 on 16: llama3-8b, qwen2-72b, dbrx, jamba; internvl2-1b's 2):
  column shards cut a head in half, and a rank needs the KV head of its
  query heads whole (``common.head_ranges``): each KV head is computed on
  the ranks that share it;
* query heads the axis does not divide (qwen1.5-4b's 20, internvl2-1b's
  14 on 16): the first ranks take one more head (``common.head_ranges``),
  so rank 0, the rank the dry run traces, computes the most; the rest of
  its ``wq`` columns and ``wo`` rows then lie across storage shards.

Mamba's per-head vectors (``a_log``, ``d_skip``, ``dt_bias``) and
``w_dt``'s columns are stored whole and computed on the rank's heads.
Such a slice is had from the storage shard by an all-gather over
``model`` of that one leaf, then a slice; its gradient goes back as the
slice's adjoint: zeros elsewhere, summed over ``model`` (a reduce-scatter
to the storage shard; an all-reduce for a leaf stored whole), which also
adds the parts of a KV head that its ranks computed.  Leaves whose compute
is whole on every rank have their whole gradient on each (the layers make
it so, ``common.copy_to``), but for mamba's B|C path (:data:`PARTIAL_GRAD`:
it feeds the SSD of the rank's heads only), summed over ``model``.

:class:`LeafPlan` holds one leaf's storage and compute slices, and
:func:`gather_layer` is FSDP's pattern over a layer: one
``autograd.Function`` whose forward all-gathers the layer's shards over
the data-parallel axes (and ``model``, where a compute slice needs it) and
whose backward reduce-scatters the layer's gradient straight back to the
storage placements.  The layers call it inside their remat region, so the
backward gathers again rather than keeping the layer.

*Decode caches.*  :func:`cache_sharding` places one decode-cache leaf
as ``decode_shardings`` does (``launch/train.py:MeshModel.init_decode``
allocates each rank's shards only), and :func:`kv_shard` reads a KV
cache's geometry on this rank off its placement: the positions it holds,
the groups of the mesh axes that split them (the reductions of split-K
attention), the KV heads it holds under ``cache_shard="heads"``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.models import common
from repro_torch.train.checkpoint import _Attr, _unflatten, flatten_with_path
from repro_torch.train.optimizer import tree_leaves, tree_map

MATRIX_NAMES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
                "w_out", "w_xz", "w_bc", "w_dt", "out_proj", "router",
                "embed", "unembed", "frontend_proj", "in_proj", "conv_x_w",
                "conv_bc_w"}


def _path_names(path) -> List[str]:
    """A ``flatten_with_path`` path as the JAX package names its entries:
    dict keys and NamedTuple fields by name, sequence indices ``[i]``."""
    return [f"[{k}]" if isinstance(k, int) and not isinstance(k, _Attr)
            else str(k) for k in path]


def param_logical_spec(names: List[str]) -> Tuple[Optional[str], ...]:
    """Trailing-dims logical spec for a parameter leaf, by name suffix."""
    last = names[-1] if names else ""
    in_moe = "moe" in names and "shared" not in names

    # quantized optimizer payloads: the int8 payload is parameter-shaped and
    # takes the parameter's spec verbatim; the per-row scale tensor is the
    # parameter reduced over its last axis, so it takes the spec minus the
    # last entry
    if last == "qv":
        return param_logical_spec(names[:-1])
    if last == "qscale":
        return param_logical_spec(names[:-1])[:-1] or (None,)

    if last in ("embed", "unembed"):
        return ("tp", "dp")
    if last == "frontend_proj":
        return (None, "tp")
    if last in ("wq", "wk", "wv"):
        return ("dp", "tp")
    if last == "wo":
        return ("tp", "dp")
    if last in ("bq", "bk", "bv"):
        return ("tp",)
    if last == "router":
        return ("dp", None)
    if in_moe and last in ("w_gate", "w_up"):
        return ("tp", "dp", None)  # [E, d, ff]
    if in_moe and last == "w_down":
        return ("tp", None, "dp")  # [E, ff, d]
    if last in ("w_gate", "w_up", "w_in"):
        return ("dp", "tp")
    if last in ("w_down", "w_out", "out_proj"):
        return ("tp", "dp")
    if last == "b_in":
        return ("tp",)
    if last == "w_xz":
        return ("dp", "tp")
    if last in ("w_bc", "w_dt"):
        return ("dp", None)
    if last == "conv_x_w":
        return (None, "tp")
    if last == "conv_x_b":
        return ("tp",)
    if last == "scale" and "mamba" in names:
        return ("tp",)  # gated-norm scale is d_inner-sized
    # norms, biases, dt/a/d vectors, conv_bc: replicate
    return (None,)


def cache_logical_spec(names: List[str], batch_is_one: bool
                       ) -> Tuple[Optional[str], ...]:
    """Trailing-dims spec for decode-cache leaves."""
    last = names[-1] if names else ""
    seq = ("dp", "tp") if batch_is_one else "tp"
    if last in ("k", "v", "cross_k", "cross_v"):
        # [B, Hkv, S, D]
        return (None if batch_is_one else "dp", None, seq, None)
    if last == "conv_x":
        return (None if batch_is_one else "dp", None, "tp")
    if last == "conv_bc":
        return (None if batch_is_one else "dp", None, None)
    if last == "ssm":
        return (None if batch_is_one else "dp", "tp", None, None)
    return (None,)


def _resolve_axis(logical: Optional[str], mesh, policy: str = "2d") -> Any:
    """policy "2d": dp x tp Megatron layout.  policy "dp_only": the model
    axis folds into data parallelism (small archs where 16-way TP is pure
    collective overhead) — "tp" pins dissolve, "dp" spans every axis."""
    if logical is None:
        return None
    dp = dp_axes(mesh)
    if policy == "dp_only":
        if logical == "tp":
            return None
        if logical in ("dp", "flat"):
            return dp + ("model",)
    if logical == "dp":
        return dp if len(dp) > 1 else dp[0]
    if logical == "tp":
        return "model"
    if logical == "flat":
        return dp + ("model",)
    if isinstance(logical, tuple):  # e.g. ("dp", "tp") for b1 sequence
        out = []
        for item in logical:
            r = _resolve_axis(item, mesh, policy)
            if r is not None:
                out.extend(r if isinstance(r, tuple) else (r,))
        return tuple(out) or None
    raise ValueError(f"unknown logical axis {logical!r}")


def _axes(resolved) -> Tuple[str, ...]:
    if resolved is None:
        return ()
    return resolved if isinstance(resolved, tuple) else (resolved,)


def _axis_size(mesh, resolved) -> int:
    size = 1
    for a in _axes(resolved):
        size *= axis_size(mesh, a)
    return size


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives on a mesh: the mesh, one DTensor placement per
    mesh dimension, and the resolved spec they come from (one entry per
    tensor dimension)."""

    mesh: DeviceMesh
    placements: Tuple[Any, ...]
    spec: Tuple[Any, ...]

    @property
    def replicas(self) -> int:
        """How many ranks hold each shard: the product of the mesh
        dimensions the tensor is replicated over."""
        n = 1
        for i, p in enumerate(self.placements):
            if isinstance(p, Replicate):
                n *= self.mesh.size(i)
        return n

    @property
    def shard_counts(self) -> Tuple[int, ...]:
        """Into how many shards each tensor dimension is split."""
        return tuple(_axis_size(self.mesh, r) for r in self.spec)

    def reduce_last_axis_max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (a per-row statistic of this tensor's local shard) as its
        maximum over the ranks that share the rows, in place: an all-reduce
        over each mesh dimension that shards the last axis."""
        for axis in (_axes(self.spec[-1]) if self.spec else ()):
            dist.all_reduce(t, op=dist.ReduceOp.MAX,
                            group=self.mesh.get_group(axis))
        return t


def to_named_sharding(mesh: DeviceMesh, logical: Sequence,
                      shape: Tuple[int, ...],
                      policy: str = "2d") -> Sharding:
    """Logical trailing spec -> :class:`Sharding`, with rank padding and a
    divisibility guard (non-dividing dims fall back to replication)."""
    logical = tuple(logical)
    if len(logical) < len(shape):
        logical = (None,) * (len(shape) - len(logical)) + logical
    elif len(logical) > len(shape):
        logical = logical[len(logical) - len(shape):]
    resolved = []
    for dim, ax in zip(shape, logical):
        r = _resolve_axis(ax, mesh, policy)
        if r is not None and dim % _axis_size(mesh, r) != 0:
            r = None  # guard: replicate instead of uneven shard
        resolved.append(r)
    names = mesh.mesh_dim_names
    placements: List[Any] = [Replicate() for _ in names]
    for d, r in enumerate(resolved):
        axes = _axes(r)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            # DTensor nests a dimension's shards in mesh order; JAX in the
            # entry's order.  No rule of the table resolves out of order.
            raise ValueError(f"spec entry {r} is not in mesh order {names}")
        for i in order:
            placements[i] = Shard(d)
    return Sharding(mesh, tuple(placements), tuple(resolved))


def tree_shardings(mesh: DeviceMesh, tree, spec_fn,
                   policy: str = "2d") -> Any:
    """``spec_fn(path_names)`` -> logical spec, over every leaf of
    ``tree`` (anything with a ``.shape``: tensors, DTensors, arrays)."""
    values = [to_named_sharding(mesh, spec_fn(_path_names(path)),
                                tuple(leaf.shape), policy)
              for path, leaf in flatten_with_path(tree)]
    return _unflatten(tree, iter(values))


def param_shardings(mesh: DeviceMesh, params, policy: str = "2d") -> Any:
    return tree_shardings(mesh, params, param_logical_spec, policy)


def opt_state_shardings(mesh: DeviceMesh, state, policy: str = "2d") -> Any:
    """Optimizer state: moments follow the parameter rules (the QTensor
    fields match via their own names); `step` replicates."""

    def spec(names):
        if names and names[-1] == "step":
            return ()
        return param_logical_spec(names)

    return tree_shardings(mesh, state, spec, policy)


def batch_shardings(mesh: DeviceMesh, batch_specs: Dict[str, Any],
                    policy: str = "2d") -> Dict[str, Sharding]:
    """Train/prefill inputs: leading batch dim over dp, rest replicated."""
    out = {}
    for k, s in batch_specs.items():
        logical = ("dp",) + (None,) * (len(s.shape) - 1)
        out[k] = to_named_sharding(mesh, logical, tuple(s.shape), policy)
    return out


def decode_cache_spec(names: List[str], batch_is_one: bool,
                      cache_shard: str = "seq") -> Tuple[Optional[str], ...]:
    """A decode-cache leaf's logical spec: :func:`cache_logical_spec`, or
    under ``cache_shard="heads"`` the KV caches' heads over ``model``."""
    if cache_shard == "heads" and names and names[-1] in (
            "k", "v", "cross_k", "cross_v"):
        return (None if batch_is_one else "dp", "tp", None, None)
    return cache_logical_spec(names, batch_is_one)


def decode_shardings(mesh: DeviceMesh, decode_specs: Dict[str, Any],
                     batch: int, policy: str = "2d",
                     cache_shard: str = "seq") -> Dict:
    """State + token shardings for the decode cells.

    cache_shard "seq": split-K over the cache sequence axis (universal).
    cache_shard "heads": shard kv heads over `model` instead — viable when
    num_kv_heads divides the model axis (e.g. gemma's 16), and avoids the
    dynamic-update-slice on a sharded axis entirely.
    """
    b1 = batch == 1

    def spec_fn(names):
        return decode_cache_spec(names, b1, cache_shard)

    state_sh = tree_shardings(mesh, decode_specs["state"], spec_fn, policy)
    token_sh = to_named_sharding(mesh, ("dp", None),
                                 tuple(decode_specs["token"].shape), policy)
    return {"state": state_sh, "token": token_sh}


def cache_sharding(mesh: DeviceMesh, name: str, shape: Sequence[int],
                   batch: int, policy: str = "2d",
                   cache_shard: str = "seq") -> Sharding:
    """One decode-cache leaf's :class:`Sharding` in ``decode_shardings``'
    placements, by its own name (``k``, ``v``, ``cross_k``, ``cross_v``,
    ``conv_x``, ``conv_bc``, ``ssm``, ``length``) and global ``shape``;
    ``batch`` is the global batch."""
    return to_named_sharding(
        mesh, decode_cache_spec([name], batch == 1, cache_shard),
        tuple(shape), policy)


def kv_shard(sh: Sharding, shape: Sequence[int]) -> common.CacheShard:
    """A KV cache leaf's geometry on this rank (``common.CacheShard``), from
    its :class:`Sharding` and global shape [B, Hkv, S, D]: the first
    position it holds, the groups of the mesh axes that split the
    positions (the reductions of split-K attention; one a mesh axis of
    more than one rank, none where the guard left them whole) and the KV
    heads it holds where they are split over ``model``."""
    cut = shard_slices(sh, shape)
    heads = None if sh.spec[1] is None else (cut[1].start, cut[1].stop)
    groups = tuple(sh.mesh.get_group(a) for a in _axes(sh.spec[2])
                   if axis_size(sh.mesh, a) > 1)
    return common.CacheShard(start=cut[2].start, total=shape[2],
                             groups=groups, heads=heads)


def explain(shardings, tree, max_rows: int = 0) -> List[str]:
    """Human-readable (path, shape, spec, placements) rows for logging."""
    rows = [f"{'/'.join(_path_names(path)):60s} {str(tuple(leaf.shape)):24s}"
            f" {sh.spec} {list(sh.placements)}"
            for (path, leaf), (_, sh) in zip(flatten_with_path(tree),
                                             flatten_with_path(shardings))]
    return rows[:max_rows] if max_rows else rows


# ---------------------------------------------------------------------------
# shards
# ---------------------------------------------------------------------------
def shard_slices(sh: Sharding, shape: Sequence[int],
                 coordinate: Optional[Sequence[int]] = None
                 ) -> Tuple[slice, ...]:
    """The part of a tensor of ``shape`` that the rank at ``coordinate``
    on the mesh (default: this rank's) holds: per dimension, the shard
    numbered major to minor over the entry's axes."""
    names = sh.mesh.mesh_dim_names
    coord = (sh.mesh.get_coordinate() if coordinate is None
             else list(coordinate))
    out = []
    for dim, r in zip(shape, sh.spec):
        index, count = 0, 1
        for a in _axes(r):
            i = names.index(a)
            index = index * sh.mesh.size(i) + coord[i]
            count *= sh.mesh.size(i)
        size = dim // count
        out.append(slice(index * size, (index + 1) * size))
    return tuple(out)


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= s
    return tuple(reversed(stride))


def from_local(local: torch.Tensor, sh: Sharding,
               shape: Sequence[int]) -> DTensor:
    """This rank's shard -> the DTensor of global ``shape``."""
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def distribute(t: torch.Tensor, sh: Sharding) -> DTensor:
    """A full tensor (the same on every rank) -> its DTensor, holding
    only this rank's shard (``t`` itself where the shard is all of it)."""
    local = t[shard_slices(sh, t.shape)]
    if local.shape != t.shape:
        local = local.clone()
    return from_local(local, sh, t.shape)


def gather(x) -> torch.Tensor:
    """A DTensor -> the full tensor on every rank (its local tensor where
    it is replicated on every mesh dimension); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    if all(isinstance(p, Replicate) for p in x.placements):
        return x.to_local()
    return x.full_tensor()


def reduce_to(g: torch.Tensor, sh: Sharding,
              sum_axes: Sequence[str]) -> torch.Tensor:
    """A full gradient that is partial over the mesh axes ``sum_axes``
    (each rank's own rows) and replicated over the others -> this rank's
    shard of its sum, in ``sh``'s placements (a reduce-scatter over the
    axes that shard it, an all-reduce over those that do not)."""
    names = sh.mesh.mesh_dim_names
    partial = [Partial() if a in sum_axes else Replicate() for a in names]
    d = DTensor.from_local(g, sh.mesh, partial, run_check=False)
    return d.redistribute(sh.mesh, sh.placements).to_local()


def sharding_of(x: DTensor) -> Sharding:
    """A DTensor's :class:`Sharding`: its mesh, its placements, and the
    spec they resolve (each tensor dimension's mesh axes, in mesh
    order)."""
    names = x.device_mesh.mesh_dim_names
    spec = []
    for d in range(x.dim()):
        axes = tuple(n for n, p in zip(names, x.placements)
                     if isinstance(p, Shard) and p.dim == d)
        spec.append(None if not axes else axes[0] if len(axes) == 1
                    else axes)
    return Sharding(x.device_mesh, tuple(x.placements), tuple(spec))


# ---------------------------------------------------------------------------
# compute shards: tensor-parallel compute
# ---------------------------------------------------------------------------
#: leaves computed whole on every rank of the model axis whose gradient a
#: rank holds only in part: mamba's B|C projection and conv, whose output
#: feeds the SSD of the rank's heads
PARTIAL_GRAD = {"w_bc", "conv_bc_w", "conv_bc_b"}

Ranges = Tuple[Tuple[int, int], ...]


def _ranges(dim: int, shape, ranges) -> Optional[Tuple[int, Ranges]]:
    """``(dim, ranges)`` with adjacent ranges merged; None where they cover
    the whole dimension (the compute is the whole leaf)."""
    merged: List[List[int]] = []
    for a, b in ranges:
        if merged and merged[-1][1] == a:
            merged[-1][1] = b
        else:
            merged.append([a, b])
    out = tuple((a, b) for a, b in merged)
    return None if out == ((0, shape[dim]),) else (dim, out)


def compute_slice(names: List[str], shape: Sequence[int], cfg, size: int,
                  rank: int) -> Optional[Tuple[int, Ranges]]:
    """The part of a leaf (path ``names``, global ``shape``) that the rank
    ``rank`` of a model axis of ``size`` computes with: ``(dim, ranges)``,
    the ranges of ``dim`` concatenated in order, or None for the whole
    leaf.  The layers read their head and channel counts off these
    shapes."""
    last = names[-1]
    ndim = len(shape)
    if last in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
        D = cfg.head_dim
        q0, q1, k0, k1 = common.head_ranges(cfg.num_heads, cfg.num_kv_heads,
                                            size, rank)
        if last == "wo":
            return _ranges(0, shape, [(q0 * D, q1 * D)])
        lo, hi = (q0, q1) if last in ("wq", "bq") else (k0, k1)
        return _ranges(ndim - 1, shape, [(lo * D, hi * D)])
    if "mamba" in names:
        P, di = cfg.ssm_head_dim, cfg.ssm_d_inner
        h0, h1 = common.partition(cfg.ssm_heads, size, rank)
        channels = [(h0 * P, h1 * P)]
        if last == "w_xz":
            return _ranges(1, shape, channels + [(di + h0 * P, di + h1 * P)])
        if last in ("conv_x_w", "conv_x_b", "scale"):
            return _ranges(ndim - 1, shape, channels)
        if last == "out_proj":
            return _ranges(0, shape, channels)
        if last in ("w_dt", "a_log", "d_skip", "dt_bias"):
            return _ranges(ndim - 1, shape, [(h0, h1)])
        return None
    if "moe" in names and "shared" not in names and last in (
            "w_gate", "w_up", "w_down"):
        return _ranges(0, shape, [common.partition(shape[0], size, rank)])
    if last in ("w_gate", "w_up", "w_in", "b_in"):
        return _ranges(ndim - 1, shape,
                       [common.partition(shape[-1], size, rank)])
    if last in ("w_down", "w_out"):
        return _ranges(0, shape, [common.partition(shape[0], size, rank)])
    if last in ("embed", "unembed"):
        return _ranges(0, shape, [common.partition(shape[0], size, rank)])
    if last == "frontend_proj" and shape[1] % size == 0:
        return _ranges(1, shape, [common.partition(shape[1], size, rank)])
    return None


def _group(mesh, axis):
    return mesh.get_group(axis), axis_size(mesh, axis)


def _take(t: torch.Tensor, dim: int, ranges: Ranges) -> torch.Tensor:
    parts = [t.narrow(dim, a, b - a) for a, b in ranges]
    return parts[0].contiguous() if len(parts) == 1 else torch.cat(parts, dim)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """One leaf's storage shard -> its compute slice, and the gradient's
    way back.  ``spec``: the storage spec (its DTensor's); ``tp_axis``:
    the model axis where compute is tensor-parallel (None: the model axis
    is data-parallel, ``"dp_only"``); ``sum_axes``: the data-parallel axes
    whose ranks ran other rows; ``compute``: :func:`compute_slice`'s;
    ``sum_model``: the gradient of a whole compute is partial over
    ``model`` (:data:`PARTIAL_GRAD`)."""

    mesh: DeviceMesh
    spec: Tuple[Any, ...]
    shape: Tuple[int, ...]
    tp_axis: Optional[str]
    sum_axes: Tuple[str, ...]
    compute: Optional[Tuple[int, Ranges]]
    sum_model: bool = False

    def _dp(self, d: int) -> Tuple[str, ...]:
        return tuple(a for a in _axes(self.spec[d]) if a != self.tp_axis)

    @property
    def model_dim(self) -> Optional[int]:
        """The storage dimension sharded over the model axis, if any."""
        for d, entry in enumerate(self.spec):
            if self.tp_axis is not None and self.tp_axis in _axes(entry):
                return d
        return None

    @property
    def local(self) -> bool:
        """The compute slice is the storage shard (along the model axis):
        no model-axis collective either way."""
        mdim = self.model_dim
        if self.compute is None:
            return mdim is None and not self.sum_model
        dim, ranges = self.compute
        if mdim != dim:
            return False
        n = axis_size(self.mesh, self.tp_axis)
        m = self.mesh.get_local_rank(self.tp_axis)
        size = self.shape[dim] // n
        return ranges == ((m * size, (m + 1) * size),)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The storage shard -> the compute slice."""
        for d in range(len(self.spec)):
            for a in reversed(self._dp(d)):  # innermost axis first
                t = common.all_gather_dim(t, d, *_group(self.mesh, a))
        if self.local:
            return t
        mdim = self.model_dim
        if mdim is not None:
            t = common.all_gather_dim(t, mdim,
                                      *_group(self.mesh, self.tp_axis))
        return t if self.compute is None else _take(t, *self.compute)

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """The compute slice's gradient -> the storage shard's, summed over
        the ranks that ran other rows (and over ``model`` where the slice
        is one of several)."""
        if not self.local:
            summed = self.sum_model
            if self.compute is not None:
                dim, ranges = self.compute
                full = g.new_zeros(self.shape)
                at = 0
                for a, b in ranges:
                    full.narrow(dim, a, b - a).copy_(
                        g.narrow(dim, at, b - a))
                    at += b - a
                g, summed = full, True
            group, n = _group(self.mesh, self.tp_axis)
            mdim = self.model_dim
            if mdim is None:
                if summed and n > 1:
                    g = common.all_reduce(g, group)
            elif summed:
                g = common.reduce_scatter_dim(g, mdim, group, n)
            else:
                g = common.own_chunk(g, mdim,
                                     self.mesh.get_local_rank(self.tp_axis),
                                     n)
        sharded = set()
        for d in range(len(self.spec)):
            for a in self._dp(d):  # outermost axis first
                sharded.add(a)
                group, n = _group(self.mesh, a)
                if a in self.sum_axes:
                    g = common.reduce_scatter_dim(g, d, group, n)
                else:
                    g = common.own_chunk(g, d, self.mesh.get_local_rank(a),
                                         n)
        for a in self.sum_axes:
            group, n = _group(self.mesh, a)
            if a not in sharded and n > 1:
                g = common.all_reduce(g, group)
        return g


def layer_plans(params, cfg, tp: common.TensorParallel,
                sum_axes: Sequence[str], tp_axis: Optional[str] = "model"):
    """A tree of DTensors (the parameters in their storage placements) ->
    the same tree of :class:`LeafPlan`."""
    plans = []
    for path, leaf in flatten_with_path(params):
        names = _path_names(path)
        sh = sharding_of(leaf)
        shape = tuple(leaf.shape)
        compute = None if tp_axis is None else compute_slice(
            names, shape, cfg, tp.size, tp.rank)
        plans.append(LeafPlan(sh.mesh, sh.spec, shape, tp_axis,
                              tuple(sum_axes), compute,
                              tp_axis is not None
                              and names[-1] in PARTIAL_GRAD))
    return _unflatten(params, iter(plans))


class _LayerGather(torch.autograd.Function):
    """One layer's storage shards -> its compute slices; backward: each
    slice's gradient back to its shard (:meth:`LeafPlan.reduce`)."""

    @staticmethod
    def forward(ctx, plans, *shards):
        ctx.plans = plans
        return tuple(p.gather(s) for p, s in zip(plans, shards))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(p.reduce(g)
                               for p, g in zip(ctx.plans, grads))


def gather_layer(shards: common.Shards):
    """A layer's :class:`common.Shards` -> its compute tensors, in the
    tree of its local shards."""
    outs = iter(_LayerGather.apply(tuple(tree_leaves(shards.plan)),
                                   *tree_leaves(shards.local)))
    return tree_map(lambda _: next(outs), shards.local)


def model_layers(local, plans) -> dict:
    """The tree the model takes on a mesh: each layer of a parameter tree
    (each element of a layer list, each other top-level entry) as its
    :class:`common.Shards`."""
    out = {}
    for key, value in local.items():
        if isinstance(value, list):
            out[key] = [common.Shards(v, p) for v, p in zip(value,
                                                            plans[key])]
        else:
            out[key] = common.Shards(value, plans[key])
    return out


def tensor_parallel(mesh: DeviceMesh,
                    policy: str = "2d") -> common.TensorParallel:
    """The model axis of ``mesh`` as the layers' context: tensor-parallel
    under the "2d" policy; a group of none under "dp_only", where the
    model axis is data-parallel.  Sequence parallelism is off here:
    ``transformer.forward`` turns it on where the config asks and the
    sequence divides."""
    if policy == "dp_only" or "model" not in mesh.mesh_dim_names:
        return common.TensorParallel(None, 0, 1, gather=gather_layer)
    return common.TensorParallel(mesh.get_group("model"),
                                 mesh.get_local_rank("model"),
                                 axis_size(mesh, "model"),
                                 gather=gather_layer)
