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
tensor, for compute) and :func:`reduce_to` (a full gradient summed over
the data-parallel axes, back to its storage placements).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.launch.mesh import axis_size, dp_axes
from repro_torch.train.checkpoint import _Attr, _unflatten, flatten_with_path

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
        s = cache_logical_spec(names, b1)
        if cache_shard == "heads" and names and names[-1] in (
                "k", "v", "cross_k", "cross_v"):
            return (None if b1 else "dp", "tp", None, None)
        return s

    state_sh = tree_shardings(mesh, decode_specs["state"], spec_fn, policy)
    token_sh = to_named_sharding(mesh, ("dp", None),
                                 tuple(decode_specs["token"].shape), policy)
    return {"state": state_sh, "token": token_sh}


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
