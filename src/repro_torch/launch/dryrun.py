"""Multi-node dry run: every (arch x shape x mesh) cell's step on fake
tensors, on H100 nodes that are not there.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out dryrun.jsonl

The counterpart of ``repro/launch/dryrun.py``.  There is no HLO to
compile: the port's own code runs, once, on ``FakeTensor``s (shapes,
dtypes and strides, no memory), in one process that stands for rank 0 of
a production mesh (``launch/mesh.py``: 16 x 16, or 2 x 16 x 16 with
``--mesh multi``) on torch's fake process group, whose collectives return
at once.  Run it as a fresh process: the process group is its own.  It
needs no card; the fake tensors are ``cuda`` tensors where PyTorch has
CUDA, else ``cpu`` ones (a CPU build's autograd cannot take a ``cuda``
tensor), and they take the card's route either way (``kernels/ops.py``'s
``"auto"``): attention and the SSD through the kernels' custom ops
(``kernels/flash_attention.py``, ``kernels/ssd_scan.py``), whose fake
implementations give the outputs' shapes and launch nothing.

A cell's state is ``launch/train.py:state_layout`` with a fake leaf,
placed by the rule table (``param_shardings``, ``opt_state_shardings``,
``batch_shardings``, ``decode_shardings``): each rank holds its shards as
DTensors.  A train cell runs ``launch/train.py:make_mesh_train_step``
itself: the model tensor-parallel over ``model``, each layer gathering
its shards (``launch/sharding.py:gather_layer``).  A prefill cell runs the
same tensor-parallel forward under ``no_grad`` over the rank's rows.  A
decode cell runs ``launch/train.py:make_mesh_decode_step`` on bf16
parameters (as the JAX dry run casts them) and on the rank's shards of
the caches (``decode_shardings``, the JAX cell's ``in_shardings``):
each layer gathered over the data axes and run tensor-parallel over
``model``, attention split-K over the cache's sequence shards (the
softmax's max and sum and the P·V partials reduced over the sequence's
axes) or, with ``--cache-shard heads``, local to the rank's KV heads; the
new position is written into the shard that holds it (the JAX cell's
``out_shardings``), the logits gathered whole for the rank's rows.  Every
mesh cell's ``options`` read ``"step": "tensor-parallel"``.  ``--seqpar`` sets
``cfg.sequence_parallel``, as the JAX dry run does.  ``--mesh local`` runs a
``--mesh-data`` x ``--mesh-model`` mesh, and ``--mesh none`` the step
without a mesh (``train.make_train_step``: one device, what
``chip_smoke.py``'s ``llama_train`` runs).

While the step runs it counts:

* ``flops_per_device``: ``torch.utils.flop_counter.FlopCounterMode``,
  the kernels' operations by ``kernels/bounds.py``;
* ``hbm_bytes_per_device``: each op that is not a view adds the bytes of
  its tensor inputs (the distinct elements: a broadcast is read once) and
  outputs, the eager program's HBM traffic (``models/costs.py`` models
  it);
* ``collective_bytes_per_device`` by kind, from the c10d ops the rank
  issues, with the JAX dry run's ring factors (all-reduce 2x its operand,
  all-gather its result, the others their operand), each priced at the
  link its group crosses (``core/perfmodel.py:link_bytes_per_s``);
* ``bytes_per_device``: the rank's live fake storages, ``arguments`` at
  the step's start, ``peak_estimate`` the most live at once, ``temps`` the
  difference, ``outputs`` what the step returns beyond its arguments.

The roofline (``core/perfmodel.py:roofline_terms``) prices them with the
H100's data sheet figures: a model, not a measurement.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import sys
import time
import traceback
import weakref
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import convert
from repro_torch.configs.base import SHAPES, get_config, list_archs
from repro_torch.core import perfmodel
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import train as ptrain
from repro_torch.models import build, costs
from repro_torch.models.model_zoo import _padded_cfg, input_specs, padded_vocab
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import _unflatten, flatten_with_path

#: per-device wire-byte multiplier against the reference size (ring
#: algorithms): repro/launch/dryrun.py:_WIRE_FACTOR
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0,
                "broadcast": 1.0}
_COLL_KINDS = tuple(_WIRE_FACTOR)
#: c10d op name fragments -> collective kind
_KIND_OF = (("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
            ("broadcast", "broadcast"), ("permute", "collective-permute"))
#: ops that move no bytes: allocation, metadata, and views that the
#: schema does not mark as aliases
_NO_TRAFFIC = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
               "_local_scalar_dense", "sym_size", "sym_stride",
               "sym_numel", "sym_storage_offset", "is_same_size"}
#: ops that take a tensor for its dtype and device only: their output is
#: written, their input not read
_WRITE_ONLY = {"new_zeros", "new_ones", "new_full", "zeros_like",
               "ones_like", "full_like"}
MESHES = {"single": [False], "multi": [True], "both": [False, True]}


def fake_device() -> str:
    """``cuda`` where PyTorch has a card, else ``cpu``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def hbm_capacity() -> float:
    """The card's own memory where there is one, else the data sheet's."""
    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return perfmodel.H100_HBM_BYTES


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _distinct_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor reads: its size without the
    dimensions it is broadcast along (stride 0)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def group_ranks(func, args) -> tuple:
    """The global ranks of a c10d op's process group."""
    if func.namespace == "_c10d_functional":
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = next(a for a in reversed(args) if isinstance(a, str))
        pg = _resolve_process_group(name)
    else:
        pg = dist.ProcessGroup.unbox(
            next(a for a in args if isinstance(a, torch.ScriptObject)))
    return tuple(dist.get_process_group_ranks(pg))


def collective_kind(name: str) -> Optional[str]:
    for fragment, kind in _KIND_OF:
        if fragment in name:
            return kind
    return None


def price_collectives(events) -> Dict[str, float]:
    """Per-device wire bytes by kind, and seconds, of recorded collectives
    ``(kind, operand bytes, result bytes, ranks)``: all-gather counts its
    result, the others their operand, times the ring factor; a group of
    one rank puts nothing on the wire."""
    out = {k: 0.0 for k in _COLL_KINDS}
    seconds = 0.0
    for kind, operand, result, ranks in events:
        if len(ranks) <= 1:
            continue
        wire = _WIRE_FACTOR[kind] * (result if kind == "all-gather"
                                     else operand)
        out[kind] += wire
        seconds += wire / perfmodel.link_bytes_per_s(ranks)
    out["total"] = sum(out[k] for k in _COLL_KINDS)
    out["seconds"] = seconds
    return out


class StepCounter(TorchDispatchMode):
    """Counts one rank's step as it runs on fake tensors: the HBM bytes of
    each op that is not a view, the collectives, the kernels' custom ops,
    and the live storages (each output storage is live until the last
    tensor on it dies)."""

    def __init__(self):
        super().__init__()
        self.hbm_bytes = 0
        self.events = []
        self.kernel_calls = collections.Counter()
        self._refs: Dict[int, int] = {}
        self._sizes: Dict[int, int] = {}
        self.live = 0
        self.peak = 0

    def hold(self, tree) -> int:
        """Track the storages of ``tree``'s tensors (the step's arguments):
        -> their bytes."""
        before = self.live
        for t in _tensors(tree):
            # a DTensor's own local tensor: to_local() hands out a view
            self._track(t._local_tensor if isinstance(t, DTensor) else t)
        return self.live - before

    def new_bytes(self, tree, old=()) -> int:
        """Bytes of ``tree``'s distinct storages that ``old`` does not
        hold."""
        def storages(tree):
            for t in _tensors(tree):
                t = t._local_tensor if isinstance(t, DTensor) else t
                yield _storage_key(t), t.untyped_storage().nbytes()

        held = {k for k, _ in storages(old)}
        return sum(dict((k, n) for k, n in storages(tree)
                        if k not in held).values())

    def _release(self, key: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live -= self._sizes.pop(key)

    def _track(self, t: torch.Tensor) -> None:
        if type(t) is not FakeTensor:
            return
        key = _storage_key(t)
        if key not in self._refs:
            self._refs[key] = 0
            self._sizes[key] = t.untyped_storage().nbytes()
            self.live += self._sizes[key]
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is not torch.Tensor and t is not FakeTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = list(_tensors((args, kwargs)))
        outs = list(_tensors(out))
        if func.namespace in ("c10d", "_c10d_functional"):
            kind = collective_kind(func.__name__)
            if kind is not None:
                self.events.append((
                    kind, sum(_distinct_bytes(t) for t in ins),
                    sum(_distinct_bytes(t) for t in outs),
                    group_ranks(func, args)))
        elif func.namespace != "prim" and not func.is_view:
            name = func.__name__.split(".")[0]
            if name in _WRITE_ONLY:
                ins = []
            if name not in _NO_TRAFFIC:
                self.hbm_bytes += sum(_distinct_bytes(t) for t in ins + outs)
        if func.namespace == "repro_torch":
            self.kernel_calls[func.__name__.split(".")[0]] += 1
        for t in outs:
            self._track(t)
        return out


# ---------------------------------------------------------------------------
# the state on the mesh
# ---------------------------------------------------------------------------
def _local_shape(shape, sh) -> tuple:
    return tuple(d // c for d, c in zip(shape, sh.shard_counts))


def place(tree, shardings, dev):
    """Each leaf of ``tree`` (anything with a shape and dtype) as a
    DTensor of its sharding, this rank's shard a fake tensor."""
    leaves = [shd.from_local(torch.empty(_local_shape(leaf.shape, sh),
                                         dtype=leaf.dtype, device=dev),
                             sh, tuple(leaf.shape))
              for (_, leaf), (_, sh) in zip(flatten_with_path(tree),
                                            flatten_with_path(shardings))]
    return _unflatten(tree, iter(leaves))


def rows_of(x: DTensor) -> torch.Tensor:
    """A DTensor gathered along every mesh axis but those that shard its
    first (batch) dimension: this rank's rows, whole along the rest."""
    placements = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in x.placements]
    return x.redistribute(x.device_mesh, placements).to_local()


def _mesh_axes(mesh, kind_policy: str, batch: int) -> tuple:
    spec = shd.batch_shardings(mesh, {"tokens": torch.empty(
        (batch, 1), device="meta")}, kind_policy)["tokens"].spec[0]
    return () if spec is None else (spec if isinstance(spec, tuple)
                                    else (spec,))


def _cfg_for(arch: str, variant: str, layers: Optional[int],
             remat_policy: str, sequence_parallel: bool = False):
    cfg = get_config(arch, variant)
    change = {}
    if sequence_parallel:
        change["sequence_parallel"] = True
    if layers is not None:
        change["num_layers"] = layers
        if cfg.is_encdec:
            change["enc_layers"] = layers
    if remat_policy != "full":
        change["remat_policy"] = remat_policy
    # attention by "auto", which takes the kernel's op for fake tensors
    # (a smoke config names a plain version, as the JAX package's CPU
    # tests want)
    change["attention_impl"] = "auto"
    return dataclasses.replace(cfg, **change)


def at_length(caches, length: int):
    """The port's decode caches with every KV cache ``length`` long (the
    cell decodes the token after ``length`` cached ones)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.encdec import DecCache
    if isinstance(caches, DecCache):
        return caches._replace(self_kv=at_length(caches.self_kv, length))
    return [c._replace(length=length) if isinstance(c, KVCache) else c
            for c in caches]


def param_count(cfg) -> int:
    """The parameters of the JAX package's layout (padded vocabulary)."""
    return sum(math.prod(t.shape) for t in opt_mod.tree_leaves(
        ptrain.state_layout(cfg, OptimizerConfig())["params"]))


def run_cell(cfg, shape, mesh, dev: str, *, moments: str, microbatches: int,
             policy: str, cache_shard: str, grads_dtype: str):
    """One cell's step under the counters -> (counter, flops, arguments
    bytes, outputs bytes, the batch rows this rank runs)."""
    opt_cfg = OptimizerConfig(moments_dtype=moments)
    counter = StepCounter()
    flops = FlopCounterMode(display=False)
    fake = FakeTensorMode()
    with fake:
        layout = ptrain.state_layout(
            cfg, opt_cfg, lambda s, d: torch.empty(s, dtype=d, device=dev))
        model = build(cfg, device=dev)
        B = shape.global_batch
        axes = () if mesh is None else _mesh_axes(mesh, policy, B)
        rows = B // math.prod(pmesh.axis_size(mesh, a) for a in axes)

        def split(tree, take):
            return convert.split_layers(tree, cfg, take)

        def take_whole(leaf, index):
            if isinstance(leaf, opt_mod.QTensor):
                q = take_whole(leaf.q, index)
                return opt_mod.QTensor(q=q, scale=take_whole(leaf.scale,
                                                             index),
                                       shape=tuple(q.shape))
            return leaf[index] if index else leaf

        if shape.kind == "train":
            specs = input_specs(cfg, shape, lambda s, d: torch.empty(
                s, dtype=d, device=dev))
            if mesh is None:
                params = split(layout["params"], take_whole)
                opt = layout["opt"]
                state = opt_mod.AdamState(
                    step=opt.step, mu=split(opt.mu, take_whole),
                    nu=split(opt.nu, take_whole))
                step = make_train_step(model, opt_cfg, microbatches,
                                       grads_dtype)
                batch = specs
            else:
                sh = {"params": shd.param_shardings(mesh, layout["params"],
                                                    policy),
                      "opt": shd.opt_state_shardings(mesh, layout["opt"],
                                                     policy)}
                params = split(place(layout["params"], sh["params"], dev),
                               ptrain.take_layer)
                opt = place(layout["opt"], sh["opt"], dev)
                state = opt_mod.AdamState(
                    step=opt.step.to_local(),
                    mu=split(opt.mu, ptrain.take_layer),
                    nu=split(opt.nu, ptrain.take_layer))
                step = ptrain.make_mesh_train_step(
                    model, opt_cfg, mesh, axes, microbatches, grads_dtype,
                    policy)
                batch = {k: rows_of(v) for k, v in place(
                    specs, shd.batch_shardings(mesh, specs, policy),
                    dev).items()}
            del layout, opt
            args = (params, state, batch)
            arguments = counter.hold(args)
            with flops, counter:
                result = step(*args)
            outputs = counter.new_bytes(result, args)
            return counter, flops, arguments, outputs, rows

        # serving: f32 parameters for prefill, bf16 for decode
        if shape.kind == "decode":
            layout["params"] = opt_mod.tree_map(
                lambda t: torch.empty(t.shape, dtype=torch.bfloat16,
                                      device=dev), layout["params"])
        if mesh is None:
            params = split(layout["params"], take_whole)
        else:
            params = split(place(
                layout["params"], shd.param_shardings(
                    mesh, layout["params"], policy), dev), ptrain.take_layer)
        del layout
        if shape.kind == "prefill":
            specs = input_specs(cfg, shape, lambda s, d: torch.empty(
                s, dtype=d, device=dev))
            batch = specs if mesh is None else {
                k: rows_of(v) for k, v in place(
                    specs, shd.batch_shardings(mesh, specs, policy),
                    dev).items()}

            if mesh is None:
                @torch.no_grad()
                def step(params, batch):
                    return model.forward(params, **batch)[0]
            else:
                mm = ptrain.MeshModel(model, mesh, axes, policy)

                @torch.no_grad()
                def step(params, batch):
                    return mm.forward(params, **batch)[0]

            args = (params, batch)
        else:
            step, state, token = decode_state(cfg, model, params, shape, dev,
                                              mesh, axes, rows, policy,
                                              cache_shard)
            args = (params, state, token)
        arguments = counter.hold(args)
        with flops, counter:
            result = step(*args)
        outputs = counter.new_bytes(result, args)
        return counter, flops, arguments, outputs, rows


def decode_state(cfg, model, params, shape, dev, mesh, axes, rows, policy,
                 cache_shard):
    """A decode cell's step, caches (every KV cache seq_len - 1 long) and
    token: on a mesh ``launch/train.py:make_mesh_decode_step``, its state
    the rank's shards of ``decode_shardings`` (``MeshModel.init_decode``)
    and its token the rank's rows."""
    B, S = shape.global_batch, shape.seq_len
    frames = max(128, min(8192, S // 4))
    extra = {} if not cfg.is_encdec else {"memory": torch.empty(
        (rows, frames, cfg.d_model), dtype=torch.bfloat16, device=dev)}
    if mesh is None:
        step = torch.no_grad()(model.decode_step)
        caches = model.init_decode(params, B, S, **extra)
    else:
        step = ptrain.make_mesh_decode_step(model, mesh, axes, policy,
                                            cache_shard)
        with torch.no_grad():
            caches = step.model.init_decode(params, rows, S, **extra)
    del extra
    token = torch.empty((rows, 1), dtype=torch.int32, device=dev)
    return step, at_length(caches, S - 1), token


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------
def seq_shards(shape, cache_shard: str, tp: int, chips: int) -> int:
    """Into how many shards a decode cell's KV caches split their
    positions (``decode_shardings``): over ``model`` (``tp`` ranks), or
    every rank where the batch is 1; none under ``"heads"`` or where the
    guard keeps them whole."""
    if shape.kind != "decode" or cache_shard != "seq":
        return 1
    n = chips if shape.global_batch == 1 else tp
    return n if shape.seq_len % n == 0 else 1


def model_flops(cfg, arch_cfg, shape, nparams: int) -> int:
    """6·N·tokens to train, 2·N·tokens to prefill, 2·N·batch a decode
    step; an MoE's scaled by its active share (repro/launch/dryrun.py:
    305-311)."""
    if shape.kind == "train":
        flops = 6 * nparams * shape.tokens
    elif shape.kind == "prefill":
        flops = 2 * nparams * shape.tokens
    else:
        flops = 2 * nparams * shape.global_batch
    if cfg.is_moe:
        active = arch_cfg.param_count(active_only=True)
        dense_total = arch_cfg.param_count(active_only=False)
        flops = int(flops * active / max(1, dense_total))
    return flops


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               mesh_shape=None, moments: str = "int8", microbatches: int = 1,
               policy: str = "2d", cache_shard: str = "seq",
               grads_dtype: str = "float32", remat_policy: str = "full",
               variant: str = "full", layers: Optional[int] = None,
               batch: Optional[int] = None, seq: Optional[int] = None,
               sequence_parallel: bool = False) -> dict:
    """Run one (arch x shape x mesh) cell on fake tensors -> its record.
    ``mesh_shape`` (data, model) runs a local mesh, ``"none"`` no mesh,
    None the production mesh (``multi_pod``); ``layers``, ``batch`` and
    ``seq`` cut the config and the shape.  The process group is this
    call's own (the fake one, unless a group is already up)."""
    arch_cfg = get_config(arch)
    if shape_name not in arch_cfg.shape_names:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip",
                "reason": "long_500k inapplicable: pure full attention "
                          "(see DESIGN.md §Arch-applicability)"}
    cfg = _cfg_for(arch, variant, layers, remat_policy, sequence_parallel)
    shape = SHAPES[shape_name]
    if batch is not None or seq is not None:
        shape = dataclasses.replace(
            shape, global_batch=batch or shape.global_batch,
            seq_len=seq or shape.seq_len)
    dev = fake_device()
    if mesh_shape == "none":
        chips, axes, names = 1, (1,), ("data",)
    elif mesh_shape is not None:
        chips, axes, names = (mesh_shape[0] * mesh_shape[1], mesh_shape,
                              ("data", "model"))
    else:
        axes = (2, 16, 16) if multi_pod else (16, 16)
        names = ("pod", "data", "model") if multi_pod else ("data", "model")
        chips = math.prod(axes)
    own_group = not dist.is_initialized()
    if own_group:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=chips)
    t0 = time.time()
    try:
        mesh = (None if mesh_shape == "none"
                else pmesh._make_mesh(tuple(axes), names, dev))
        counter, flops, arguments, outputs, rows = run_cell(
            cfg, shape, mesh, dev, moments=moments,
            microbatches=microbatches, policy=policy,
            cache_shard=cache_shard, grads_dtype=grads_dtype)
    finally:
        if own_group:
            dist.destroy_process_group()
    peak = counter.peak
    capacity = hbm_capacity()
    coll = price_collectives(counter.events)
    flops_dev = float(flops.get_total_flops())
    nparams = param_count(cfg)
    # the model of one device's traffic: its rows; on a mesh rank 0's
    # compute slices and shards
    tp_size = (1 if mesh_shape == "none" or policy == "dp_only"
               or "model" not in names else axes[names.index("model")])
    layout = None if mesh_shape == "none" else costs.Mesh(
        tp=tp_size, dp_axes=tuple(n for a, n in zip(names, axes)
                                  if tp_size == 1 or a != "model"),
        seqpar=bool(cfg.sequence_parallel and not cfg.is_encdec
                    and shape.seq_len % tp_size == 0),
        shards=chips, seq_shards=seq_shards(shape, cache_shard, tp_size,
                                            chips))
    traffic = costs.traffic_bytes(
        cfg, dataclasses.replace(shape, global_batch=rows), nparams,
        padded_vocab(cfg), moments=moments, mesh=layout)
    terms = perfmodel.roofline_terms(flops_dev * chips,
                                     counter.hbm_bytes * chips,
                                     coll["seconds"], chips)
    mflops = model_flops(cfg, arch_cfg, shape, nparams)
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": dict(zip(names, axes)) if mesh_shape != "none" else None,
        "status": "ok", "chips": chips, "fake_device": dev,
        "variant": variant, "layers": cfg.num_layers,
        "batch": [shape.global_batch, shape.seq_len],
        "trace_s": round(time.time() - t0, 2),
        "bytes_per_device": {"arguments": arguments, "outputs": outputs,
                             "temps": peak - arguments,
                             "peak_estimate": peak},
        "hbm_bytes": capacity, "hbm_ok": bool(peak < capacity),
        "params": nparams,
        "flops_per_device": flops_dev,
        "hbm_bytes_per_device": float(counter.hbm_bytes),
        "collective_bytes_per_device": {k: v for k, v in coll.items()
                                        if k != "seconds"},
        "collective_s_per_device": coll["seconds"],
        "kernel_calls": dict(counter.kernel_calls),
        "roofline": {k: (v if isinstance(v, str) else float(v))
                     for k, v in terms.items()},
        "traffic_model_bytes_global": {k: float(v) * chips
                                       for k, v in traffic.items()},
        "counted_bytes_global": float(counter.hbm_bytes * chips),
        "rows_per_device": rows,
        "model_flops": mflops,
        "model_vs_hlo_flops": mflops / max(1.0, flops_dev * chips),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "local", "none"],
                    help="the production mesh (16x16, 2x16x16 or both), "
                         "a local (--mesh-data, --mesh-model) mesh, or "
                         "none (one device, no mesh)")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--moments", default="int8", choices=["int8", "fp32"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--policy", default="2d", choices=["2d", "dp_only"])
    ap.add_argument("--cache-shard", default="seq", choices=["seq", "heads"])
    ap.add_argument("--grads", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--seqpar", action="store_true",
                    help="sequence parallelism: the residual stream sharded "
                         "over the sequence on `model` (train and prefill)")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--variant", default="full", choices=["full", "smoke"])
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (enc-dec: both stacks)")
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch in place of the shape's")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence length in place of the shape's")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.mesh in ("local", "none"):
        meshes = [(False, "none" if args.mesh == "none"
                   else (args.mesh_data, args.mesh_model))]
    else:
        meshes = [(m, None) for m in MESHES[args.mesh]]
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for multi_pod, mesh_shape in meshes:
                opts = {"policy": args.policy,
                        "cache_shard": args.cache_shard,
                        "grads": args.grads, "moments": args.moments,
                        "microbatches": args.microbatches,
                        "remat_policy": args.remat_policy,
                        "seqpar": args.seqpar,
                        "step": ("one device" if mesh_shape == "none"
                                 else "tensor-parallel")}
                try:
                    rec = lower_cell(
                        arch, shape_name, multi_pod=multi_pod,
                        mesh_shape=mesh_shape, moments=args.moments,
                        microbatches=args.microbatches, policy=args.policy,
                        cache_shard=args.cache_shard, grads_dtype=args.grads,
                        remat_policy=args.remat_policy,
                        variant=args.variant, layers=args.layers,
                        batch=args.batch, seq=args.seq,
                        sequence_parallel=args.seqpar)
                    rec["options"] = opts
                except Exception as e:  # noqa: BLE001 — report, keep going
                    rec = {"arch": arch, "shape": shape_name,
                           "multi_pod": multi_pod, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    failures += 1
                line = json.dumps(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")
                print(json.dumps({k: v for k, v in rec.items()
                                  if k != "trace"}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
