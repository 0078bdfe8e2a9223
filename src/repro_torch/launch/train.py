"""End-to-end training CLI on one card (or the CPU), or on a mesh.

The counterpart of ``repro/launch/train.py``: chunk-store corpus ->
festivus-backed reads -> ``PrefetchLoader`` onto the device -> the train
step on autograd (the hand-written flash attention and SSD forward and
backward kernels on the card) -> chunk-store checkpoints, manifest last,
in the JAX package's layout (``{"params": ..., "opt": AdamState(...)}``,
so either package restores them) -> resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --variant smoke --steps 20 --batch 8 --seq 128 [--device cpu]
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \\
        --mesh-data 2 --store DIR ...

The JAX CLI's flags, plus ``--device`` (default: the card), ``--warmup``
(its warmup steps, 10 there), ``--ckpt-codec`` (``zlib`` as there, or
``raw``) and ``--mesh`` (the mesh path at 1 x 1).  Parameters are f32
masters.  An ssm or hybrid arch runs the SSD's forward and backward
kernels (``kernels.ssd_scan.SsdScanFn``) in each mamba layer; which
configurations have trained on the card is ``ROADMAP.md``'s record.
Fault tolerance is exercised with ``--preempt-at N``, as there, and with
``launch.elastic.ElasticTrainer`` over a :class:`Trainer`.

On a mesh (``--mesh-data`` x ``--mesh-model`` ranks, NCCL on the card,
gloo with ``--device cpu``; ``launch/mesh.py`` refuses a mesh that is not
the world size) storage follows the rule table (``launch/sharding.py``):
parameters and both moments are DTensors.  Compute is tensor-parallel
over ``model``, as GSPMD partitions the JAX package's jitted step: each
rank of a ``model`` group runs Megatron's attention, FFN and mamba layers
on its heads and channels, its experts of an MoE, its rows of the
vocabulary for the embedding and the logits, and (``cfg.
sequence_parallel``) its share of the sequence between the sublayers
(``models/common.py:TensorParallel``).  Each layer gathers its own
shards over the data-parallel axes inside its remat region, and its
backward reduce-scatters the layer's gradient straight back to the
storage placements (``sharding.gather_layer``, FSDP's pattern): a rank
holds its shards and one layer, never the whole model.  Each rank runs
its own rows of the batch over the data-parallel axes
(:func:`rank_rows`), and the optimizer updates the local shards.  A mesh
whose ``model`` axis is 1 runs the same code, over a group of one.  The
loss and the MoE aux loss are the global batch's (``train.train_step``);
the global norm and the int8 moments' row scales are reduced over the
mesh (``train.optimizer``).

Decode on the mesh is :class:`MeshModel`'s ``init_decode`` and
``decode_step`` (``make_mesh_decode_step``): bf16 weights in their
storage placements, each layer gathered and run tensor-parallel, the
caches the rank's shards of ``sharding.decode_shardings`` (split-K over
the sequence, or KV heads over ``model``: ``cache_shard``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from repro_torch import convert
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import Festivus, InMemoryObjectStore, LocalDirObjectStore
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.data import (PrefetchLoader, TokenDataset, TokenDatasetSpec,
                              write_corpus)
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch import sharding as shd
from repro_torch.launch.mesh import make_local_mesh, shutdown
from repro_torch.models import build, encdec
from repro_torch.models.attention import KVCache
from repro_torch.models.encdec import DecCache
from repro_torch.models.model_zoo import _padded_cfg
from repro_torch.train import CheckpointManager, OptimizerConfig, make_train_step
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_step import make_grads_fn


def make_store(path: Optional[str]):
    store = LocalDirObjectStore(path) if path else InMemoryObjectStore()
    fs = Festivus(store)
    if path:
        fs.sync_metadata()
    return ChunkStore(fs, "data")


def _map_layout(fn, layout):
    return {k: _map_layout(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in layout.items()}


def state_to_numpy(params, opt_state: opt_mod.AdamState,
                   cfg: ModelConfig) -> dict:
    """The train state in the JAX package's layout, as numpy arrays."""
    return {"params": convert.params_to_numpy(params, cfg),
            "opt": opt_mod.AdamState(
                step=opt_state.step.cpu().numpy(),
                mu=convert.params_to_numpy(opt_state.mu, cfg),
                nu=convert.params_to_numpy(opt_state.nu, cfg))}


def restore_state(ckpt: CheckpointManager, cfg: ModelConfig,
                  opt_cfg: OptimizerConfig, device, step=None):
    """The checkpointed train state in the JAX layout -> (params, opt
    state) on ``device``: f32 masters, moments as ``opt_cfg`` keeps
    them."""
    template = state_layout(cfg, opt_cfg,
                            lambda shape, dtype: torch.zeros(
                                (), dtype=dtype).numpy())
    restored = ckpt.restore(template, step=step)
    f32 = torch.float32
    params = convert.params_from_numpy(restored["params"], cfg, device, f32)
    opt = restored["opt"]
    state = opt_mod.AdamState(
        step=torch.as_tensor(opt.step, dtype=torch.int32, device=device),
        mu=convert.params_from_numpy(opt.mu, cfg, device, f32),
        nu=convert.params_from_numpy(opt.nu, cfg, device, f32))
    return params, state


def corpus_spec(args, cfg: ModelConfig) -> TokenDatasetSpec:
    """The synthetic corpus a run reads, sized as repro/launch/train.py sizes it."""
    return TokenDatasetSpec(num_shards=args.data_shards,
                            shard_tokens=max(4 * (args.seq + 1) * args.batch,
                                             16384),
                            vocab_size=min(cfg.vocab_size, 512))


def optimizer_config(args) -> OptimizerConfig:
    return OptimizerConfig(learning_rate=args.lr, warmup_steps=args.warmup,
                           decay_steps=max(args.steps, 20),
                           moments_dtype=args.moments)


def checkpoints(args, cs: ChunkStore) -> CheckpointManager:
    return CheckpointManager(cs, name=f"ckpt-{args.arch}", keep=2,
                             codec=args.ckpt_codec)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def state_layout(cfg: ModelConfig, opt_cfg: OptimizerConfig,
                 leaf=_meta) -> dict:
    """The train state in the JAX layout, each leaf ``leaf(shape,
    dtype)``: by default a ``meta`` tensor, the tree a sharded restore
    reads into and the checkpoint's shardings are resolved on.  Moments
    are int8 QTensors where ``opt_cfg`` quantizes their shape."""
    int8 = opt_cfg.moments_dtype == "int8"

    def moment(shape):
        if int8 and opt_mod.quantizable(shape):
            return opt_mod.QTensor(q=leaf(shape, torch.int8),
                                   scale=leaf(shape[:-1], torch.float32),
                                   shape=shape)
        return leaf(shape, torch.float32)

    layout = convert.jax_layout(cfg)
    return {"params": _map_layout(lambda s: leaf(s, torch.float32), layout),
            "opt": opt_mod.AdamState(step=leaf((), torch.int32),
                                     mu=_map_layout(moment, layout),
                                     nu=_map_layout(moment, layout))}


def state_shardings(mesh, state) -> dict:
    """``{"params": ..., "opt": ...}``'s shardings: the rule table's
    placements of the parameters and of the optimizer state."""
    return {"params": shd.param_shardings(mesh, state["params"]),
            "opt": shd.opt_state_shardings(mesh, state["opt"])}


def take_layer(x, index: tuple):
    """One layer's DTensor of a stacked DTensor (a QTensor's payload and
    row scales alike): the local tensor's slice, its placements moved down
    by the stacked axes (which the rank padding never shards)."""
    if isinstance(x, opt_mod.QTensor):
        q = take_layer(x.q, index)
        return opt_mod.QTensor(q=q, scale=take_layer(x.scale, index),
                               shape=tuple(q.shape))
    if not index:
        return x
    k = len(index)
    sh = shd.sharding_of(x)
    if any(entry is not None for entry in sh.spec[:k]):
        raise ValueError(f"stacked axes of {tuple(x.shape)} are sharded: "
                         f"{sh.spec}")
    placements = tuple(Shard(p.dim - k) if isinstance(p, Shard) else p
                       for p in sh.placements)
    return shd.from_local(x.to_local()[index],
                          dataclasses.replace(sh, placements=placements,
                                              spec=sh.spec[k:]),
                          tuple(x.shape)[k:])


def _moment_map(fn, tree, *rest):
    """``fn`` over a moment tree's tensors, a QTensor's payload and row
    scales each."""
    def one(m, *r):
        if isinstance(m, opt_mod.QTensor):
            return opt_mod.QTensor(q=fn(m.q, *(x.q for x in r)),
                                   scale=fn(m.scale, *(x.scale for x in r)),
                                   shape=m.shape)
        return fn(m, *r)
    return opt_mod.tree_map(one, tree, *rest)


def rows_axes(mesh, batch: int) -> tuple:
    """The mesh axes a batch of ``batch`` rows is split over: the dp
    axes, or none where ``batch`` does not divide over them (the
    divisibility guard of ``batch_shardings``; every rank then runs the
    whole batch)."""
    meta = torch.empty((batch, 1), device="meta")
    spec = shd.batch_shardings(mesh, {"tokens": meta})["tokens"].spec
    entry = spec[0]
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def rank_rows(batch: dict, mesh, axes: tuple, num_microbatches: int = 1):
    """This rank's rows of a global batch split over ``axes``: its share
    of each microbatch (the JAX package's consecutive split of the batch
    into ``num_microbatches``), in order, so that its own split into
    microbatches gives its share of each global one.  With one microbatch,
    ``batch_shardings``' shard."""
    if not axes:
        return batch
    names, coord = mesh.mesh_dim_names, mesh.get_coordinate()
    ranks, index = 1, 0
    for a in axes:
        i = names.index(a)
        index = index * mesh.size(i) + coord[i]
        ranks *= mesh.size(i)
    rows = len(next(iter(batch.values())))
    if rows % (ranks * num_microbatches):
        raise ValueError(f"batch {rows} does not split into "
                         f"{num_microbatches} microbatches over {ranks} "
                         f"ranks")
    part, micro = rows // (ranks * num_microbatches), rows // num_microbatches
    idx = np.concatenate([np.arange(i * micro + index * part,
                                    i * micro + (index + 1) * part)
                          for i in range(num_microbatches)])
    return {k: v[idx] for k, v in batch.items()}


def axes_sum(mesh, axes: tuple):
    """A tensor summed over the mesh axes ``axes`` (a detached copy); None
    where there are none."""
    if not axes:
        return None

    def batch_sum(t: torch.Tensor) -> torch.Tensor:
        t = t.detach().clone()
        for a in axes:
            dist.all_reduce(t, group=mesh.get_group(a))
        return t

    return batch_sum


class MeshModel:
    """A model on a mesh, tensor-parallel over ``model`` (``policy``
    "2d"; "dp_only" folds the model axis into the data-parallel ones):
    its context (``tp``), and :meth:`layers`, the tree the model takes from
    a rank's local shards, each layer's ``Shards`` with its plan (made on
    first use from the DTensors' placements, ``sharding.layer_plans``).

    Serving on the mesh has ``Model``'s decode signatures, so
    ``train.serve_step.greedy_generate`` runs on a ``MeshModel`` as it is:
    :meth:`init_decode` hands the decode state over as DTensors in their
    ``sharding.decode_shardings`` placements, and :meth:`decode_step` runs
    the model tensor-parallel on the rank's shards of them, writing the
    new position into the shard that holds it (in the DTensors' local
    tensors).  ``batch``, the prompt and the tokens are this rank's rows
    (:func:`rank_rows` over ``axes``)."""

    def __init__(self, model, mesh, axes: tuple = (), policy: str = "2d",
                 cache_shard: str = "seq"):
        self.model, self.axes = model, tuple(axes)
        self.mesh, self.policy = mesh, policy
        self.cache_shard = cache_shard
        self.tp = shd.tensor_parallel(mesh, policy)
        self.tp_axis = None if policy == "dp_only" else "model"
        self.plans = None
        names = mesh.mesh_dim_names
        self.row_ranks = 1
        for a in self.axes:
            self.row_ranks *= mesh.size(names.index(a))

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        """The device of the rank's shards."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def plan(self, params) -> None:
        """Plan the gathers of ``params`` (DTensors), once."""
        if self.plans is None:
            self.plans = shd.layer_plans(params, self.model.cfg, self.tp,
                                         self.axes, self.tp_axis)

    def layers(self, local) -> dict:
        return shd.model_layers(local, self.plans)

    def local(self, params):
        """The rank's storage shards of ``params``, plain tensors."""
        self.plan(params)
        return opt_mod.tree_map(lambda x: x.to_local().detach(), params)

    def forward(self, params, **inputs):
        """The model's forward on ``params`` (DTensors) -> (this rank's
        columns of the logits, aux)."""
        return self.model.forward(self.layers(self.local(params)),
                                  tp=self.tp, **inputs)

    def encode(self, params, frontend: torch.Tensor) -> torch.Tensor:
        """An enc-dec model's encoder memory of the rank's rows of
        ``frontend``, tensor-parallel (whole on every rank of the model
        axis)."""
        return encdec.encode(self.layers(self.local(params)),
                             _padded_cfg(self.model.cfg), frontend, self.tp)

    def init_decode(self, params, batch: int, max_len: int, memory=None,
                    cache_shard: Optional[str] = None):
        """The empty decode state of the rank's ``batch`` rows (an enc-dec
        model's cross K/V projected from ``memory``, its rows' encoder
        output) as DTensors placed by ``decode_shardings`` for the global
        batch (``cache_shard`` "seq": KV caches split by sequence; "heads":
        by KV head over ``model`` where they divide it; default the
        model's own): each rank allocates its shards only."""
        cache_shard = cache_shard or self.cache_shard
        rows = batch * self.row_ranks
        dev = self.device

        def place(name, shape, dtype, value):
            whole = (rows,) + tuple(shape[1:]) if shape else ()
            sh = shd.cache_sharding(self.mesh, name, whole, rows, self.policy,
                                    cache_shard)
            cut = shd.shard_slices(sh, whole)
            if value is None:
                local = torch.zeros(tuple(c.stop - c.start for c in cut),
                                    dtype=dtype, device=dev)
            else:
                if cut[0].stop - cut[0].start != value.shape[0]:
                    raise ValueError(f"{name}: {value.shape[0]} rows, the "
                                     f"cache's shard has {cut[0]}")
                local = value[(slice(None),) + cut[1:]].contiguous()
            return shd.from_local(local, sh, whole)

        extra = {} if memory is None else {"memory": memory}
        tree = (self.layers(self.local(params)) if self.model.cfg.is_encdec
                else params)
        return self.model.init_decode(tree, batch, max_len, tp=self.tp,
                                      place=place, **extra)

    def decode_step(self, params, state, token: torch.Tensor):
        """One decode step of the rank's rows: ``state`` as
        :meth:`init_decode` made it (DTensors), ``token`` [rows, 1] ->
        (the new state, logits [rows, 1, V] gathered whole)."""
        local = _map_cache(lambda t: t.to_local() if isinstance(t, DTensor)
                           else t, state)
        new, logits = self.model.decode_step(
            self.layers(self.local(params)), local, token, tp=self.tp,
            shards=_cache_shards(state))
        return _rewrap(new, state), logits


def _map_cache(fn, tree):
    """``fn`` over the leaves of a decode state (lists and NamedTuples)."""
    if isinstance(tree, list):
        return [_map_cache(fn, v) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_cache(fn, v) for v in tree))
    return fn(tree)


def _rewrap(new, old):
    """A decode step's new local state as DTensors: an old DTensor where
    the step wrote its local tensor in place, a new one in its placements
    where it made a new tensor; host ints (a KV cache's length) as
    returned."""
    if isinstance(old, list):
        return [_rewrap(n, o) for n, o in zip(new, old)]
    if isinstance(old, tuple) and hasattr(old, "_fields"):
        return type(old)(*(_rewrap(n, o) for n, o in zip(new, old)))
    if not isinstance(old, DTensor):
        return new
    if (new.untyped_storage()._cdata
            == old.to_local().untyped_storage()._cdata):
        return old
    return shd.from_local(new, shd.sharding_of(old), tuple(old.shape))


def _cache_shards(state) -> dict:
    """The geometry of a decode state's KV caches on this rank
    (``sharding.kv_shard``): ``"k"`` for the self-attention caches (every
    layer's alike), ``"cross_k"`` for an enc-dec model's cross K/V."""
    out = {}
    if isinstance(state, DecCache):
        first, cross = state.self_kv[0], state.cross_k[0]
        out["cross_k"] = shd.kv_shard(shd.sharding_of(cross),
                                      tuple(cross.shape))
    else:
        first = next((c for c in state if isinstance(c, KVCache)), None)
    if first is not None and isinstance(first.k, DTensor):
        out["k"] = shd.kv_shard(shd.sharding_of(first.k),
                                tuple(first.k.shape))
    return out


def make_mesh_train_step(model, opt_cfg: OptimizerConfig, mesh,
                         axes: tuple, num_microbatches: int = 1,
                         grads_dtype: str = "float32", policy: str = "2d"):
    """train_step(params, opt_state, batch) -> (params, state, metrics) on
    a mesh: ``params`` and the moments are DTensors in their storage
    placements, ``batch`` this rank's rows (:func:`rank_rows` over
    ``axes``).  The model runs tensor-parallel (:class:`MeshModel`), each
    layer gathering its shards and reducing its gradient back to them
    (``sharding.gather_layer``); the optimizer updates the local shards
    (its global norm and int8 row scales reduced over the mesh).
    ``train_step.grads(params, batch)`` gives the local gradient shards and
    the metrics without the update."""
    mm = MeshModel(model, mesh, axes, policy)
    grads_fn = make_grads_fn(model, num_microbatches, grads_dtype,
                             axes_sum(mesh, axes), mm.tp, mm.layers)
    shapes = convert.reference_shapes(model.cfg)

    def grads(params, batch):
        return grads_fn(mm.local(params), batch)

    def train_step(params, opt_state, batch):
        g, metrics = grads(params, batch)
        local = opt_mod.AdamState(
            step=opt_state.step,
            mu=_moment_map(lambda m: m.to_local(), opt_state.mu),
            nu=_moment_map(lambda m: m.to_local(), opt_state.nu))
        _, new, opt_metrics = opt_mod.update(
            g, local, opt_mod.tree_map(lambda x: x.to_local(), params),
            opt_cfg, shapes, opt_mod.tree_map(shd.sharding_of, params))

        def rewrap(new_local, old):  # f32 moments were updated in place
            if (new_local.untyped_storage()._cdata
                    == old.to_local().untyped_storage()._cdata):
                return old
            return shd.from_local(new_local, shd.sharding_of(old),
                                  tuple(old.shape))

        state = opt_mod.AdamState(
            step=new.step, mu=_moment_map(rewrap, new.mu, opt_state.mu),
            nu=_moment_map(rewrap, new.nu, opt_state.nu))
        return params, state, {**metrics, **opt_metrics}

    train_step.grads = grads
    return train_step


def make_mesh_decode_step(model, mesh, axes: tuple, policy: str = "2d",
                          cache_shard: str = "seq"):
    """decode_step(params, state, token) -> (state, logits) on a mesh, under
    ``no_grad``: ``params`` DTensors in their storage placements (bf16 to
    serve), ``state`` from ``decode_step.model.init_decode`` (the
    :class:`MeshModel`), ``token`` this rank's rows (:func:`rank_rows` over
    ``axes``).  Each layer gathers its shards over the data-parallel axes
    and runs tensor-parallel over ``model``; attention is split-K over
    caches sharded by sequence, or local to the rank's KV heads
    (``cache_shard="heads"``)."""
    mm = MeshModel(model, mesh, axes, policy, cache_shard)

    @torch.no_grad()
    def decode_step(params, state, token):
        return mm.decode_step(params, state, token)

    decode_step.model = mm
    return decode_step


class Trainer:
    """One training run: its model, corpus, checkpoints and train state,
    on one device or on a mesh (``--mesh``, or ``--mesh-data`` or
    ``--mesh-model`` above 1).  :meth:`resume`, :meth:`run_step` and
    :meth:`save` are what ``launch.elastic.ElasticTrainer`` injects as its
    restore, step and save functions.

    On a mesh every rank runs this; parameters and both moments live as
    DTensors with the rule table's placements, each rank runs its rows of
    every batch, rank 0 writes the checkpoints (the leaves gathered whole,
    chunked at the shard boundaries) and every rank restores its own
    shards region-wise.  A mesh of more than one rank needs ``--store``, a
    directory every rank reads."""

    def __init__(self, args, cfg: Optional[ModelConfig] = None,
                 cs: Optional[ChunkStore] = None):
        self.args = args
        self.mesh = None
        if args.mesh or args.mesh_data > 1 or args.mesh_model > 1:
            self.mesh = make_local_mesh(args.mesh_data, args.mesh_model,
                                        device=args.device)
            self.dev = (torch.device("cuda", torch.cuda.current_device())
                        if self.mesh.device_type == "cuda"
                        else torch.device("cpu"))
            if dist.get_world_size() > 1 and cs is None and not args.store:
                raise ValueError("a mesh of more than one rank needs "
                                 "--store, a directory every rank reads")
        else:
            self.dev = resolve_device(args.device)
        self.rank = dist.get_rank() if self.mesh is not None else 0
        self.axes, self.ckpt_shardings = (), None
        self.cfg = cfg or get_config(args.arch, args.variant)
        self.model = build(self.cfg, device=self.dev)
        self.cs = cs if cs is not None else make_store(args.store)
        self.spec = corpus_spec(args, self.cfg)
        if self.rank == 0 and not self.cs.exists(self.spec.name):
            write_corpus(self.cs, self.spec)
        self._barrier()
        self.ckpt = checkpoints(args, self.cs)
        self.opt_cfg = optimizer_config(args)
        if self.mesh is None:
            self.step_fn = make_train_step(
                self.model, self.opt_cfg, num_microbatches=args.microbatches)
        else:
            self.axes = rows_axes(self.mesh, args.batch)
            self.ckpt_shardings = state_shardings(
                self.mesh, state_layout(self.cfg, self.opt_cfg))
            self.step_fn = make_mesh_train_step(
                self.model, self.opt_cfg, self.mesh, self.axes,
                num_microbatches=args.microbatches)
        self.params = self.opt_state = None
        #: the step the state in memory is at (None: no state yet)
        self.at_step: Optional[int] = None
        self._loader, self._next = None, None

    def _barrier(self) -> None:
        """On a mesh of several ranks: wait for every rank, then see what
        the others wrote to the store."""
        if self.mesh is not None and dist.get_world_size() > 1:
            dist.barrier()
            self.cs.fs.sync_metadata()

    def fresh(self) -> int:
        """The initial state (from ``--seed``); returns step 0."""
        params = self.model.init(self.args.seed, param_dtype=torch.float32)
        state = opt_mod.init(params, self.opt_cfg,
                             convert.reference_shapes(self.cfg))
        if self.mesh is not None:
            sh = state_shardings(self.mesh, {"params": params, "opt": state})
            params = opt_mod.tree_map(shd.distribute, params, sh["params"])
            state = opt_mod.AdamState(
                step=state.step,
                mu=_moment_map(shd.distribute, state.mu, sh["opt"].mu),
                nu=_moment_map(shd.distribute, state.nu, sh["opt"].nu))
        self.params, self.opt_state = params, state
        self.at_step = 0
        return 0

    def restore(self, step=None) -> None:
        """The checkpointed state at ``step`` (default the latest); on a
        mesh, each rank's own shards."""
        self.wait()
        self.at_step = step if step is not None else self.ckpt.latest_step()
        if self.mesh is None:
            self.params, self.opt_state = restore_state(
                self.ckpt, self.cfg, self.opt_cfg, self.dev, step=step)
            return
        restored = self.ckpt.restore(state_layout(self.cfg, self.opt_cfg),
                                     step=step,
                                     shardings=self.ckpt_shardings)
        opt = restored["opt"]

        def split(tree):
            return convert.split_layers(tree, self.cfg, take_layer)

        self.params = split(restored["params"])
        self.opt_state = opt_mod.AdamState(step=opt.step.to_local(),
                                           mu=split(opt.mu),
                                           nu=split(opt.nu))

    def resume(self) -> int:
        """Restore the latest checkpoint, or start afresh where there is
        none; returns the step to run next.  A state in memory at the
        latest checkpoint's step (this trainer saved it and took no step
        since) is kept as it is, being the same bits."""
        self.wait()
        step = self.ckpt.latest_step()
        if step is None:
            return self.fresh()
        if step != self.at_step:
            self.restore(step)
        return int(step)

    def _batches(self, start_step: int) -> PrefetchLoader:
        """The loader from ``start_step``.  Its thread holds the batch
        generators, so they hold nothing of the trainer: a trainer that is
        dropped (a pre-empted one) frees its state."""
        data = TokenDataset(self.cs, self.spec, rank=0, num_ranks=1)
        rows = ({"tokens": b["tokens"], "labels": b["labels"]}
                for b in data.batches(self.args.batch, self.args.seq,
                                      start_step=start_step))
        if self.mesh is not None:
            mesh, axes, micro = self.mesh, self.axes, self.args.microbatches
            rows = (rank_rows(b, mesh, axes, micro) for b in rows)
        return PrefetchLoader(rows, depth=2, device=self.dev)

    def run_step(self, step: int) -> dict:
        """One train step on step ``step``'s batch; returns its metrics."""
        if self._loader is None or self._next != step:
            self._loader = self._batches(step)
        batch = next(self._loader)
        self._next = step + 1
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        self.at_step = step + 1
        return metrics

    def save(self, step: int) -> None:
        """Checkpoint the state as step ``step`` (asynchronously; on a mesh
        every rank gathers, rank 0 writes)."""
        self.ckpt.wait()
        if self.mesh is None:
            self.ckpt.save_async(step, state_to_numpy(
                self.params, self.opt_state, self.cfg))
            return
        state = self.opt_state
        tree = state_to_numpy(
            opt_mod.tree_map(shd.gather, self.params),
            opt_mod.AdamState(step=state.step,
                              mu=_moment_map(shd.gather, state.mu),
                              nu=_moment_map(shd.gather, state.nu)),
            self.cfg)
        if self.rank == 0:
            self.ckpt.save_async(step, tree, shardings=self.ckpt_shardings)

    def wait(self) -> None:
        """Until every save so far is committed (on every rank)."""
        self.ckpt.wait()
        self._barrier()


def run(args, cfg: Optional[ModelConfig] = None,
        cs: Optional[ChunkStore] = None) -> dict:
    """One training run; ``cfg`` stands in for ``--arch``/``--variant``'s
    config and ``cs`` for ``--store``'s chunk store where given (a caller
    that resumes in the same process passes the same store).  Returns the
    logged history, the final step, the checkpoints kept and the final
    ``params`` and ``opt_state`` (DTensors on a mesh)."""
    tr = Trainer(args, cfg, cs)
    if args.resume and tr.ckpt.latest_step() is not None:
        start_step = tr.resume()
        print(f"[train] resumed from step {start_step}")
    else:
        start_step = tr.fresh()

    history = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        metrics = tr.run_step(step)
        if args.preempt_at and step == args.preempt_at:
            print(f"[train] simulating pre-emption at step {step}")
            # flush in-flight async saves so tests are deterministic; a
            # real pre-emption may lose them — either way the
            # manifest-last protocol only exposes complete checkpoints
            tr.wait()
            return {"preempted_at": step,
                    "resume_from": tr.ckpt.latest_step(),
                    "params": tr.params, "opt_state": tr.opt_state}
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            tr.save(step + 1)
        if (step + 1) % args.log_every == 0 or step == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step + 1
            m["tok_per_s"] = round(
                args.batch * args.seq * (step + 1 - start_step)
                / max(1e-9, time.time() - t0), 1)
            history.append(m)
            if tr.rank == 0:
                print("[train]", json.dumps(
                    {k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in m.items()}))
    tr.wait()
    return {"history": history, "final_step": args.steps,
            "checkpoints": tr.ckpt.steps(), "params": tr.params,
            "opt_state": tr.opt_state}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--variant", default="smoke",
                    help="smoke (CPU-sized) or full")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--moments", default="fp32", choices=["fp32", "int8"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--mesh", action="store_true",
                    help="train on the (mesh-data, mesh-model) mesh even "
                         "at 1 x 1 (implied by either above 1)")
    ap.add_argument("--data-shards", type=int, default=8)
    ap.add_argument("--store", default=None,
                    help="local dir for the object store (default in-memory)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--ckpt-codec", default="zlib", choices=["zlib", "raw"])
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--preempt-at", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    try:
        out = run(args)
        if not dist.is_initialized() or dist.get_rank() == 0:
            print("[train] done:", json.dumps(
                {k: v for k, v in out.items()
                 if k not in ("history", "params", "opt_state")}))
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
