"""Checkpointing over the chunk store: atomic, manifest-last, async.

The counterpart of ``repro/train/checkpoint.py``, in the same format, so a
checkpoint written by either package restores in the other:

* every leaf of the tree is a chunked array in the object store, named as
  the JAX package names it (``jax.tree_util.keystr`` of its path,
  sanitised: :func:`leaf_name`);
* writes are manifest-last: chunk objects first, then the step's
  manifest in one PUT, the commit point; :meth:`CheckpointManager.steps`
  sees only committed manifests;
* bf16 leaves are widened to f32 for storage (numpy has no bf16) and cast
  back to the template's dtype on restore;
* :meth:`CheckpointManager.save_async` copies the tree to the host on the
  caller's thread, then writes it on a background thread.

The tree is made of dicts, lists, tuples and NamedTuples of tensors or
numpy arrays.  A tree in the JAX package's layout (``{"params":
convert.params_to_numpy(...), "opt": AdamState(...)}``) gives the JAX
package's leaf names.  Chunks are zlib-compressed by default, as the JAX
package writes them; ``codec="raw"`` writes them as they are (a reader
takes either: the codec is in each array's manifest).

On a mesh (``launch/sharding.py``), ``save(..., shardings=)`` writes the
same leaves, whole, with each leaf's chunks cut at its shard boundaries
(and so no larger than a shard); ``restore(..., shardings=)`` reads each
leaf region-wise, each rank only its own shard, and returns DTensors.  A
checkpoint written at any mesh, or by either package, restores at any
other: a region that is not one chunk is assembled from the chunks that
cover it.  :attr:`CheckpointManager.read_stats` counts the bytes the last
restore read.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.perfmodel import MiB
from repro_torch.train.optimizer import QTensor


class _Attr(str):
    """A NamedTuple field in a path (``jax.tree_util.GetAttrKey``)."""


def _key_str(key) -> str:
    """One step of a path as ``jax.tree_util.keystr`` writes it: a dict key
    ``['k']``, a sequence index ``[i]``, a NamedTuple field ``.name``."""
    if isinstance(key, _Attr):
        return f".{key}"
    return f"[{key!r}]"


def leaf_name(path: Tuple) -> str:
    """The JAX package's ``_leaf_name``: the path's keystr with every run of
    characters other than letters, digits, ``_`` and ``.`` made ``_``."""
    name = "".join(_key_str(k) for k in path)
    return re.sub(r"[^A-Za-z0-9_.]+", "_", name).strip("_") or "leaf"


def flatten_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order: dict keys sorted, sequences in order, NamedTuple fields as
    ``.field`` (a QTensor as ``.qv`` and ``.qscale``, its shape being
    static, as the JAX package registers it)."""
    if isinstance(tree, QTensor):
        return [(path + (_Attr("qv"),), tree.q),
                (path + (_Attr("qscale"),), tree.scale)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [pl for f in tree._fields
                for pl in flatten_with_path(getattr(tree, f),
                                            path + (_Attr(f),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in flatten_with_path(v, path + (i,))]
    return [(path, tree)]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken from the iterator
    ``leaves`` in :func:`flatten_with_path`'s order."""
    if isinstance(template, QTensor):
        q = next(leaves)
        return QTensor(q=q, scale=next(leaves), shape=template.shape)
    if isinstance(template, dict):
        out = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_unflatten(getattr(template, f), leaves)
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            # numpy has no bf16: widen exactly to f32 for storage (restore
            # casts back to the template's dtype)
            t = t.float()
        # a copy, never a view of a CPU tensor the caller goes on updating
        return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()
    return np.asarray(leaf)


def _snapshot(tree):
    """The tree with every leaf copied to a host numpy array."""
    leaves = iter([_to_host(leaf) for _, leaf in flatten_with_path(tree)])
    return _unflatten(tree, leaves)


def _default_chunks(shape, itemsize: int, target_bytes: int = 8 * MiB):
    """Chunk along the leading axis toward ~target_bytes per chunk."""
    if not shape:
        return ()
    row_bytes = itemsize * int(np.prod(shape[1:])) if len(shape) > 1 else itemsize
    rows = max(1, min(shape[0], target_bytes // max(1, row_bytes)))
    return (int(rows),) + tuple(shape[1:])


def _shard_chunks(shape, itemsize: int, counts) -> Tuple[int, ...]:
    """:func:`_default_chunks`, each dimension split ``counts[d]`` ways
    cut to a divisor of its shard, so that every shard is whole chunks."""
    chunks = list(_default_chunks(shape, itemsize))
    for d, n in enumerate(counts):
        if n > 1:
            part = shape[d] // n
            c = min(chunks[d], part)
            while part % c:
                c -= 1
            chunks[d] = c
    return tuple(chunks)


def _covering_bytes(spec, start, stop) -> int:
    """Bytes of the chunks that cover the region [start, stop)."""
    total = np.dtype(spec.dtype).itemsize
    for s, e, dim, c in zip(start, stop, spec.shape, spec.chunks):
        total *= sum(min(c, dim - i * c) for i in range(s // c, -(-e // c)))
    return int(total)


def _torch_dtype(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return torch.from_numpy(np.zeros((), np.dtype(leaf.dtype))).dtype


class CheckpointManager:
    """Step-indexed checkpoints for a tree of tensors or arrays."""

    def __init__(self, chunkstore: ChunkStore, name: str = "ckpt",
                 keep: int = 3, codec: str = "zlib"):
        self.cs = chunkstore
        self.name = name
        self.keep = keep
        self.codec = codec
        self._async_lock = threading.Lock()
        self._pending: List[threading.Thread] = []
        self._errors: List[BaseException] = []
        #: what the last restore read: the bytes of the regions it asked
        #: for, of the chunks that cover them, and of the leaves whole
        self.read_stats: Dict[str, int] = {}

    # -- naming ----------------------------------------------------------------
    def _step_prefix(self, step: int) -> str:
        return f"{self.name}/step_{step:010d}"

    def _manifest_key(self, step: int) -> str:
        return f"{self.cs.root}/{self._step_prefix(step)}/MANIFEST.json"

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             shardings: Any = None) -> None:
        """Blocking save: chunk objects first, manifest last (atomic
        commit).  ``shardings`` (a tree of ``launch.sharding.Sharding``
        matching ``tree``) cuts each leaf's chunks at its shard
        boundaries; the leaves are written whole either way."""
        counts = ([sh.shard_counts for _, sh in flatten_with_path(shardings)]
                  if shardings is not None else None)
        entries = []
        for i, (path, leaf) in enumerate(flatten_with_path(tree)):
            arr = _to_host(leaf)
            if str(arr.dtype) == "bfloat16":
                arr = arr.astype(np.float32)
            lname = leaf_name(path)
            aname = f"{self._step_prefix(step)}/{lname}"
            scalar = arr.ndim == 0
            if scalar:
                arr = arr.reshape(1)
            chunks = (_shard_chunks(arr.shape, arr.itemsize, counts[i])
                      if counts is not None and not scalar
                      else _default_chunks(arr.shape, arr.itemsize))
            ca = self.cs.create(aname, arr.shape, arr.dtype, chunks,
                                codec=self.codec)
            ca.write_region((0,) * arr.ndim, arr)
            entries.append({"name": lname, "array": aname,
                            "shape": list(arr.shape), "dtype": str(arr.dtype),
                            "scalar": scalar})
        manifest = {"step": step, "time": time.time(),
                    "entries": entries, "extra": extra or {}}
        # manifest PUT is the commit point
        self.cs.fs.write(self._manifest_key(step),
                         json.dumps(manifest).encode())
        self._gc()

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None,
                   shardings: Any = None) -> threading.Thread:
        """Non-blocking save: the tree is copied to the host on the
        caller's thread (so the caller may go on updating its tensors),
        then written on a background thread.  :meth:`wait` joins it and
        raises what it raised."""
        snapshot = _snapshot(tree)

        def run():
            try:
                self.save(step, snapshot, extra, shardings)
            except BaseException as e:  # noqa: BLE001 — raised by wait()
                with self._async_lock:
                    self._errors.append(e)

        t = threading.Thread(target=run, daemon=True)
        with self._async_lock:
            self._pending.append(t)
        t.start()
        return t

    def wait(self):
        with self._async_lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()
        with self._async_lock:
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    # -- restore -----------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for key in self.cs.fs.store.list(f"{self.cs.root}/{self.name}/"):
            m = re.search(r"step_(\d+)/MANIFEST\.json$", key)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None) -> Any:
        """Restore into ``template``'s structure; its leaves give only each
        leaf's dtype and, for tensors, device (their values are ignored).
        A tensor leaf comes back a tensor, anything else a numpy array.

        With ``shardings`` (a tree of ``launch.sharding.Sharding`` matching
        ``template``), each leaf comes back a DTensor on its mesh's device
        with its placements, and this rank reads only its own shard of it
        (a region read of the chunks that cover the shard)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.name}")
        manifest = json.loads(
            self.cs.fs.read(self._manifest_key(step)).decode())
        by_name = {e["name"]: e for e in manifest["entries"]}

        def entry_of(path):
            lname = leaf_name(path)
            if lname not in by_name:
                raise KeyError(f"checkpoint step {step} missing leaf {lname}")
            return by_name[lname]

        def read(path, leaf):
            entry = entry_of(path)
            arr = self.cs.open(entry["array"]).read_all()
            if entry["scalar"]:
                arr = arr.reshape(())
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(arr).to(device=leaf.device,
                                               dtype=leaf.dtype)
            dtype = getattr(leaf, "dtype", None)
            return arr.astype(dtype, copy=False) if dtype is not None else arr

        stats = {"region_bytes": 0, "chunk_bytes": 0, "leaf_bytes": 0}
        self.read_stats = stats

        def read_shard(path, leaf, sh):
            from repro_torch.launch.sharding import from_local, shard_slices

            entry = entry_of(path)
            ca = self.cs.open(entry["array"])
            shape = () if entry["scalar"] else tuple(entry["shape"])
            region = shard_slices(sh, shape)
            start = tuple(r.start for r in region) or (0,)
            stop = tuple(r.stop for r in region) or (1,)
            arr = ca.read_region(start, stop).reshape(
                tuple(r.stop - r.start for r in region))
            stats["region_bytes"] += arr.nbytes
            stats["chunk_bytes"] += _covering_bytes(ca.spec, start, stop)
            stats["leaf_bytes"] += (math.prod(ca.spec.shape)
                                    * np.dtype(ca.spec.dtype).itemsize)
            dev = (torch.device("cuda", torch.cuda.current_device())
                   if sh.mesh.device_type == "cuda" else torch.device("cpu"))
            local = torch.from_numpy(arr).to(device=dev,
                                             dtype=_torch_dtype(leaf))
            return from_local(local, sh, shape)

        if shardings is not None:
            pairs = list(zip(flatten_with_path(template),
                             flatten_with_path(shardings)))
            leaves = (read_shard(path, leaf, sh)
                      for (path, leaf), (_, sh) in pairs)
        else:
            leaves = (read(path, leaf)
                      for path, leaf in flatten_with_path(template))
        return _unflatten(template, leaves)

    # -- retention ------------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            prefix = f"{self.cs.root}/{self._step_prefix(old)}"
            for key in self.cs.fs.store.list(prefix + "/"):
                self.cs.fs.delete(key)
