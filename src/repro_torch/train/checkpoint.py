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
takes either: the codec is in each array's manifest).  ``shardings`` is
accepted only as None: meshes are ``ROADMAP.md`` queue 1 item 8.
"""

from __future__ import annotations

import json
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

    # -- naming ----------------------------------------------------------------
    def _step_prefix(self, step: int) -> str:
        return f"{self.name}/step_{step:010d}"

    def _manifest_key(self, step: int) -> str:
        return f"{self.cs.root}/{self._step_prefix(step)}/MANIFEST.json"

    # -- save --------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Blocking save: chunk objects first, manifest last (atomic
        commit)."""
        entries = []
        for path, leaf in flatten_with_path(tree):
            arr = _to_host(leaf)
            if str(arr.dtype) == "bfloat16":
                arr = arr.astype(np.float32)
            lname = leaf_name(path)
            aname = f"{self._step_prefix(step)}/{lname}"
            scalar = arr.ndim == 0
            if scalar:
                arr = arr.reshape(1)
            ca = self.cs.create(aname, arr.shape, arr.dtype,
                                _default_chunks(arr.shape, arr.itemsize),
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

    def save_async(self, step: int, tree: Any,
                   extra: Optional[Dict] = None) -> threading.Thread:
        """Non-blocking save: the tree is copied to the host on the
        caller's thread (so the caller may go on updating its tensors),
        then written on a background thread.  :meth:`wait` joins it and
        raises what it raised."""
        snapshot = _snapshot(tree)

        def run():
            try:
                self.save(step, snapshot, extra)
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
        A tensor leaf comes back a tensor, anything else a numpy array."""
        if shardings is not None:
            raise NotImplementedError(
                "restore(shardings=...): the port runs on one card; meshes "
                "and shardings are ROADMAP.md queue 1 item 8")
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.name}")
        manifest = json.loads(
            self.cs.fs.read(self._manifest_key(step)).decode())
        by_name = {e["name"]: e for e in manifest["entries"]}

        def read(path, leaf):
            lname = leaf_name(path)
            if lname not in by_name:
                raise KeyError(f"checkpoint step {step} missing leaf {lname}")
            entry = by_name[lname]
            arr = self.cs.open(entry["array"]).read_all()
            if entry["scalar"]:
                arr = arr.reshape(())
            if isinstance(leaf, torch.Tensor):
                return torch.as_tensor(arr).to(device=leaf.device,
                                               dtype=leaf.dtype)
            dtype = getattr(leaf, "dtype", None)
            return arr.astype(dtype, copy=False) if dtype is not None else arr

        leaves = (read(path, leaf) for path, leaf in flatten_with_path(template))
        return _unflatten(template, leaves)

    # -- retention ------------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for old in steps[: max(0, len(steps) - self.keep)]:
            prefix = f"{self.cs.root}/{self._step_prefix(old)}"
            for key in self.cs.fs.store.list(prefix + "/"):
                self.cs.fs.delete(key)
