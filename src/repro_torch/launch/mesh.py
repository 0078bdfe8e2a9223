"""Device meshes on ``torch.distributed.device_mesh``.

The counterpart of ``repro/launch/mesh.py``, with the same functions, axis
names (``pod``, ``data``, ``model``) and shapes (16 x 16, 2 x 16 x 16).  A
mesh is a :class:`~torch.distributed.device_mesh.DeviceMesh` over every
rank of the default process group: ``cuda`` devices on NCCL unless the
caller asks for the CPU, which runs on gloo.

One difference by design: a mesh that is not there is refused.  The JAX
``make_local_mesh`` quietly shrinks to ``(n, 1)`` when ``data * model``
exceeds the devices it finds; here every mesh function raises
``ValueError`` unless its size is the world size, and a ``cuda`` mesh
raises unless the process group runs NCCL (no fallback to gloo or the
CPU) or is torch's fake group (``launch/dryrun.py``'s, where nothing
runs).  A ``cpu`` mesh takes the group it finds (gloo, or the fake group
that builds a production-sized mesh in one process for the tests and the
dry run).

The process group is initialised on first use (:func:`init_distributed`):
from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), from an explicit ``init_method`` (a ``file://`` store)
with its rank and world size, or, with neither, as one rank on its own.
Every collective waits at most :data:`TIMEOUT`.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: how long the rendezvous and each collective wait before they raise
TIMEOUT = datetime.timedelta(seconds=300)

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def device_type(device=None) -> str:
    """``"cuda"`` unless ``device`` names the CPU."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind not in BACKENDS:
        raise ValueError(f"unsupported mesh device {device!r}; use 'cuda' "
                         f"or 'cpu'")
    return kind


def init_distributed(device=None, *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> None:
    """Initialise the default process group for ``device``'s backend, if
    it is not yet: ``init_method`` with ``rank`` and ``world_size`` where
    given, else ``torchrun``'s environment, else one rank alone.  A
    ``cuda`` group also sets this process's card (``LOCAL_RANK``, default
    0)."""
    kind = device_type(device)
    if dist.is_initialized():
        return
    backend = BACKENDS[kind]
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                               "device='cpu' for a gloo mesh")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size,
                                timeout=timeout)
    elif "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def shutdown() -> None:
    """Destroy the default process group (and every mesh's groups)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
               device=None) -> DeviceMesh:
    kind = device_type(device)
    init_distributed(kind)
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(
            f"mesh {dict(zip(axes, shape))} has {size} devices but the "
            f"world has {world} ranks: the port refuses a mesh that is not "
            f"there (the JAX package would shrink it to ({world}, 1))")
    backend = dist.get_backend()
    if kind == "cuda" and backend not in (BACKENDS[kind], "fake"):
        raise RuntimeError(f"a {kind} mesh needs the {BACKENDS[kind]} "
                           f"backend; the process group runs {backend}")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """16x16 single pod (256 devices) or 2x16x16 (2 pods, 512 devices).

    Axes: ``data`` carries data parallelism + FSDP weight sharding;
    ``model`` carries tensor/expert/sequence parallelism; ``pod``
    (multi-pod only) is pure data parallelism, so only gradient reductions
    cross the pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_local_mesh(data: int = 1, model: int = 1,
                    device=None) -> DeviceMesh:
    """A (data, model) mesh over every rank; raises unless ``data *
    model`` is the world size."""
    return _make_mesh((data, model), ("data", "model"), device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def dp_axes(mesh: DeviceMesh) -> tuple:
    """The data-parallel axes of a mesh (pod folds into DP)."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def dp_size(mesh: DeviceMesh) -> int:
    size = 1
    for a in dp_axes(mesh):
        size *= axis_size(mesh, a)
    return size
