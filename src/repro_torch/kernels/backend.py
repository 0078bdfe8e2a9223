"""Device resolution and launch counting for the hand-written kernels.

The JAX package picks compiled-or-interpreted Pallas per backend; the port
has one target, an H100 (compute capability 9.0, built for ``sm_90a``).
:func:`resolve_device` is the one place that decision lives: the default is
the card, ``"cpu"`` must be asked for by name (the tests do), and a missing
or different card raises.  There is no silent CPU fallback.

Every kernel wrapper owns a :class:`LaunchCounter` that it bumps where it
launches, so a run can show that its main path went through the kernels.

A kernel without a backward refuses to run where autograd records
(:func:`refuse_autograd`): its output would carry no gradient, and a
``backward()`` through it would silently leave its inputs' part out.
"""

from __future__ import annotations

import threading
from typing import Dict, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

REQUIRED_CAPABILITY = (9, 0)

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` or a CUDA device -> that CUDA device, checked to be an
    sm_90 card; ``"cpu"`` -> the CPU.  Raises ``RuntimeError`` when CUDA is
    absent or the card is not Hopper."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions")
    cap = torch.cuda.get_device_capability(dev)
    if cap != REQUIRED_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability {cap}; "
            f"the kernels are built for sm_90a {REQUIRED_CAPABILITY}")
    return dev


def is_fake(t) -> bool:
    """True for a ``FakeTensor`` (``launch/dryrun.py``'s): it has shapes,
    dtypes and strides but no memory, so a kernel's custom op takes its
    registered fake implementation and nothing is launched.  The wrappers'
    checks skip what only memory has (the device, the base pointers) for
    such a tensor."""
    return isinstance(t, FakeTensor)


def refuse_autograd(kernel: str, tensors, reason: str) -> None:
    """Raise ``RuntimeError`` where grad mode is on and any of ``tensors``
    requires grad: ``kernel`` has no backward (``reason`` says where that
    stands).  The plain versions, which CPU tensors take, are
    differentiable."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {kernel} kernel has no backward: its output would carry no "
            f"gradient ({reason}); run it under torch.no_grad() or detach its "
            f"inputs")


class LaunchCounter:
    """A plain integer behind a lock: the cluster's workers are threads."""

    _registry: Dict[str, "LaunchCounter"] = {}

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._count = 0
        LaunchCounter._registry[name] = self

    def add(self) -> None:
        with self._lock:
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def reset(self) -> None:
        with self._lock:
            self._count = 0


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since its last reset."""
    return {n: c.count for n, c in LaunchCounter._registry.items()}


def reset_launch_counts() -> None:
    """Set every kernel's count to 0."""
    for c in LaunchCounter._registry.values():
        c.reset()
