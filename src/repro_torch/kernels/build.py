"""Compile the CUDA sources under ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and becomes its own
shared library, ``build/repro_torch/lib<name>-<hash>.so`` at the root of
the checkout, loaded with :mod:`ctypes`.  The hash covers the source, the
headers beside it and the flags, so an edited source is rebuilt and a stale
library is never loaded.  Sources that need building are compiled all at
once, one ``nvcc`` each.  A lock makes concurrent worker threads build a
library once; the finished file is moved into place atomically, so two
processes never load a half-written one.

No PyTorch headers are included, which keeps a build to seconds (compiling
against PyTorch's headers takes minutes per file).  ``--use_fast_math`` is not
passed: the kernels' division and rounding are IEEE, as in the plain
versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
#: ``<checkout>/build/repro_torch`` (src/repro_torch/kernels/build.py -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
#: seconds a single nvcc may take before the build is abandoned
NVCC_TIMEOUT_S = 600

_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}


def source_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the
    toolkit's conventional install location."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def nvcc_command(src: Path, out: Path, nvcc: str = "nvcc") -> List[str]:
    return [nvcc, *NVCC_FLAGS, "--resource-usage", "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) whose library is missing,
    one ``nvcc`` per source, started together.  Returns, for each source
    compiled now, its wall seconds and the compiler's resource report.
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    with _lock:
        todo = [n for n in (names or source_names())
                if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        jobs = {}
        try:
            for n in todo:
                final = library_path(n)
                tmp = final.with_name(f".{final.stem}.{os.getpid()}.so")
                proc = subprocess.Popen(
                    nvcc_command(CSRC / f"{n}.cu", tmp, nvcc),
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                jobs[n] = (proc, tmp, final)
            done, errors = {}, []
            for n, (proc, tmp, final) in jobs.items():
                log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
                if proc.returncode:
                    errors.append(f"{n}.cu: nvcc exit {proc.returncode}\n{log}")
                    continue
                os.replace(tmp, final)
                done[n] = {"seconds": time.perf_counter() - t0, "log": log}
        finally:
            for proc, tmp, _ in jobs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                tmp.unlink(missing_ok=True)
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
        return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib
