"""Build and load the port's CUDA kernels (route: `nvcc` into a shared
library with a plain C interface, loaded with `ctypes`).

Each `csrc/<name>.cu` builds at first use into `build/kernels/` under the
repository root, named by a hash of its source and flags, so an edited
source rebuilds and an unchanged one loads at once. `build_all` starts one
`nvcc` per source together and waits for all of them. Nothing here runs
at import time: the CPU tests import every module on a machine without
`nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# src/repro_torch/kernels/build.py -> repository root
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("gather_agg",)

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be "
            "built on this machine")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{h}.so"


def _start(name: str):
    """Popen of the nvcc build for `name`, or None if already built. The
    output goes to a per-process temporary name and is renamed into place,
    so concurrent builders never load a half-written library."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Build every named source, one nvcc each, all started together."""
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        try:
            _finish(n, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return lib
