"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
`build/deepof_tpu_torch/lib<name>-<hash>.so` at the repository root and
loaded with ctypes. The hash covers the source, the headers of `csrc/`
that it includes (`#include "<name>.cuh"`) and the flags, so a stale
library is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "deepof_tpu_torch"
SOURCES = ("corr", "corr_bwd", "warp")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_built_lock = threading.Lock()
#: `build` calls of this process that compiled a library ("built": True)
_built = [0]


def built_count() -> int:
    """Libraries this process has compiled so far (`build` calls that
    returned "built": True): the staged recipe reads it to show that a
    stage switch builds nothing."""
    return _built[0]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (no CUDA toolkit on this host); "
                           "the CUDA kernels cannot be built here")
    return found


def library_path(name: str) -> Path:
    source = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(source)
    for header in sorted(set(re.findall(rb'#include "(\w+\.cuh)"',
                                        source))):
        h.update((CSRC / header.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile `csrc/<name>.cu` unless its library is up to date. Returns
    {"path", "built", "seconds", "log"}; raises with the compiler's
    output if the build fails."""
    path = library_path(name)
    log = path.with_suffix(".log")
    if path.exists():
        return {"path": str(path), "built": False, "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.monotonic()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {proc.returncode}):"
                           f"\n{proc.stdout}")
    log.write_text(proc.stdout)
    os.replace(tmp, path)
    with _built_lock:
        _built[0] += 1
    return {"path": str(path), "built": True,
            "seconds": time.monotonic() - t0, "log": proc.stdout}


def build_all() -> dict[str, dict]:
    """Build every source at once, one nvcc process each; returns
    {name: build(name)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            lib.deepof_cuda_error_string.argtypes = [ctypes.c_int]
            lib.deepof_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class LaunchCounter:
    """Launches of one kernel: a wrapper adds one where it launches.
    Every counter joins `COUNTERS` (read by `launch_counts`)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()
        COUNTERS.append(self)

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


#: every LaunchCounter of the process, in creation order
COUNTERS: list[LaunchCounter] = []


def launch_counts() -> dict[str, int]:
    """Each kernel's launches in this process so far, by counter name
    (the serve summary of a replica carries them)."""
    from . import corr, warp  # noqa: F401 - their counters register

    return {c.name: c.count for c in COUNTERS}


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.deepof_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
