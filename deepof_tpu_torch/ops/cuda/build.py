"""Build the package's CUDA sources into shared libraries at first use.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into
`build/deepof_tpu_torch/lib<name>-<hash>.so` at the repository root and
loaded with ctypes. The hash covers the source, the headers of `csrc/`
that it includes (`#include "<name>.cuh"`) and the flags, so a stale
library is never loaded.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

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
#: the names of the libraries this process compiled ("built": True), in
#: order
_built_names: list[str] = []
#: the executable ledger's traces open in this process (obs/ledger.py):
#: while any is, a launch is also noted to the trace on its thread
_traces = [0]


def built_count() -> int:
    """Libraries this process has compiled so far (`build` calls that
    returned "built": True): the staged recipe reads it to show that a
    stage switch builds nothing."""
    with _built_lock:
        return len(_built_names)


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
        _built_names.append(name)
    return {"path": str(path), "built": True,
            "seconds": time.monotonic() - t0, "log": proc.stdout}


def build_all() -> dict[str, dict]:
    """Build every source at once, one nvcc process each; returns
    {name: build(name)}."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def install(name: str, src: str | os.PathLike) -> bool:
    """Copy a library built elsewhere (the artifact store's,
    `serve/artifacts.py`, which has checked that it was built from this
    checkout's source) into BUILD_DIR under `library_path(name)`'s name:
    a temporary sibling, then os.rename, under the build lock. A later
    `load` finds it built, and `built_names()` does not count it.
    Returns False when the library is there already (nothing copied)."""
    path = library_path(name)
    with _lock:
        if path.exists():
            return False
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.install")
        shutil.copyfile(src, tmp)
        os.rename(tmp, path)
    return True


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


@contextlib.contextmanager
def tracing():
    """Marks an executable-ledger trace open (`obs/ledger.py`): while one
    is, `LaunchCounter.add` notes each launch to the trace of its
    thread."""
    with _built_lock:
        _traces[0] += 1
    try:
        yield
    finally:
        with _built_lock:
            _traces[0] -= 1


def built_names() -> list[str]:
    """The libraries this process has compiled so far, in order."""
    with _built_lock:
        return list(_built_names)


class LaunchCounter:
    """Launches of one kernel of library `source` (`csrc/<source>.cu`): a
    wrapper adds one where it launches, with a callable that gives the
    launch's plan (its shapes and parameters), called only while a
    ledger trace is open. Every counter joins `COUNTERS` (read by
    `launch_counts`)."""

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = source
        self.count = 0
        self._lock = threading.Lock()
        COUNTERS.append(self)

    def add(self, plan: Callable[[], tuple] | None = None) -> None:
        with self._lock:
            self.count += 1
        if _traces[0]:
            _note_launch(self, () if plan is None else plan())

    def reset(self) -> None:
        with self._lock:
            self.count = 0


#: every LaunchCounter of the process, in creation order
COUNTERS: list[LaunchCounter] = []


def _note_launch(counter: LaunchCounter, plan: tuple) -> None:
    """Hand a launch to the ledger trace active on this thread, if any.
    The trace is a dispatch mode, so it is found on the mode stack,
    which autograd carries to its device threads: a kernel launched in
    a backward pass is noted too; another thread's launch is not."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for mode in _get_current_dispatch_mode_stack():
        note = getattr(mode, "note_launch", None)
        if note is not None:
            note(counter.name, counter.source, plan)


def launch_counts() -> dict[str, int]:
    """Each kernel's launches in this process so far, by counter name
    (the serve summary of a replica carries them)."""
    from . import corr, warp  # noqa: F401 - their counters register

    return {c.name: c.count for c in COUNTERS}


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.deepof_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
