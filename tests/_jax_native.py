"""Wait for the JAX package's native IO library before a test holds the
port against it.

`deepof_tpu/native` builds `libdeepof_io.so` with g++ on first use,
straight into its final path, whenever the file is missing or older
than its source; a process whose `ctypes.CDLL` fails on the file keeps
`_failed` for its life, and its datasets then decode with cv2. In a
fresh tree under xdist several workers need the library at once: one
that loads while another's linker is still writing the file gets a
half-written library and falls back to cv2 for the rest of the run
(cv2 rounds its resize, so a streaming draw is then up to 0.78 grey
levels off). `jax_native_loaded` waits until the file has stopped
changing, clears that failure and loads it again. The JAX package
itself is left as it is.
"""

import os
import time

from deepof_tpu import native as jax_native


def _settled(path: str, settle_s: float, deadline: float) -> None:
    """Return once `path` keeps its size and mtime, or stays missing,
    for `settle_s` (a missing file: the next load builds it)."""
    last = ()
    while time.monotonic() < deadline:
        try:
            st = os.stat(path)
            now = (st.st_size, st.st_mtime_ns)
        except FileNotFoundError:
            now = None
        if now == last:
            return
        last = now
        time.sleep(settle_s)


def jax_native_loaded(timeout_s: float = 300.0, settle_s: float = 1.0,
                      tries: int = 5) -> bool:
    """True once this process has the JAX native library loaded: after
    a failed load (another worker's build in flight), wait for the file
    to settle, reset the module's failure and load again, at most
    `tries` times and until `timeout_s`. A load that finds no file
    builds it, so a host where the build fails (no g++) runs it `tries`
    times and the caller's assertion on `available()` names it."""
    deadline = time.monotonic() + timeout_s
    for _ in range(tries):
        if jax_native.available() or time.monotonic() >= deadline:
            break
        _settled(jax_native._LIB_PATH, settle_s, deadline)
        with jax_native._lock:
            jax_native._failed = False
            jax_native._lib = None
    return jax_native.available()
