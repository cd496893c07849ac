"""ctypes bindings for the native IO library (`io_native.cc`, a copy of
the JAX package's with three more entry points).

The library is built with g++ at first use into
`build/deepof_tpu_torch/libdeepof_io-<variant>-<hash>.so` at the
repository root, never beside the source; the hash covers the source and
the variant's flags, so a stale library is never loaded. The four codec
variants of the JAX package are tried in order (PNG + JPEG, PNG, JPEG,
PPM only): the first that builds and loads (its codec libraries found
at run time too) is used, and `codecs()` says which formats it decodes.
A variant that does not build leaves a `.failed` note beside its
library, so later processes skip it. If no variant builds and loads,
every call raises: nothing here falls back to another decoder (the
loaders choose the Python PNG reader, `io/png.py`, themselves when
`codecs()` lacks "png").

Batch calls run on the library's own thread pool and touch no Python
state, so ctypes releases the GIL for their whole duration and decode
overlaps the training step under the prefetcher.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "io_native.cc"
BUILD_DIR = _HERE.parents[1] / "build" / "deepof_tpu_torch"
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
#: (name, defines, libraries), tried in this order
VARIANTS = (
    ("png-jpeg", ("-DDEEPOF_HAVE_PNG", "-DDEEPOF_HAVE_JPEG"),
     ("-lpng", "-ljpeg")),
    ("png", ("-DDEEPOF_HAVE_PNG",), ("-lpng",)),
    ("jpeg", ("-DDEEPOF_HAVE_JPEG",), ("-ljpeg",)),
    ("ppm", (), ()),
)
_CODEC_BITS = {"ppm": 1, "png": 2, "jpeg": 4}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_path: Path | None = None


def _variant_path(name: str, defines, libs) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((*BASE_FLAGS, *defines, *libs)).encode())
    return BUILD_DIR / f"libdeepof_io-{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, defines, libs) -> Path:
    """One variant's library, built unless it exists. Raises OSError with
    the compiler's output if it does not build (and leaves the output in
    a `.failed` note, which later calls read instead of building)."""
    path = _variant_path(name, defines, libs)
    failed = path.with_suffix(".failed")
    if path.exists():
        return path
    if failed.exists():
        raise OSError(failed.read_text())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            ["g++", *BASE_FLAGS, *defines, str(SOURCE), *libs, "-o",
             str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, timeout=300)
    except FileNotFoundError as e:  # no g++: no variant can build
        raise RuntimeError(f"native IO library: {e}") from e
    if proc.returncode != 0:
        failed.write_text(proc.stdout)
        raise OSError(proc.stdout)
    os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib, _path
    with _lock:
        if _lib is not None:
            return _lib
        errors = []
        for variant in VARIANTS:
            try:
                path = _build(*variant)
                lib = ctypes.CDLL(str(path))  # its codec libraries load
                break
            except OSError as e:
                errors.append(f"{variant[0]}: {e}")
        else:
            raise RuntimeError("native IO library: no variant builds and "
                               "loads:\n" + "\n".join(errors))
        c_char_pp = ctypes.POINTER(ctypes.c_char_p)
        f32_p = ctypes.POINTER(ctypes.c_float)
        u8_p = ctypes.POINTER(ctypes.c_uint8)
        i32_p = ctypes.POINTER(ctypes.c_int)
        lib.deepof_codecs.argtypes = []
        lib.deepof_image_dims.argtypes = [ctypes.c_char_p, i32_p, i32_p]
        lib.deepof_decode_image_u8.argtypes = [ctypes.c_char_p, u8_p,
                                               ctypes.c_int, ctypes.c_int]
        lib.deepof_image_supported.argtypes = [ctypes.c_char_p]
        lib.deepof_image_dims_mem.argtypes = [ctypes.c_char_p,
                                              ctypes.c_size_t, i32_p, i32_p]
        lib.deepof_decode_mem_u8.argtypes = [ctypes.c_char_p,
                                             ctypes.c_size_t, u8_p,
                                             ctypes.c_int, ctypes.c_int]
        lib.deepof_decode_image_batch.argtypes = [c_char_pp, ctypes.c_int,
                                                  f32_p, ctypes.c_int,
                                                  ctypes.c_int]
        lib.deepof_flo_dims.argtypes = [ctypes.c_char_p, i32_p, i32_p]
        lib.deepof_read_flo_batch.argtypes = [c_char_pp, ctypes.c_int, f32_p,
                                              ctypes.c_int, ctypes.c_int]
        for fn in ("deepof_codecs", "deepof_image_dims",
                   "deepof_decode_image_u8", "deepof_image_supported",
                   "deepof_image_dims_mem", "deepof_decode_mem_u8",
                   "deepof_decode_image_batch", "deepof_flo_dims",
                   "deepof_read_flo_batch"):
            getattr(lib, fn).restype = ctypes.c_int
        _lib, _path = lib, path
        return lib


def library_path() -> str:
    """The loaded library's path (built first if needed)."""
    _load()
    return str(_path)


def codecs() -> frozenset[str]:
    """The formats this build decodes: a subset of {"ppm", "png",
    "jpeg"}, always with "ppm"."""
    bits = _load().deepof_codecs()
    return frozenset(k for k, b in _CODEC_BITS.items() if bits & b)


def _paths_array(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def image_supported(path: str) -> bool:
    """True iff this build's codecs decode `path` (by its magic bytes)."""
    return bool(_load().deepof_image_supported(os.fsencode(path)))


def image_dims(path: str) -> tuple[int, int]:
    """(H, W) of a PPM / PNG / JPEG file, from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if _load().deepof_image_dims(os.fsencode(path), ctypes.byref(h),
                                 ctypes.byref(w)):
        raise OSError(f"native image probe failed: {path} (missing, "
                      f"corrupt, or a codec outside {sorted(codecs())})")
    return h.value, w.value


def imread_bgr(path: str) -> np.ndarray:
    """Decode a PPM / PNG / JPEG at its own size -> (H, W, 3) uint8 BGR,
    as cv2.imread(path, IMREAD_COLOR) does."""
    h, w = image_dims(path)
    out = np.empty((h, w, 3), np.uint8)
    if _load().deepof_decode_image_u8(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w):
        raise OSError(f"native image decode failed: {path}")
    return out


#: leading bytes of each codec's files -> the codec's name
MAGIC = ((b"P6", "ppm"), (b"\x89PNG", "png"), (b"\xff\xd8", "jpeg"))


def sniff(data: bytes) -> str | None:
    """The codec of an encoded image from its leading bytes, or None."""
    for magic, name in MAGIC:
        if data[:len(magic)] == magic:
            return name
    return None


def imdecode_bgr(data: bytes) -> np.ndarray:
    """Decode a PPM / PNG / JPEG held in memory at its own size ->
    (H, W, 3) uint8 BGR, as cv2.imdecode(buf, IMREAD_COLOR) does.
    Raises OSError when the bytes are corrupt or of a codec this build
    lacks."""
    lib = _load()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.deepof_image_dims_mem(data, len(data), ctypes.byref(h),
                                 ctypes.byref(w)):
        raise OSError(f"native image probe failed on {len(data)} bytes "
                      f"(corrupt, or a codec outside {sorted(codecs())})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.deepof_decode_mem_u8(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h.value,
            w.value):
        raise OSError(f"native image decode failed on {len(data)} bytes")
    return out


def decode_image_batch(paths: list[str], size: tuple[int, int]) -> np.ndarray:
    """Decode images (PPM / PNG / JPEG by magic bytes, mixed formats
    allowed) in parallel to (N, H, W, 3) float32 BGR, each resized to
    `size` by the library's bilinear resize."""
    h, w = size
    out = np.empty((len(paths), h, w, 3), np.float32)
    failures = _load().deepof_decode_image_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w)
    if failures:
        raise OSError(f"native image decode failed for {failures} file(s) "
                      f"in a batch of {len(paths)}")
    return out


def read_flo_batch(paths: list[str], size: tuple[int, int]) -> np.ndarray:
    """Read `.flo` files (all of shape `size`) in parallel to
    (N, H, W, 2) float32."""
    h, w = size
    out = np.empty((len(paths), h, w, 2), np.float32)
    failures = _load().deepof_read_flo_batch(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w)
    if failures:
        raise OSError(f"native .flo read failed for {failures} file(s)")
    return out


def flo_dims(path: str) -> tuple[int, int]:
    """(H, W) of a `.flo` file, from its header."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if _load().deepof_flo_dims(os.fsencode(path), ctypes.byref(h),
                               ctypes.byref(w)):
        raise OSError(f"bad .flo file: {path}")
    return h.value, w.value
