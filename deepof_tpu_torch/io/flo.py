"""Middlebury `.flo` optical-flow file IO (copy of `deepof_tpu/io/flo.py`).

Format:
  - 4-byte float32 magic tag 202021.25 ("PIEH" when read as ASCII)
  - int32 width, int32 height (little endian)
  - h*w*2 float32 values, interleaved (u, v) row-major.
"""

from __future__ import annotations

import os

import numpy as np

FLO_TAG = 202021.25
_TAG_BYTES = np.float32(FLO_TAG).tobytes()


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Read a `.flo` file -> float32 array of shape (H, W, 2), channels (u, v).

    Raises ValueError on a bad magic tag, implausible dims or truncation.
    """
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)
        if tag.size != 1 or tag[0] != np.float32(FLO_TAG):
            raise ValueError(f"{path}: invalid .flo magic tag {tag!r}")
        w, h = np.frombuffer(f.read(8), np.int32)
        if w <= 0 or h <= 0 or w > 99999 or h > 99999:
            raise ValueError(f"{path}: implausible dims {w}x{h}")
        data = np.frombuffer(f.read(int(w) * int(h) * 2 * 4), np.float32)
        if data.size != w * h * 2:
            raise ValueError(f"{path}: truncated flow data")
        return data.reshape(int(h), int(w), 2).copy()


def flo_bytes(flow: np.ndarray) -> bytes:
    """(H, W, 2) float32 flow -> Middlebury `.flo` bytes."""
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"flow must be (H, W, 2), got {flow.shape}")
    h, w = flow.shape[:2]
    return _TAG_BYTES + np.array([w, h], np.int32).tobytes() + flow.tobytes()


def write_flo(path: str | os.PathLike, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 flow to Middlebury `.flo`."""
    with open(path, "wb") as f:
        f.write(flo_bytes(flow))
