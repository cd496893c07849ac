"""Binary PPM (P6) image IO in numpy: the FlyingChairs frame format.

`read_ppm_bgr` returns the (H, W, 3) uint8 image in BGR channel order,
as `cv2.imread(path, cv2.IMREAD_COLOR)` does for the JAX package
(`deepof_tpu/data/datasets.py::_imread_bgr`). The header is the netpbm
one: "P6", width, height and maxval as ASCII decimals separated by
whitespace, with `#` comments up to the end of a line, then one
whitespace byte and the RGB samples, one byte each (maxval < 256).
"""

from __future__ import annotations

import os

import numpy as np


def _header(data: bytes, path) -> tuple[list[int], int]:
    """([width, height, maxval], offset of the first sample)."""
    fields: list[int] = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            end = data.find(b"\n", pos)
            if end < 0:
                raise ValueError(f"{path}: truncated PPM header")
            pos = end + 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: bad PPM header")
        fields.append(int(data[start:pos]))
    if not data[pos:pos + 1].isspace():
        raise ValueError(f"{path}: bad PPM header")
    return fields, pos + 1


def read_ppm_bgr(path: str | os.PathLike) -> np.ndarray:
    """Read a binary P6 PPM -> (H, W, 3) uint8, BGR. Raises ValueError on
    a bad header, a 16-bit file or truncated samples."""
    with open(path, "rb") as f:
        return parse_ppm_bgr(f.read(), path)


def parse_ppm_bgr(data: bytes, path="<bytes>") -> np.ndarray:
    """`read_ppm_bgr` of a PPM file's bytes; `path` names it in
    errors."""
    if data[:2] != b"P6":
        raise ValueError(f"{path}: not a binary PPM (P6) file")
    (w, h, maxval), off = _header(data, path)
    if w <= 0 or h <= 0 or not 0 < maxval < 256:
        raise ValueError(f"{path}: unsupported PPM {w}x{h}, maxval {maxval}")
    n = w * h * 3
    if len(data) - off < n:
        raise ValueError(f"{path}: truncated PPM samples")
    rgb = np.frombuffer(data, np.uint8, n, off).reshape(h, w, 3)
    return np.ascontiguousarray(rgb[..., ::-1])


def write_ppm_bgr(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 BGR image as a binary P6 PPM."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"image must be (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img[..., ::-1]).tobytes())
