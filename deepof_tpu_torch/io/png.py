"""PNG image IO on the standard library's `zlib` and `struct`, with numpy:
the port's counterpart of `cv2.imwrite` and of `cv2.imread` for PNG.

`write_png` takes an (H, W, 3) uint8 BGR image (stored as 8-bit RGB) or
an (H, W) / (H, W, 1) uint8 grey one (stored as 8-bit grey). Each row is
written with filter type 2 (Up), zlib level 6.

`read_png_bgr` (a file) and `parse_png_bgr` (its bytes) read 8-bit,
non-interlaced grey, grey + alpha, RGB and RGBA files with any of the
five row filters, and return (H, W, 3) uint8 BGR as `cv2.imread(path,
cv2.IMREAD_COLOR)` does: grey repeated into the three channels, alpha
dropped. Other PNGs (palette, 16-bit, interlaced) raise ValueError. The
native decoder (`deepof_tpu_torch.native`) is the fast route; the
loaders read with this module only when that build has no PNG codec.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: colour type -> samples per pixel (8-bit only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) BGR or (H, W[, 1]) grey uint8 image."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"image must be (H, W, 3) BGR or (H, W) grey "
                         f"uint8, got {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        raise ValueError(f"empty image {img.shape}")
    colour = 0 if img.ndim == 2 else 2
    rows = np.ascontiguousarray(img if img.ndim == 2 else img[..., ::-1]
                                ).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # filter 2 (Up), modulo 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write an (H, W, 3) BGR or (H, W[, 1]) grey uint8 image as PNG."""
    data = png_bytes(img)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row filters -> (h, stride) uint8."""
    if len(raw) < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    data = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(data[y, 0]), data[y, 1:]
        if kind == 0:  # None
            row = line.copy()
        elif kind == 1:  # Sub: a running sum per byte of a pixel
            row = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prior
        elif kind == 3:  # Average of left and up, left to right
            row = _average_row(line, prior, bpp)
        elif kind == 4:  # Paeth predictor, left to right
            row = _paeth_row(line, prior, bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {kind}")
        out[y] = row
        prior = row
    return out


def _average_row(line: np.ndarray, prior: np.ndarray, bpp: int
                 ) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(bpp):
        cur[i] = (cur[i] + (up[i] >> 1)) & 0xFF
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _paeth_row(line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(bpp):  # no left neighbour: the predictor is up
        cur[i] = (cur[i] + up[i]) & 0xFF
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], up[i], up[i - bpp]
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png_bgr(path: str | os.PathLike) -> np.ndarray:
    """Read an 8-bit, non-interlaced grey / grey + alpha / RGB / RGBA PNG
    -> (H, W, 3) uint8 BGR. Raises ValueError on any other PNG, a bad
    signature or CRC, or truncated data."""
    with open(path, "rb") as f:
        return parse_png_bgr(f.read(), path)


def parse_png_bgr(data: bytes, path="<bytes>") -> np.ndarray:
    """`read_png_bgr` of a PNG file's bytes (an HTTP request's image);
    `path` names it in errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {colour}, interlace {interlace}); "
                         "8-bit non-interlaced grey/RGB(A) only")
    ch = _CHANNELS[colour]
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch, path)
    px = rows.reshape(h, w, ch)
    if ch <= 2:  # grey (+ alpha): repeat into B, G, R
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., 2::-1])
