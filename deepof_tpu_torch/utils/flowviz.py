"""Middlebury flow-color visualization (copy of
`deepof_tpu/utils/flowviz.py`, pure numpy).

Capability parity with reference `utils.py:209-350` (`flowToColor` /
`computeColor` / `makecolorwheel`), vectorized (no per-color python loops over
pixels) and with the color wheel built once at module load.

Convention: hue encodes direction (red at 3 o'clock, rotating through
yellow/green/cyan/blue/magenta), saturation encodes magnitude normalized by
the max radius in the field.
"""

from __future__ import annotations

import numpy as np

_UNKNOWN_FLOW_THRESH = 1e9


def make_colorwheel() -> np.ndarray:
    """55-color Middlebury wheel, float in [0, 1], shape (55, 3)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    ncols = ry + yg + gc + cb + bm + mr
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[col : col + ry, 0] = 1
    wheel[col : col + ry, 1] = np.arange(ry) / ry
    col += ry
    wheel[col : col + yg, 0] = 1 - np.arange(yg) / yg
    wheel[col : col + yg, 1] = 1
    col += yg
    wheel[col : col + gc, 1] = 1
    wheel[col : col + gc, 2] = np.arange(gc) / gc
    col += gc
    wheel[col : col + cb, 1] = 1 - np.arange(cb) / cb
    wheel[col : col + cb, 2] = 1
    col += cb
    wheel[col : col + bm, 2] = 1
    wheel[col : col + bm, 0] = np.arange(bm) / bm
    col += bm
    wheel[col : col + mr, 2] = 1 - np.arange(mr) / mr
    wheel[col : col + mr, 0] = 1
    return wheel


_WHEEL = make_colorwheel()


def compute_color(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Map normalized (u, v) (radius<=1 in-range) to uint8 RGB image."""
    ncols = _WHEEL.shape[0]
    radius = np.sqrt(u**2 + v**2)
    rot = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (rot + 1) / 2 * (ncols - 1)
    k0 = fk.astype(np.int32)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * _WHEEL[k0] + f * _WHEEL[k1]  # (..., 3)
    in_range = (radius <= 1)[..., None]
    rad = radius[..., None]
    col = np.where(in_range, 1 - rad * (1 - col), col * 0.75)
    return np.floor(255 * col).astype(np.uint8)


def flow_to_color(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 RGB, normalized by max radius."""
    u = np.array(flow[..., 0], dtype=np.float64)
    v = np.array(flow[..., 1], dtype=np.float64)
    unknown = (np.abs(u) > _UNKNOWN_FLOW_THRESH) | (np.abs(v) > _UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    maxrad = float(np.max(np.sqrt(u**2 + v**2))) if max_flow is None else float(max_flow)
    eps = 2.22e-16
    img = compute_color(u / (maxrad + eps), v / (maxrad + eps))
    img[unknown] = 0
    return img
