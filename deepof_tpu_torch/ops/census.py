"""Soft census transform and distance (port of `deepof_tpu/ops/census.py`),
an illumination-robust photometric penalty (`loss.photometric="census"`),
on NHWC tensors.

Each pixel is described by the normalised differences to a window of
neighbours, d / sqrt(eps + d^2) with d = gray(p + o) - gray(p) on
0-255 intensities; two descriptors are compared by a saturating soft
Hamming distance. Shifted slices of an edge-padded image, no gathers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .smoothness import to_grayscale


def census_transform(images: torch.Tensor, window: int = 7,
                     eps: float = 0.81) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, window**2) soft census descriptors,
    offsets row-major over the window; border rows and columns are
    replicated (the caller's border mask excludes those pixels)."""
    gray = to_grayscale(images * 255.0)  # (B, H, W, 1)
    h, w = gray.shape[1:3]
    r = window // 2
    padded = F.pad(gray.permute(0, 3, 1, 2), (r, r, r, r),
                   mode="replicate").permute(0, 2, 3, 1)
    neighbors = torch.cat([padded[:, dy:dy + h, dx:dx + w, :]
                           for dy in range(window) for dx in range(window)],
                          dim=-1)
    d = neighbors - gray
    return d / torch.sqrt(eps + d.square())


def census_distance(a: torch.Tensor, b: torch.Tensor,
                    thresh: float = 0.1) -> torch.Tensor:
    """(B, H, W, K) x2 -> (B, H, W, 1): sum_k d_k^2 / (thresh + d_k^2)."""
    d2 = (a - b).square()
    return (d2 / (thresh + d2)).sum(dim=-1, keepdim=True)
