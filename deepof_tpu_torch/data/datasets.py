"""Dataset constants and the host-side resize (subset of
`deepof_tpu/data/datasets.py`).

The JAX package resizes with cv2's INTER_LINEAR. This package has no
cv2: `_resize` is PyTorch's bilinear interpolation with half-pixel
centres and no antialiasing, which is the same sampling rule. It returns
float32 where cv2 rounds a uint8 image back to uint8, so the two differ
by at most a grey level.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FLYINGCHAIRS_MEAN = (97.533, 99.238, 97.056)  # BGR
SINTEL_MEAN = (70.1433, 83.1915, 92.8827)
UCF101_MEAN = (104.0, 117.0, 123.0)

DATASET_MEANS = {
    "flyingchairs": FLYINGCHAIRS_MEAN,
    "sintel": SINTEL_MEAN,
    "ucf101": UCF101_MEAN,
    "synthetic": (0.0, 0.0, 0.0),
}


def _resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) array -> (hw[0], hw[1], C) float32, bilinear.

    An image already at `hw` is returned as it is (dtype unchanged)."""
    if img.shape[:2] == tuple(hw):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()
