"""Optical-flow evaluation metrics (copy of `deepof_tpu/utils/metrics.py`).

Host-side numpy; inputs are (..., H, W, 2) flow fields, channel 0 = u
(horizontal), channel 1 = v (vertical).
"""

from __future__ import annotations

import numpy as np


def flow_epe(pred, gt, mask=None):
    """Average endpoint error (AEE / EPE): the mean over pixels of
    sqrt((u-u_gt)^2 + (v-v_gt)^2); with `mask` (broadcastable to
    (..., H, W)), a masked mean."""
    pred = np.asarray(pred)
    gt = np.asarray(gt)
    d = pred - gt
    ee = np.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    if mask is None:
        return ee.mean()
    mask = np.broadcast_to(np.asarray(mask, dtype=ee.dtype), ee.shape)
    return (ee * mask).sum() / np.maximum(mask.sum(), 1)


def flow_aae(pred, gt, mask=None):
    """Average angular error in radians between the 3D vectors (u, v, 1)
    of prediction and ground truth."""
    u, v = pred[..., 0], pred[..., 1]
    ug, vg = gt[..., 0], gt[..., 1]
    num = 1.0 + u * ug + v * vg
    den = np.sqrt(1.0 + u**2 + v**2) * np.sqrt(1.0 + ug**2 + vg**2)
    ae = np.arccos(np.clip(num / den, -1.0, 1.0))
    if mask is None:
        return ae.mean()
    mask = np.broadcast_to(np.asarray(mask, dtype=ae.dtype), ae.shape)
    return (ae * mask).sum() / np.maximum(mask.sum(), 1)
