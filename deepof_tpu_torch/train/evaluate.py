"""Evaluation protocol, host side (subset of `deepof_tpu/train/evaluate.py`).

The finest prediction (already multiplied by its flow scale) is
multiplied by `train.eval_amplifier`, clipped to `train.eval_clip` and
bilinearly resized to the native resolution. The resize is PyTorch's
bilinear interpolation (half-pixel centres, no antialiasing), which
samples as cv2's INTER_LINEAR does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ExperimentConfig


def postprocess_flow(flow: np.ndarray, cfg: ExperimentConfig,
                     gt_hw: tuple[int, int]) -> np.ndarray:
    """(B, h, w, 2k) net output -> amplified/clipped/native-res flow."""
    lo, hi = cfg.train.eval_clip
    flow = np.clip(flow * cfg.train.eval_amplifier, lo, hi)
    if flow.shape[1:3] == tuple(gt_hw):
        return flow
    t = torch.from_numpy(np.ascontiguousarray(flow, np.float32))
    out = F.interpolate(t.permute(0, 3, 1, 2), size=tuple(gt_hw),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).contiguous().numpy()
