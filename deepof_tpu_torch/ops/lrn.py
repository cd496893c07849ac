"""Local response normalization across channels (port of
`deepof_tpu/ops/lrn.py`), on NHWC tensors:

  out[..., d] = x[..., d] / (bias + alpha * sum_{i=d-r}^{d+r} x[..., i]^2) ** beta

TF's LRN at depth_radius=4, beta=0.7, bias=1, alpha=1 normalises the
photometric-loss inputs. For 3-channel images and r=4 the window covers
every channel, so the denominator is shared across channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def local_response_normalization(x: torch.Tensor, depth_radius: int = 4,
                                 bias: float = 1.0, alpha: float = 1.0,
                                 beta: float = 0.7) -> torch.Tensor:
    c = x.shape[-1]
    sq = x.square()
    if depth_radius >= c - 1:
        window_sum = sq.sum(-1, keepdim=True)
    else:
        # windowed channel sum from a padded cumulative sum
        cs = F.pad(sq, (depth_radius + 1, depth_radius)).cumsum(-1)
        window_sum = cs[..., 2 * depth_radius + 1:] - cs[..., :c]
    return x / torch.pow(bias + alpha * window_sum, beta)
