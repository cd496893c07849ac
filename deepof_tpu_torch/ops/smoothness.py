"""Flow and image spatial-gradient helpers for the smoothness losses
(port of `deepof_tpu/ops/smoothness.py`), on NHWC tensors (..., H, W, C).

Conventions, as in the JAX package (cross-correlation with SAME zero
padding):
  forward_diff_x(f)[y, x] = f[y, x] - f[y, x+1]   (last column: f[y, x] - 0)
  forward_diff_y(f)[y, x] = f[y, x] - f[y+1, x]   (last row:    f[y, x] - 0)

The smoothness term takes the x-difference of U and the y-difference of
V: the reference's intended filter, not its under-filled
`FlowDeltaWeights` constant (see the JAX module's note).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# TF rgb_to_grayscale weights applied to the channels as stored (BGR
# images go through them unchanged, as in the reference).
GRAY_WEIGHTS = (0.2989, 0.587, 0.114)


def forward_diff_x(f: torch.Tensor) -> torch.Tensor:
    """f - shift_left(f) along W, zero fill at the last column."""
    return f - F.pad(f[..., :, 1:, :], (0, 0, 0, 1))


def forward_diff_y(f: torch.Tensor) -> torch.Tensor:
    """f - shift_up(f) along H, zero fill at the last row."""
    return f - F.pad(f[..., 1:, :, :], (0, 0, 0, 0, 0, 1))


def second_diff_x(f: torch.Tensor) -> torch.Tensor:
    """f[x-1] - 2 f[x] + f[x+1] along W, zero fill at both edge columns
    (the caller masks them out); zero for any flow affine in x."""
    left = F.pad(f[..., :, :-1, :], (0, 0, 1, 0))
    right = F.pad(f[..., :, 1:, :], (0, 0, 0, 1))
    return left - 2.0 * f + right


def second_diff_y(f: torch.Tensor) -> torch.Tensor:
    """Second difference along H (see second_diff_x)."""
    up = F.pad(f[..., :-1, :, :], (0, 0, 0, 0, 1, 0))
    down = F.pad(f[..., 1:, :, :], (0, 0, 0, 0, 0, 1))
    return up - 2.0 * f + down


def sobel_gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel x/y gradients of (B, H, W, 1), SAME zero padding:
    sobel_x = [[-1,0,1],[-2,0,2],[-1,0,1]], sobel_y its transpose, as
    shift-adds."""
    a = gray[..., 0]  # (B, H, W)
    h, w = a.shape[-2:]
    padded = F.pad(a, (1, 1, 1, 1))

    def cc(kernel):
        # out(y, x) = sum_k k(dy, dx) * in(y + dy - 1, x + dx - 1)
        out = 0.0
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                kv = kernel[dy + 1][dx + 1]
                if kv:
                    out = out + kv * padded[..., 1 + dy:1 + dy + h,
                                            1 + dx:1 + dx + w]
        return out[..., None]

    sx = cc([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]])
    sy = cc([[-1, -2, -1], [0, 0, 0], [1, 2, 1]])
    return sx, sy


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1) with TF grayscale weights."""
    weights = torch.tensor(GRAY_WEIGHTS, dtype=img.dtype, device=img.device)
    return (img @ weights)[..., None]
