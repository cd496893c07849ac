"""Correlation / cost-volume op for FlowNet-C (port of
`deepof_tpu/ops/corr.py`).

For displacements (dy, dx) on a (2K+1)x(2K+1) grid with stride `stride`,
K = max_disp // stride:

    corr[b, y, x, i*n+j] = mean_c f1[b, y, x, c] * f2[b, y+dy_i, x+dx_j, c]

out-of-range f2 positions contribute zero. `correlation` keeps the JAX
package's NHWC layout; the model calls the NCHW core `correlation_nchw`,
which sends a CUDA tensor to the hand-written kernel (`ops/cuda/corr.py`)
and a CPU tensor to the plain version, `correlation_reference`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                          max_disp: int = 20, stride: int = 2) -> torch.Tensor:
    """Plain PyTorch version: (B, C, H, W) x2 -> (B, n*n, H, W).

    A loop over the n*n offsets into a zero-padded f2; the channel mean
    is taken in float32 and the result returned in the input dtype."""
    b, c, h, w = f1.shape
    k = max_disp // stride
    n = 2 * k + 1
    pad = k * stride
    a = f1.float()
    f2p = F.pad(f2.float(), (pad, pad, pad, pad))
    out = torch.empty((b, n * n, h, w), dtype=torch.float32, device=f1.device)
    for i in range(n):
        dy = i * stride
        for j in range(n):
            dx = j * stride
            out[:, i * n + j] = (a * f2p[:, :, dy:dy + h, dx:dx + w]).mean(1)
    return out.to(f1.dtype)


def correlation_nchw(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 20,
                     stride: int = 2, impl: str = "auto") -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, (2K+1)**2, H, W).

    impl: only "auto", which launches the CUDA kernel for a CUDA tensor
    (or raises) and runs the plain version for a CPU tensor. No value
    routes a CUDA tensor around the kernel."""
    if impl != "auto":
        raise ValueError(f"correlation impl {impl!r}: only 'auto'")
    if f1.device.type == "cpu":
        return correlation_reference(f1, f2, max_disp, stride)
    from .cuda.corr import correlation_cuda

    return correlation_cuda(f1, f2, max_disp, stride)


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 20,
                stride: int = 2, impl: str = "auto") -> torch.Tensor:
    """f1, f2: (B, H, W, C) -> (B, H, W, (2K+1)**2), K = max_disp // stride."""
    out = correlation_nchw(f1.permute(0, 3, 1, 2).contiguous(),
                           f2.permute(0, 3, 1, 2).contiguous(),
                           max_disp, stride, impl)
    return out.permute(0, 2, 3, 1)
