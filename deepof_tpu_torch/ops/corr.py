"""Correlation / cost-volume op for FlowNet-C (port of
`deepof_tpu/ops/corr.py`).

For displacements (dy, dx) on a (2K+1)x(2K+1) grid with stride `stride`,
K = max_disp // stride:

    corr[b, y, x, i*n+j] = mean_c f1[b, y, x, c] * f2[b, y+dy_i, x+dx_j, c]

out-of-range f2 positions contribute zero. `correlation` keeps the JAX
package's NHWC layout; the model calls the NCHW core `correlation_nchw`.
Both go through the `torch.autograd.Function` `Correlation` on every
device: a CUDA tensor goes to the hand-written kernels (`ops/cuda/corr.py`,
the forward and its two backward kernels), a CPU tensor to the plain
versions, `correlation_reference` and `correlation_backward_reference`.
Float32 and bfloat16 pass through on both devices: each path
accumulates in float32 and returns the input dtype, as the JAX kernel
does, and the gradients take the inputs' dtypes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def correlation_reference(f1: torch.Tensor, f2: torch.Tensor,
                          max_disp: int = 20, stride: int = 2) -> torch.Tensor:
    """Plain PyTorch version: (B, C, H, W) x2 -> (B, n*n, H, W).

    A loop over the channels, ascending, that adds f1 times the n*n
    shifted windows of a zero-padded f2 into one float32 sum, then scales
    it by the float32 1/C once: the kernel's order (`csrc/corr.cu`). On
    the card `addcmul_` is one fused multiply-add, so the two agree bit
    for bit, which the train step needs: its photometric gradient
    amplifies a rounding difference in the cost volume (ROADMAP F6).
    Returns the input dtype."""
    b, c, h, w = f1.shape
    k = max_disp // stride
    n = 2 * k + 1
    pad = k * stride
    a = f1.float()
    f2p = F.pad(f2.float(), (pad, pad, pad, pad))
    acc = torch.zeros((b, n, n, h, w), dtype=torch.float32, device=f1.device)
    for ch in range(c):
        # [b, i, j, y, x] = f2p[b, ch, i*stride + y, j*stride + x]
        windows = f2p[:, ch].unfold(1, h, stride).unfold(2, w, stride)
        acc.addcmul_(a[:, ch, None, None], windows)
    inv_c = torch.tensor(c, dtype=torch.float32).reciprocal().item()
    return acc.mul_(inv_c).reshape(b, n * n, h, w).to(f1.dtype)


def correlation_backward_reference(f1: torch.Tensor, f2: torch.Tensor,
                                   g: torch.Tensor, max_disp: int = 20,
                                   stride: int = 2
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: (df1, df2) of
    `correlation_reference(f1, f2, max_disp, stride)` for its cotangent
    g (B, n*n, H, W).

    The counterpart of the JAX custom VJP (`deepof_tpu/ops/pallas/corr.py`
    `_bwd`): a loop over the n*n offsets that adds g/C times the shifted
    f2 into df1, and g/C times f1 into the shifted window of a zero-padded
    df2. Upcasts f1, f2 and g (bf16 under `train.compute_dtype`) to
    float32, accumulates in float32 and returns the inputs' dtypes."""
    b, c, h, w = f1.shape
    k = max_disp // stride
    n = 2 * k + 1
    pad = k * stride
    a = f1.float()
    f2p = F.pad(f2.float(), (pad, pad, pad, pad))
    gc = g.float() / c
    df1 = torch.zeros_like(a)
    df2p = torch.zeros_like(f2p)
    for i in range(n):
        dy = i * stride
        for j in range(n):
            dx = j * stride
            gi = gc[:, i * n + j:i * n + j + 1]
            df1.addcmul_(gi, f2p[:, :, dy:dy + h, dx:dx + w])
            df2p[:, :, dy:dy + h, dx:dx + w].addcmul_(gi, a)
    df2 = df2p[:, :, pad:pad + h, pad:pad + w]
    return df1.to(f1.dtype), df2.to(f2.dtype)


class Correlation(torch.autograd.Function):
    """The cost volume with its gradient in both feature maps:
    `apply(f1, f2, max_disp, stride)`, NCHW, float32 or bfloat16: the
    cost volume has the inputs' dtype, and so do their gradients. On CUDA
    tensors the forward and backward kernels run, on CPU tensors the
    plain versions."""

    @staticmethod
    def forward(ctx, f1, f2, max_disp: int, stride: int):
        ctx.geometry = (max_disp, stride)
        ctx.save_for_backward(f1, f2)
        if f1.device.type == "cpu":
            return correlation_reference(f1, f2, max_disp, stride)
        from .cuda.corr import correlation_cuda

        return correlation_cuda(f1, f2, max_disp, stride)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        # autograd may hand g over strided; the kernels read it contiguous
        g = g.contiguous()
        if f1.device.type == "cpu":
            df1, df2 = correlation_backward_reference(f1, f2, g,
                                                      *ctx.geometry)
        else:
            from .cuda.corr import correlation_bwd_cuda

            df1, df2 = correlation_bwd_cuda(f1, f2, g, *ctx.geometry)
        return df1, df2, None, None


def correlation_nchw(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 20,
                     stride: int = 2, impl: str = "auto") -> torch.Tensor:
    """(B, C, H, W) x2 -> (B, (2K+1)**2, H, W).

    impl: only "auto", which launches the CUDA kernels for a CUDA tensor
    (or raises) and runs the plain versions for a CPU tensor, forward and
    backward (`Correlation`). No value routes a CUDA tensor around the
    kernels."""
    if impl != "auto":
        raise ValueError(f"correlation impl {impl!r}: only 'auto'")
    return Correlation.apply(f1, f2, max_disp, stride)


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_disp: int = 20,
                stride: int = 2, impl: str = "auto") -> torch.Tensor:
    """f1, f2: (B, H, W, C) -> (B, H, W, (2K+1)**2), K = max_disp // stride."""
    out = correlation_nchw(f1.permute(0, 3, 1, 2).contiguous(),
                           f2.permute(0, 3, 1, 2).contiguous(),
                           max_disp, stride, impl)
    return out.permute(0, 2, 3, 1)
