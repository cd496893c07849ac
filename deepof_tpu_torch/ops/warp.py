"""Bilinear backward warp (port of `deepof_tpu/ops/warp.py`).

Semantics, as in the JAX package:
  - flow channel 0 = u = horizontal displacement (added to x), channel
    1 = v = vertical (added to y); the flow is already scaled;
  - the flow is split into its integer floor and fractional weights;
  - each of the four neighbour coordinates is clipped to the image border
    on its own (clip at the border, no zero fill), and the fractional
    weight is zeroed where the floor coordinate is left of or above the
    image;
  - the four neighbours are blended bilinearly.

`backward_warp` keeps the JAX package's NHWC layout; the loss calls it,
and it hands NCHW tensors to `backward_warp_nchw`. That core runs one
`torch.autograd.Function`: on a CUDA tensor its forward launches the warp
kernel and its backward the flow-gradient kernel (`ops/cuda/warp.py`); on
a CPU tensor both run the plain version, `backward_warp_reference`.

Neighbours are named as in the kernel source (`csrc/warp.cu`):
Ia = (y0, x0), Ib = (y0, x1), Ic = (y1, x0), Id = (y1, x1).
"""

from __future__ import annotations

import torch

from ..core.config import WARP_IMPLS


def backward_warp_reference(image: torch.Tensor,
                            flow: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: image (B, C, H, W), flow (B, 2, H, W) ->
    (B, C, H, W) in the image dtype.

    The JAX package's XLA formulation (`deepof_tpu/ops/warp.py:86-122`):
    the 2x2 neighbourhood is packed into channels by edge-clamped shifts
    and gathered once at the (y0, x0) address; zeroing the fractional
    weight at left/top saturation gives the independently clipped value
    and its (zero) flow gradient there. Differentiable by autograd in
    both arguments (zero through floor and the clipped indices)."""
    b, c, h, w = image.shape
    u, v = flow[:, 0], flow[:, 1]  # (B, H, W)
    fu, fv = torch.floor(u), torch.floor(v)
    wx, wy = u - fu, v - fv
    # clamp in float before the int conversion: a huge, infinite or NaN
    # flow keeps a valid index and the clipped index does not change
    fx = fu.nan_to_num(0.0).clamp(-(w + 1), w + 1).to(torch.int64)
    fy = fv.nan_to_num(0.0).clamp(-(h + 1), h + 1).to(torch.int64)
    xs = torch.arange(w, device=image.device)[None, None, :] + fx
    ys = torch.arange(h, device=image.device)[None, :, None] + fy
    x0 = xs.clamp(0, w - 1)
    y0 = ys.clamp(0, h - 1)
    wx = torch.where(xs < 0, torch.zeros_like(wx), wx)[:, None]
    wy = torch.where(ys < 0, torch.zeros_like(wy), wy)[:, None]

    img = image.float()
    img_x = torch.cat([img[..., 1:], img[..., -1:]], dim=3)
    img_y = torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)
    img_xy = torch.cat([img_x[:, :, 1:], img_x[:, :, -1:]], dim=2)
    patch = torch.cat([img, img_x, img_y, img_xy], dim=1)  # (B, 4C, H, W)
    idx = (y0 * w + x0).reshape(b, 1, h * w).expand(b, 4 * c, h * w)
    g = patch.reshape(b, 4 * c, h * w).gather(2, idx).reshape(b, 4 * c, h, w)
    ia, ib, ic, id_ = g[:, :c], g[:, c:2 * c], g[:, 2 * c:3 * c], g[:, 3 * c:]
    out = (ia * (1 - wx) * (1 - wy) + ic * (1 - wx) * wy
           + ib * wx * (1 - wy) + id_ * wx * wy)
    return out.to(image.dtype)


def _reference_grads(image, flow, g, want_image: bool):
    """(d image, d flow) of `backward_warp_reference` by autograd."""
    with torch.enable_grad():
        im = image.detach().requires_grad_(want_image)
        fl = flow.detach().requires_grad_(True)
        out = backward_warp_reference(im, fl)
        wrt = (im, fl) if want_image else (fl,)
        grads = torch.autograd.grad(out, wrt, g)
    return (grads[0], grads[1]) if want_image else (None, grads[0])


class BackwardWarp(torch.autograd.Function):
    """The warp with its flow gradient: the CUDA kernels on a CUDA
    tensor, the plain version on a CPU tensor.

    The image cotangent, when asked for, is autograd of the plain version
    on any device: the JAX package computes it in XLA, not in Pallas
    (`ops/pallas/warp.py:281`). In training the image is data and it is
    never asked for."""

    @staticmethod
    def forward(ctx, image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(image, flow)
        if image.device.type == "cpu":
            return backward_warp_reference(image, flow)
        from .cuda.warp import warp_fwd_cuda

        return warp_fwd_cuda(image, flow)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        image, flow = ctx.saved_tensors
        want_image, want_flow = ctx.needs_input_grad[:2]
        if image.device.type == "cpu":
            return _reference_grads(image, flow, g, want_image)
        g = g.contiguous()
        d_flow = None
        if want_flow:
            from .cuda.warp import warp_flow_grad_cuda

            d_flow = warp_flow_grad_cuda(image, flow, g)
        d_image = (_reference_grads(image, flow, g, True)[0] if want_image
                   else None)
        return d_image, d_flow


def backward_warp_nchw(image: torch.Tensor, flow: torch.Tensor,
                       impl: str = "auto") -> torch.Tensor:
    """image (B, C, H, W), flow (B, 2, H, W) -> (B, C, H, W).

    impl: "auto", "xla" or "pallas" (the JAX package's TPU routes) all
    launch the CUDA kernels for a CUDA tensor (or raise) and run the
    plain version for a CPU tensor."""
    if impl not in WARP_IMPLS:
        raise ValueError(f"unknown warp impl {impl!r}: one of {WARP_IMPLS}")
    return BackwardWarp.apply(image, flow)


def backward_warp(image: torch.Tensor, flow: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """Warp `image` (B, H, W, C) backward by `flow` (B, H, W, 2), which
    already includes any flow scale; returns (B, H, W, C)."""
    out = backward_warp_nchw(image.permute(0, 3, 1, 2).contiguous(),
                             flow.permute(0, 3, 1, 2).contiguous(), impl)
    return out.permute(0, 2, 3, 1)
