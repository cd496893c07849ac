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

`backward_warp_levels` keeps the JAX package's NHWC layout and warps
every level of the pyramid loss at once; `backward_warp` (NHWC) and
`backward_warp_nchw` are its one-level case. All run one
`torch.autograd.Function`, `BackwardWarpLevels`: on CUDA tensors its
forward launches the warp kernel once for all levels and its backward the
flow-gradient kernel once (`ops/cuda/warp.py`), on strided views without
a layout copy; on CPU tensors both run the plain versions,
`backward_warp_reference` and `warp_flow_grad_reference`, level by level.
`backward_warp_volume` folds the T-1 frame pairs of a volume into the
batch, so a volume of any length is one level. `warp_levels_forward` is
the forward alone, without autograd, for warps of data (the
augmentation's resample, the occlusion mask's warp of the backward
flows): one launch on a card, counted by call site.

Neighbours are named as in the kernel source (`csrc/warp.cu`):
Ia = (y0, x0), Ib = (y0, x1), Ic = (y1, x0), Id = (y1, x1).

A bf16 image (the loss under `loss.gather_dtype="bfloat16"`) is
gathered as bf16 and blended in float32, and each level takes one of
the JAX package's two routes for it (F11), chosen by `impl` as the JAX
package chooses on a TPU (`pallas_route`): "xla" returns float32
(`deepof_tpu/ops/warp.py:84-124`), "pallas" rounds the float32 result
to bf16 (`ops/pallas/warp.py:198`), and "auto" takes the Pallas route
for a level of W <= 128 and H <= 128 and the XLA route otherwise
(`ops/warp.py:54-55,78-80`). A float32 image gives float32 on every
route, and the route changes nothing else: the kernels and the plain
versions compute one value for all three.
"""

from __future__ import annotations

import torch

from ..core.config import WARP_IMPLS

#: impl="auto" takes the JAX package's Pallas route for a level of
#: W <= 128 and H <= 128 (`deepof_tpu/ops/warp.py:54-55`), as it does on
#: a TPU, where the package was meant to run
PALLAS_AUTO_MAX_W = 128
PALLAS_AUTO_MAX_H = 128


def pallas_route(impl: str, h: int, w: int) -> bool:
    """True where the JAX package warps an (h, w) level on its Pallas
    route on a TPU: impl "pallas", or "auto" at W <= 128 and H <= 128."""
    _check_impl(impl)
    return impl == "pallas" or (impl == "auto" and w <= PALLAS_AUTO_MAX_W
                                and h <= PALLAS_AUTO_MAX_H)


def warped_dtype(image_dtype: torch.dtype, pallas: bool) -> torch.dtype:
    """The warped image's dtype: float32 for a bf16 image on the XLA
    route (bf16 values blended with float32 weights), the image's dtype
    otherwise (the Pallas route rounds to it)."""
    if image_dtype == torch.bfloat16 and not pallas:
        return torch.float32
    return image_dtype


def _taps(image: torch.Tensor, flow: torch.Tensor):
    """The bilinear taps of the plain version: (ia, ib, ic, id) gathered
    in float32, (B, C, H, W) each, the weights wx, wy (B, 1, H, W),
    zeroed on a saturated side, and the saturation masks left, top
    (B, H, W)."""
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
    left, top = xs < 0, ys < 0
    wx = torch.where(left, torch.zeros_like(wx), wx)[:, None]
    wy = torch.where(top, torch.zeros_like(wy), wy)[:, None]

    img = image.float()
    img_x = torch.cat([img[..., 1:], img[..., -1:]], dim=3)
    img_y = torch.cat([img[:, :, 1:], img[:, :, -1:]], dim=2)
    img_xy = torch.cat([img_x[:, :, 1:], img_x[:, :, -1:]], dim=2)
    patch = torch.cat([img, img_x, img_y, img_xy], dim=1)  # (B, 4C, H, W)
    idx = (y0 * w + x0).reshape(b, 1, h * w).expand(b, 4 * c, h * w)
    g = patch.reshape(b, 4 * c, h * w).gather(2, idx).reshape(b, 4 * c, h, w)
    ia, ib, ic, id_ = g[:, :c], g[:, c:2 * c], g[:, 2 * c:3 * c], g[:, 3 * c:]
    return (ia, ib, ic, id_), wx, wy, left, top


def backward_warp_reference(image: torch.Tensor, flow: torch.Tensor,
                            pallas: bool = False) -> torch.Tensor:
    """Plain PyTorch version: image (B, C, H, W), flow (B, 2, H, W) ->
    (B, C, H, W) in `warped_dtype(image.dtype, pallas)`: blended in
    float32 from the image's values, and rounded once to bf16 for a
    bf16 image on the Pallas route.

    The JAX package's XLA formulation (`deepof_tpu/ops/warp.py:86-122`):
    the 2x2 neighbourhood is packed into channels by edge-clamped shifts
    and gathered once at the (y0, x0) address; zeroing the fractional
    weight at left/top saturation gives the independently clipped value
    and its (zero) flow gradient there. Differentiable by autograd in
    both arguments (zero through floor and the clipped indices)."""
    (ia, ib, ic, id_), wx, wy, _, _ = _taps(image, flow)
    out = (ia * (1 - wx) * (1 - wy) + ic * (1 - wx) * wy
           + ib * wx * (1 - wy) + id_ * wx * wy)
    return out.to(warped_dtype(image.dtype, pallas))


def warp_flow_grad_reference(image: torch.Tensor, flow: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the flow cotangent: image and cotangent
    g (B, C, H, W) (each float32 or bf16, read as float32), flow
    (B, 2, H, W) -> (B, 2, H, W) float32,

      du = sum_c g_c ((1-wy)(Ib-Ia) + wy(Id-Ic))
      dv = sum_c g_c ((1-wx)(Ic-Ia) + wx(Id-Ib)),

    summed over the channels in ascending order, each product and sum
    rounded on its own, and exactly 0 on a saturated side: the flow
    gradient of `backward_warp_reference` (what autograd gives, up to
    rounding), in the flow-gradient kernel's order of operations, so the
    two agree bit for bit (F6)."""
    (ia, ib, ic, id_), wx, wy, left, top = _taps(image, flow)
    gf = g.float()
    omx, omy = 1 - wx[:, 0], 1 - wy[:, 0]
    wx, wy = wx[:, 0], wy[:, 0]
    du = torch.zeros_like(omx)
    dv = torch.zeros_like(omx)
    for c in range(image.shape[1]):
        du = du + gf[:, c] * (omy * (ib[:, c] - ia[:, c])
                              + wy * (id_[:, c] - ic[:, c]))
        dv = dv + gf[:, c] * (omx * (ic[:, c] - ia[:, c])
                              + wx * (id_[:, c] - ib[:, c]))
    zero = torch.zeros_like(du)
    return torch.stack([torch.where(left, zero, du),
                        torch.where(top, zero, dv)], dim=1)


def _image_grad(image, flow, g, pallas):
    """The image cotangent of `backward_warp_reference`, by autograd."""
    with torch.enable_grad():
        im = image.detach().requires_grad_(True)
        out = backward_warp_reference(im, flow.detach(), pallas)
        return torch.autograd.grad(out, im, g)[0]


class BackwardWarpLevels(torch.autograd.Function):
    """The warp of up to eight levels with its flow gradients: one launch
    of each CUDA kernel for all levels on CUDA tensors, the plain version
    level by level on CPU tensors (`backward_warp_reference` and
    `warp_flow_grad_reference`).

    `apply(n, image_1, ..., image_n, flow_1, ..., flow_n)` -> the n warped
    images, each (B, C, H_k, W_k) in its image's layout. `n` is the level
    count, or a tuple of n flags, True for a level on the JAX package's
    Pallas route (`pallas_route`; an int means the XLA route for all),
    which sets a bf16 image's output dtype (`warped_dtype`). The tensors
    are saved and handed to the kernels as given, strided views
    included: no layout copy. A level whose output gets no cotangent is
    given zeros, and its flow gradient still comes back.

    The image cotangent, when asked for, is autograd of the plain version
    on any device: the JAX package computes it in XLA, not in Pallas
    (`ops/pallas/warp.py:281`). In training the image is data and it is
    never asked for."""

    @staticmethod
    def forward(ctx, n, *tensors: torch.Tensor):
        routes = (False,) * n if isinstance(n, int) else tuple(n)
        n = len(routes)
        images, flows = tensors[:n], tensors[n:]
        ctx.routes = routes
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*tensors)
        if _on_cpu(tensors):
            return tuple(backward_warp_reference(i, f, p)
                         for i, f, p in zip(images, flows, routes))
        from .cuda.warp import warp_fwd_levels_cuda

        return tuple(warp_fwd_levels_cuda(images, flows, pallas=routes))

    @staticmethod
    def backward(ctx, *gs):
        routes = ctx.routes
        n = len(routes)
        saved = ctx.saved_tensors
        images, flows = saved[:n], saved[n:]
        want_image = ctx.needs_input_grad[1:n + 1]
        want_flow = ctx.needs_input_grad[n + 1:]
        gs = [torch.zeros_like(i, dtype=warped_dtype(i.dtype, p))
              if g is None else g for g, i, p in zip(gs, images, routes)]
        cpu = _on_cpu(saved)
        d_image, d_flow = [None] * n, [None] * n
        for k in range(n):
            if want_image[k]:
                d_image[k] = _image_grad(images[k], flows[k], gs[k],
                                         routes[k])
            if cpu and want_flow[k]:
                d_flow[k] = warp_flow_grad_reference(images[k], flows[k],
                                                     gs[k])
        levels = [k for k in range(n) if want_flow[k]]
        if not cpu and levels:
            from .cuda.warp import warp_flow_grad_levels_cuda

            grads = warp_flow_grad_levels_cuda(
                [images[k] for k in levels], [flows[k] for k in levels],
                [gs[k] for k in levels])
            for k, g in zip(levels, grads):
                d_flow[k] = g
        return (None, *d_image, *d_flow)


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_impl(impl: str) -> None:
    if impl not in WARP_IMPLS:
        raise ValueError(f"unknown warp impl {impl!r}: one of {WARP_IMPLS}")


def backward_warp_nchw(image: torch.Tensor, flow: torch.Tensor,
                       impl: str = "auto") -> torch.Tensor:
    """image (B, C, H, W), flow (B, 2, H, W) -> (B, C, H, W): one level of
    `BackwardWarpLevels`.

    impl: "auto", "xla" or "pallas" (the JAX package's TPU routes) all
    launch the CUDA kernels for a CUDA tensor (or raise) and run the
    plain version for a CPU tensor; for a bf16 image they choose the
    output dtype (`pallas_route`, `warped_dtype`)."""
    route = pallas_route(impl, image.shape[2], image.shape[3])
    return BackwardWarpLevels.apply((route,), image, flow)[0]


def backward_warp_levels(images: list[torch.Tensor],
                         flows: list[torch.Tensor],
                         impl: str = "auto") -> list[torch.Tensor]:
    """Warp each image (B, H_k, W_k, C) backward by its flow
    (B, H_k, W_k, 2), which already includes any flow scale; returns the
    warped images, (B, H_k, W_k, C) each. On CUDA tensors all levels (at
    most 8, sharing B and C) take one launch of each kernel, and they
    reach it as permuted views, without a copy. `impl` as in
    `backward_warp_nchw`, level by level."""
    routes = tuple(pallas_route(impl, i.shape[1], i.shape[2])
                   for i in images)
    outs = BackwardWarpLevels.apply(
        routes, *(i.permute(0, 3, 1, 2) for i in images),
        *(f.permute(0, 3, 1, 2) for f in flows))
    return [o.permute(0, 2, 3, 1) for o in outs]


def warp_levels_forward(images: list[torch.Tensor],
                        flows: list[torch.Tensor], impl: str = "auto",
                        site: str = "loss") -> list[torch.Tensor]:
    """`backward_warp_levels` without a gradient, for warps of data: the
    augmentation's resample and the occlusion mask's warp of the
    backward flow. On CUDA tensors one launch of the forward kernel for
    all levels, counted on the launch counter of `site` ("loss",
    "augment" or "occlusion": `ops/cuda/warp.py::SITE_COUNTERS`); on
    CPU tensors the plain version level by level."""
    _check_impl(impl)
    imgs = [i.detach().permute(0, 3, 1, 2) for i in images]
    flws = [f.detach().permute(0, 3, 1, 2) for f in flows]
    if _on_cpu(imgs + flws):
        outs = [backward_warp_reference(i, f) for i, f in zip(imgs, flws)]
    else:
        from .cuda.warp import warp_fwd_levels_cuda

        outs = warp_fwd_levels_cuda(imgs, flws, site=site)
    return [o.permute(0, 2, 3, 1) for o in outs]


def backward_warp(image: torch.Tensor, flow: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """Warp `image` (B, H, W, C) backward by `flow` (B, H, W, 2), which
    already includes any flow scale; returns (B, H, W, C). The one-level
    case of `backward_warp_levels`."""
    return backward_warp_levels([image], [flow], impl)[0]


def fold_pairs(volume: torch.Tensor, flows: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """volume (B, H, W, 3T), flows (B, H, W, 2(T-1)) -> the next frames
    (B(T-1), H, W, 3) and their flows (B(T-1), H, W, 2), pair t of row b
    at b(T-1) + t, as the JAX package folds them
    (`deepof_tpu/ops/warp.py:143-148`)."""
    b, h, w, c3t = volume.shape
    t = c3t // 3
    nxt = (volume.reshape(b, h, w, t, 3)[..., 1:, :].permute(0, 3, 1, 2, 4)
           .reshape(b * (t - 1), h, w, 3))
    flw = (flows.reshape(b, h, w, t - 1, 2).permute(0, 3, 1, 2, 4)
           .reshape(b * (t - 1), h, w, 2))
    return nxt, flw


def unfold_pairs(recon: torch.Tensor, b: int) -> torch.Tensor:
    """(B(T-1), H, W, 3) warped frames -> (B, H, W, 3(T-1)), pair-major."""
    n, h, w, c = recon.shape
    return (recon.reshape(b, n // b, h, w, c).permute(0, 2, 3, 1, 4)
            .reshape(b, h, w, n // b * c))


def backward_warp_volume(volume: torch.Tensor, flows: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """Multi-frame warp: volume (B, H, W, 3T) channel-stacked frames,
    flows (B, H, W, 2(T-1)), already scaled -> (B, H, W, 3(T-1)): frame
    t reconstructed from frame t+1 by flow pair t. The pairs fold into
    the batch, so all T-1 take one launch of each kernel. `impl` as in
    `backward_warp_nchw`."""
    nxt, flw = fold_pairs(volume, flows)
    return unfold_pairs(backward_warp(nxt, flw, impl), volume.shape[0])
