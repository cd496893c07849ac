"""Photometric + smoothness loss at one pyramid scale (port of
`deepof_tpu/losses/photometric.py`): the two-frame `loss_interp` with
every variant of the JAX package (Charbonnier or census photometric
term, canonical or depthwise smoothness of order 1 or 2, the Sobel
`edge_aware` and `edge_aware_photo` weights, the forward-backward
`occlusion_mask`, an optional border mask on the smoothness term), and
`loss_interp_multi`, its T-frame volume form. Tensors are NHWC, as in
the JAX package. Loss dict keys mirror the reference: total /
Charbonnier_reconstruct / U_loss / V_loss, plus smooth = U + V.

Kept exactly, for numeric parity (F5):
  - the Charbonnier normaliser is the count of border-mask-interior
    *image* elements, B * C * interior, reused for the smoothness terms
    (2/3 of it for the depthwise variant);
  - masks multiply the difference *before* the Charbonnier power, so a
    masked pixel still adds (eps^2)^alpha, except in the depthwise
    variant, whose border mask multiplies after;
  - the photometric difference is scaled by 255 before the power;
  - a level whose border mask has no interior (h <= 2 at ratio 0.1)
    contributes exactly 0 to both terms.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core.config import LossConfig
from ..ops.census import census_distance, census_transform
from ..ops.smoothness import (forward_diff_x, forward_diff_y, second_diff_x,
                              second_diff_y, sobel_gradients, to_grayscale)
from ..ops.warp import (backward_warp, backward_warp_volume,
                        warp_levels_forward)

LossDict = dict[str, Any]


def charbonnier(x: torch.Tensor, eps: float, alpha: float) -> torch.Tensor:
    """(x^2 + eps^2)^alpha, the generalised Charbonnier penalty."""
    return torch.pow(x.square() + eps * eps, alpha)


def warp_operand(x: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """The warped image's dtype policy, `loss.gather_dtype` (the JAX
    package's `_warp_operand`, `deepof_tpu/losses/photometric.py:
    140-151`): "bfloat16" casts the image to bf16, which halves the bytes
    the warp gathers; "float32" keeps it. The warp returns float32 or
    bf16 by its route (`ops/warp.py::pallas_route`), and the losses cast
    the result back to the input dtype."""
    if cfg.gather_dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if cfg.gather_dtype != "float32":
        raise ValueError(f"unknown loss.gather_dtype {cfg.gather_dtype!r}; "
                         "use 'float32' or 'bfloat16'")
    return x


def _border_width(h: int, ratio: float, min_width: int = 0) -> int:
    return max(int(math.ceil(h * ratio)), min_width)


def border_mask(h: int, w: int, ratio: float = 0.1, min_width: int = 0,
                device: torch.device | str = "cpu") -> torch.Tensor:
    """(H, W) float mask: 0 in a ceil(ratio*H)-wide border, 1 inside. The
    width derives from H only, as in the reference."""
    bw = _border_width(h, ratio, min_width)
    m = torch.zeros((h, w), device=device)
    m[bw:h - bw, bw:w - bw] = 1.0
    return m


def smoothness_mask_x(h: int, w: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """(H, W) mask zeroing the last column (x-gradient invalid there)."""
    m = torch.ones((h, w), device=device)
    m[:, -1] = 0.0
    return m


def smoothness_mask_y(h: int, w: int,
                      device: torch.device | str = "cpu") -> torch.Tensor:
    """(H, W) mask zeroing the last row (y-gradient invalid there)."""
    m = torch.ones((h, w), device=device)
    m[-1, :] = 0.0
    return m


def _smoothness_diffs(cfg: LossConfig, h: int, w: int,
                      device: torch.device | str = "cpu"):
    """(diff_x, diff_y, mask_x, mask_y) for the configured prior order;
    masks are (1, H, W, 1). Order 2 invalidates both edge columns/rows."""
    mx = smoothness_mask_x(h, w, device)
    my = smoothness_mask_y(h, w, device)
    if cfg.smoothness_order == 2:
        mx = mx * mx.flip(1)
        my = my * my.flip(0)
        return second_diff_x, second_diff_y, mx[None, :, :, None], \
            my[None, :, :, None]
    if cfg.smoothness_order == 1:
        return forward_diff_x, forward_diff_y, mx[None, :, :, None], \
            my[None, :, :, None]
    raise ValueError(f"unknown smoothness_order {cfg.smoothness_order!r}")


def _normalized_sobel(inputs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample min-max to integer [0, 255] (floored), grayscale, Sobel
    x/y: the edge masks' shared preprocessing. Returns (gx, gy), each
    (B, h, w, 1).

    The floor can land differently here and in XLA where 255 (x - min) /
    (max - min) falls within an ulp of an integer: the division and the
    reductions may round apart (ROADMAP Queue C, the Sobel floor)."""
    mn = inputs.amin(dim=(1, 2, 3), keepdim=True)
    mx = inputs.amax(dim=(1, 2, 3), keepdim=True)
    img = 255.0 * (inputs - mn) / torch.clamp(mx - mn, min=1e-12)
    img = torch.clamp(torch.floor(img), 0.0, 255.0)
    return sobel_gradients(to_grayscale(img))


def _edge_aware_masks(inputs: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sobel smoothness down-weighting near image edges: 1 - |g| / max|g|
    for g = gx and gy, each normalised by its one max over the whole
    batch. Returns (mask_x, mask_y), each (B, h, w, 1)."""
    gx, gy = _normalized_sobel(inputs)
    gx = gx / torch.clamp(gx.abs().max(), min=1e-12)
    gy = gy / torch.clamp(gy.abs().max(), min=1e-12)
    return 1.0 - gx.abs(), 1.0 - gy.abs()


def _photo_gradient_mask(inputs: torch.Tensor) -> torch.Tensor:
    """The photometric term's edge weight (`edge_aware_photo`): the Sobel
    gradient magnitude, min-max normalised to [0, 1] per sample, high at
    edges. (B, h, w, 1)."""
    gx, gy = _normalized_sobel(inputs)
    mag = torch.sqrt(gx.square() + gy.square())
    mmn = mag.amin(dim=(1, 2, 3), keepdim=True)
    mmx = mag.amax(dim=(1, 2, 3), keepdim=True)
    return torch.clamp((mag - mmn) / torch.clamp(mmx - mmn, min=1e-12),
                       0.0, 1.0)


def occlusion_mask(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
                   cfg: LossConfig,
                   bw_at_fw: torch.Tensor | None = None) -> torch.Tensor:
    """Forward-backward consistency mask, 1 = visible: flow_fw/flow_bw
    (B, h, w, 2), already scaled. A pixel is occluded when
    |f_fw + w|^2 >= occ_alpha (|f_fw|^2 + |w|^2) + occ_beta, w = the
    backward flow warped by the forward one (`bw_at_fw`, computed here
    unless given: `pyramid_loss` warps every level in one launch). It
    ends in a comparison: no gradient. Returns (B, h, w, 1)."""
    if bw_at_fw is None:
        bw_at_fw = warp_levels_forward([flow_bw], [flow_fw], cfg.warp_impl,
                                       site="occlusion")[0]
    sq = (flow_fw + bw_at_fw).square().sum(dim=-1, keepdim=True)
    bound = cfg.occ_alpha * (
        flow_fw.square().sum(dim=-1, keepdim=True)
        + bw_at_fw.square().sum(dim=-1, keepdim=True)) + cfg.occ_beta
    return (sq < bound).to(flow_fw.dtype)


def check_loss_two_frame(cfg: LossConfig) -> None:
    """The ValueErrors of the JAX package's `loss_interp` on settings
    that would be silently skipped (`photometric.py:196-203, 256-262`)
    and on unknown variants."""
    if cfg.edge_aware_photo and cfg.photometric != "charbonnier":
        raise ValueError(
            "loss.edge_aware_photo pairs only with photometric='charbonnier' "
            f"(got {cfg.photometric!r}); the census branch would silently "
            "skip the photometric weighting")
    if cfg.photometric not in ("charbonnier", "census"):
        raise ValueError(f"unknown photometric variant {cfg.photometric!r}")
    if cfg.smoothness == "canonical" and cfg.edge_aware:
        raise ValueError(
            "loss.edge_aware pairs only with smoothness='depthwise' "
            "(the gen-1 variant it comes from, `version1/model/"
            "warpflow.py:93-157`); the canonical branch would silently "
            "skip the Sobel weighting")
    if cfg.smoothness not in ("canonical", "depthwise"):
        raise ValueError(f"unknown smoothness variant {cfg.smoothness!r}")


def loss_interp(flow: torch.Tensor, inputs: torch.Tensor,
                outputs: torch.Tensor, flow_scale: float, cfg: LossConfig,
                smooth_border_mask: bool = False,
                occ_mask: torch.Tensor | None = None,
                scaled: torch.Tensor | None = None,
                recon: torch.Tensor | None = None
                ) -> tuple[LossDict, torch.Tensor]:
    """flow: (B, h, w, 2) raw head output; inputs/outputs: (B, h, w, C)
    LRN-normalised previous/next frames resized to this scale; occ_mask:
    optional (B, h, w, 1) visibility weights of the photometric term
    (`occlusion_mask`). Returns (loss dict, reconstructed previous
    frame). Raises ValueError on the pairings `check_loss_two_frame`
    names; `cfg` is otherwise taken as checked (`core.config.check_loss`,
    which `pyramid_loss` runs).

    Photometric term: Charbonnier of 255 (recon - inputs), weighted by
    the border mask, the occlusion mask and the `edge_aware_photo`
    gradient mask, or the soft census distance under a border mask
    widened to the census window. Smoothness: canonical (x-difference of
    U, y-difference of V, the masks before the power, the image
    normaliser) or depthwise (both differences of each component, the
    border mask after the power, 2/3 of that normaliser), the latter
    with the `edge_aware` Sobel weights; `edge_aware_photo` weights both
    by 1 - its mask.

    `scaled` (flow * flow_scale) and `recon` (`outputs` warped by it) are
    computed here unless given: `pyramid_loss` warps every level in one
    launch and passes both."""
    check_loss_two_frame(cfg)
    b, h, w, c = inputs.shape
    if scaled is None:
        scaled = flow * flow_scale
    if recon is None:
        recon = backward_warp(warp_operand(outputs, cfg), scaled,
                              impl=cfg.warp_impl).to(inputs.dtype)
    gmask = _photo_gradient_mask(inputs) if cfg.edge_aware_photo else None

    bmask = border_mask(h, w, cfg.border_ratio, device=inputs.device)
    bw = _border_width(h, cfg.border_ratio)
    n_interior = max(h - 2 * bw, 0) * max(w - 2 * bw, 0)  # sum of bmask
    level_on = 1.0 if n_interior > 0 else 0.0
    num_valid = max(b * c * n_interior, 1.0)
    pmask = bmask[None, :, :, None]

    if cfg.photometric == "census":
        # the neighbourhoods reach window // 2 pixels: the mask widens so
        # that edge-replicated descriptor components never enter
        cmask = border_mask(h, w, cfg.border_ratio,
                            min_width=cfg.census_window // 2,
                            device=inputs.device)[None, :, :, None]
        cmask = cmask.expand(b, h, w, 1)
        vis = cmask if occ_mask is None else cmask * occ_mask
        dist = census_distance(census_transform(recon, cfg.census_window),
                               census_transform(inputs, cfg.census_window))
        photo = (dist * vis).sum() / torch.clamp(vis.sum(), min=1.0)
        if occ_mask is not None:
            # occluded pixels are not free (LossConfig.occ_penalty)
            photo = photo + cfg.occ_penalty * (
                (cmask * (1.0 - occ_mask)).sum()
                / torch.clamp(cmask.sum(), min=1.0))
    else:
        mask = pmask
        photo_norm = num_valid
        if occ_mask is not None:
            mask = pmask * occ_mask
            photo_norm = torch.clamp(c * mask.sum(), min=1.0)
        ele = charbonnier(255.0 * (recon - inputs), cfg.epsilon,
                          cfg.alpha_c) * mask
        if gmask is not None:
            # the normaliser stays the pixel count: the weight reduces
            # the sum only
            ele = ele * gmask
        photo = ele.sum() / photo_norm
        if occ_mask is not None:
            photo = photo + cfg.occ_penalty * (
                (pmask * (1.0 - occ_mask)).sum()
                / max(b * n_interior, 1.0))

    sflow = scaled if cfg.smooth_scaled_flow else flow
    diff_x, diff_y, mx, my = _smoothness_diffs(cfg, h, w, inputs.device)
    if cfg.smoothness == "canonical":
        # x-difference of U masked at the last column, y-difference of V
        # at the last row; optionally the border mask too, before the
        # power
        du = diff_x(sflow[..., 0:1]) * mx
        dv = diff_y(sflow[..., 1:2]) * my
        if smooth_border_mask:
            du = du * pmask
            dv = dv * pmask
        ele_u = charbonnier(du, cfg.epsilon, cfg.alpha_s)
        ele_v = charbonnier(dv, cfg.epsilon, cfg.alpha_s)
        if gmask is not None:
            ele_u = ele_u * (1.0 - gmask)
            ele_v = ele_v * (1.0 - gmask)
        u_loss = ele_u.sum() / num_valid
        v_loss = ele_v.sum() / num_valid
    else:  # depthwise
        gx = diff_x(sflow)  # (B, h, w, 2): dU/dx, dV/dx
        gy = diff_y(sflow)
        u_delta = torch.stack([gx[..., 0] * mx[..., 0],
                               gy[..., 0] * my[..., 0]], dim=-1)
        v_delta = torch.stack([gx[..., 1] * mx[..., 0],
                               gy[..., 1] * my[..., 0]], dim=-1)
        ele_u = charbonnier(u_delta, cfg.epsilon, cfg.alpha_s)
        ele_v = charbonnier(v_delta, cfg.epsilon, cfg.alpha_s)
        if cfg.edge_aware:
            emask = torch.cat(_edge_aware_masks(inputs), dim=-1)
            ele_u = ele_u * emask
            ele_v = ele_v * emask
        if gmask is not None:
            # one magnitude mask for both directions, unlike edge_aware's
            # directional ones
            ele_u = ele_u * (1.0 - gmask)
            ele_v = ele_v * (1.0 - gmask)
        num_valid_flow = num_valid / 3.0 * 2.0
        u_loss = (ele_u * pmask).sum() / num_valid_flow
        v_loss = (ele_v * pmask).sum() / num_valid_flow
    u_loss = u_loss * level_on
    v_loss = v_loss * level_on
    total = photo + cfg.lambda_smooth * (u_loss + v_loss)
    return ({"total": total, "Charbonnier_reconstruct": photo,
             "U_loss": u_loss, "V_loss": v_loss, "smooth": u_loss + v_loss},
            recon)


def check_loss_multi(cfg: LossConfig) -> None:
    """Raise on the settings the volume loss cannot honour, as the JAX
    package's `loss_interp_multi` does (`photometric.py:345-365`)."""
    if cfg.edge_aware_photo:
        raise ValueError(
            "loss.edge_aware_photo is two-frame only (the reference's "
            "needImageGradients exists only in the vgg 2-frame variant); "
            "the multi-frame volume loss would silently skip it")
    if cfg.edge_aware:
        raise ValueError(
            "loss.edge_aware is two-frame depthwise only "
            "(`version1/model/warpflow.py:93-157`); the multi-frame volume "
            "loss would silently skip the Sobel smoothness weighting")
    if cfg.occlusion:
        raise ValueError(
            "loss.occlusion=true is unsupported by the multi-frame volume "
            "loss (no backward flows per pair); the masking would be "
            "silently skipped")
    if cfg.smoothness != "canonical":
        raise ValueError(
            f"loss.smoothness={cfg.smoothness!r} is unsupported by the "
            "multi-frame volume loss, whose per-pair smoothness shape is "
            "fixed by the reference (`sintelWrapFlow.py:565-600`); use "
            "'canonical'")
    if cfg.photometric not in ("charbonnier", "census"):
        raise ValueError(f"unknown photometric variant {cfg.photometric!r}")


def loss_interp_multi(flows: torch.Tensor, volume: torch.Tensor,
                      flow_scale: float, cfg: LossConfig,
                      scaled: torch.Tensor | None = None,
                      recon: torch.Tensor | None = None
                      ) -> tuple[LossDict, torch.Tensor]:
    """T-frame volume loss at one scale. flows: (B, h, w, 2(T-1)) raw
    head output, (u, v) per pair; volume: (B, h, w, 3T) LRN-normalised
    frames, stacked frame-major. Frame t is reconstructed from frame t+1
    with flow pair t; the photometric term covers all T-1
    reconstructions (Charbonnier, or the soft census distance of each
    reconstruction against its frame, the pairs folded into the batch,
    under the census border mask), and each pair's U (x-difference) and V
    (y-difference) smoothness has the border mask applied before the
    power. Every term is normalised by B * 3 * (T-1) * interior.
    Returns (loss dict, reconstructions (B, h, w, 3(T-1))). Raises the
    JAX package's ValueErrors (`check_loss_multi`).

    `scaled` (flows * flow_scale) and `recon` (the volume warped by it)
    are computed here unless given: `pyramid_loss_multi` warps every
    level in one launch and passes both."""
    check_loss_multi(cfg)
    b, h, w, c3t = volume.shape
    t = c3t // 3
    if scaled is None:
        scaled = flows * flow_scale
    if recon is None:
        recon = backward_warp_volume(warp_operand(volume, cfg), scaled,
                                     impl=cfg.warp_impl).to(volume.dtype)

    bmask = border_mask(h, w, cfg.border_ratio, device=volume.device)
    bw = _border_width(h, cfg.border_ratio)
    n_interior = max(h - 2 * bw, 0) * max(w - 2 * bw, 0)  # sum of bmask
    level_on = 1.0 if n_interior > 0 else 0.0
    num_valid = max(b * 3 * (t - 1) * n_interior, 1.0)
    bflow = bmask[None, :, :, None]

    if cfg.photometric == "census":
        cmask = border_mask(h, w, cfg.border_ratio,
                            min_width=cfg.census_window // 2,
                            device=volume.device)[None, :, :, None]
        rec_f = (recon.reshape(b, h, w, t - 1, 3).permute(0, 3, 1, 2, 4)
                 .reshape(b * (t - 1), h, w, 3))
        src_f = (volume[..., :3 * (t - 1)].reshape(b, h, w, t - 1, 3)
                 .permute(0, 3, 1, 2, 4).reshape(b * (t - 1), h, w, 3))
        dist = census_distance(census_transform(rec_f, cfg.census_window),
                               census_transform(src_f, cfg.census_window))
        vis = cmask.expand(dist.shape)
        photo = (dist * vis).sum() / torch.clamp(vis.sum(), min=1.0)
    else:
        diff = 255.0 * (recon - volume[..., :3 * (t - 1)])
        photo = (charbonnier(diff, cfg.epsilon, cfg.alpha_c) * bflow).sum() \
            / num_valid

    sflow = scaled if cfg.smooth_scaled_flow else flows
    diff_x, diff_y, mx, my = _smoothness_diffs(cfg, h, w, volume.device)
    du = diff_x(sflow[..., 0::2]) * mx * bflow  # (B, h, w, T-1)
    dv = diff_y(sflow[..., 1::2]) * my * bflow
    u_loss = charbonnier(du, cfg.epsilon, cfg.alpha_s).sum() / num_valid \
        * level_on
    v_loss = charbonnier(dv, cfg.epsilon, cfg.alpha_s).sum() / num_valid \
        * level_on
    total = photo + cfg.lambda_smooth * (u_loss + v_loss)
    return ({"total": total, "Charbonnier_reconstruct": photo,
             "U_loss": u_loss, "V_loss": v_loss, "smooth": u_loss + v_loss},
            recon)
