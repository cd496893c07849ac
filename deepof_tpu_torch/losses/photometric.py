"""Photometric + smoothness loss at one pyramid scale (port of the
default branch of `deepof_tpu/losses/photometric.py::loss_interp`:
Charbonnier photometric term, canonical smoothness of order 1 or 2, an
optional border mask on the smoothness term, no occlusion; and of
`loss_interp_multi`, its T-frame volume form). Tensors are NHWC, as in
the JAX package. Loss dict keys mirror the reference: total /
Charbonnier_reconstruct / U_loss / V_loss, plus smooth = U + V.

Kept exactly, for numeric parity (F5):
  - the Charbonnier normaliser is the count of border-mask-interior
    *image* elements, B * C * interior, reused for the smoothness terms;
  - masks multiply the difference *before* the Charbonnier power, so a
    masked pixel still adds (eps^2)^alpha;
  - the photometric difference is scaled by 255 before the power;
  - a level whose border mask has no interior (h <= 2 at ratio 0.1)
    contributes exactly 0 to both terms.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core.config import LossConfig
from ..ops.smoothness import (forward_diff_x, forward_diff_y, second_diff_x,
                              second_diff_y)
from ..ops.warp import backward_warp, backward_warp_volume

LossDict = dict[str, Any]


def charbonnier(x: torch.Tensor, eps: float, alpha: float) -> torch.Tensor:
    """(x^2 + eps^2)^alpha, the generalised Charbonnier penalty."""
    return torch.pow(x.square() + eps * eps, alpha)


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


def loss_interp(flow: torch.Tensor, inputs: torch.Tensor,
                outputs: torch.Tensor, flow_scale: float, cfg: LossConfig,
                smooth_border_mask: bool = False,
                scaled: torch.Tensor | None = None,
                recon: torch.Tensor | None = None
                ) -> tuple[LossDict, torch.Tensor]:
    """flow: (B, h, w, 2) raw head output; inputs/outputs: (B, h, w, C)
    LRN-normalised previous/next frames resized to this scale. Returns
    (loss dict, reconstructed previous frame). `cfg` is taken as checked
    (`core.config.check_loss`, which `pyramid_loss` runs).

    `scaled` (flow * flow_scale) and `recon` (`outputs` warped by it) are
    computed here unless given: `pyramid_loss` warps every level in one
    launch and passes both."""
    b, h, w, c = inputs.shape
    if scaled is None:
        scaled = flow * flow_scale
    if recon is None:
        recon = backward_warp(outputs, scaled, impl=cfg.warp_impl)

    bmask = border_mask(h, w, cfg.border_ratio, device=inputs.device)
    bw = _border_width(h, cfg.border_ratio)
    n_interior = max(h - 2 * bw, 0) * max(w - 2 * bw, 0)  # sum of bmask
    level_on = 1.0 if n_interior > 0 else 0.0
    num_valid = max(b * c * n_interior, 1.0)

    pmask = bmask[None, :, :, None]
    diff = 255.0 * (recon - inputs)
    photo = (charbonnier(diff, cfg.epsilon, cfg.alpha_c) * pmask).sum() \
        / num_valid

    sflow = scaled if cfg.smooth_scaled_flow else flow
    diff_x, diff_y, mx, my = _smoothness_diffs(cfg, h, w, inputs.device)
    # x-difference of U masked at the last column, y-difference of V at
    # the last row; optionally the border mask too, before the power
    du = diff_x(sflow[..., 0:1]) * mx
    dv = diff_y(sflow[..., 1:2]) * my
    if smooth_border_mask:
        du = du * pmask
        dv = dv * pmask
    u_loss = charbonnier(du, cfg.epsilon, cfg.alpha_s).sum() / num_valid
    v_loss = charbonnier(dv, cfg.epsilon, cfg.alpha_s).sum() / num_valid
    u_loss = u_loss * level_on
    v_loss = v_loss * level_on
    total = photo + cfg.lambda_smooth * (u_loss + v_loss)
    return ({"total": total, "Charbonnier_reconstruct": photo,
             "U_loss": u_loss, "V_loss": v_loss, "smooth": u_loss + v_loss},
            recon)


def check_loss_multi(cfg: LossConfig) -> None:
    """Raise on the settings the volume loss cannot honour, as the JAX
    package's `loss_interp_multi` does (`photometric.py:345-365`), and
    on census, which is not ported."""
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
    if cfg.photometric == "census":
        raise NotImplementedError(
            "loss.photometric='census' in the multi-frame volume loss is "
            "not ported to deepof_tpu_torch yet: ROADMAP Queue A item 9 "
            "(loss variants)")


def loss_interp_multi(flows: torch.Tensor, volume: torch.Tensor,
                      flow_scale: float, cfg: LossConfig,
                      scaled: torch.Tensor | None = None,
                      recon: torch.Tensor | None = None
                      ) -> tuple[LossDict, torch.Tensor]:
    """T-frame volume loss at one scale. flows: (B, h, w, 2(T-1)) raw
    head output, (u, v) per pair; volume: (B, h, w, 3T) LRN-normalised
    frames, stacked frame-major. Frame t is reconstructed from frame t+1
    with flow pair t; the Charbonnier photometric term covers all T-1
    reconstructions, and each pair's U (x-difference) and V
    (y-difference) smoothness has the border mask applied before the
    power. Every term is normalised by B * 3 * (T-1) * interior.
    Returns (loss dict, reconstructions (B, h, w, 3(T-1))). `cfg` is
    taken as checked (`check_loss_multi`).

    `scaled` (flows * flow_scale) and `recon` (the volume warped by it)
    are computed here unless given: `pyramid_loss_multi` warps every
    level in one launch and passes both."""
    b, h, w, c3t = volume.shape
    t = c3t // 3
    if scaled is None:
        scaled = flows * flow_scale
    if recon is None:
        recon = backward_warp_volume(volume, scaled, impl=cfg.warp_impl)

    bmask = border_mask(h, w, cfg.border_ratio, device=volume.device)
    bw = _border_width(h, cfg.border_ratio)
    n_interior = max(h - 2 * bw, 0) * max(w - 2 * bw, 0)  # sum of bmask
    level_on = 1.0 if n_interior > 0 else 0.0
    num_valid = max(b * 3 * (t - 1) * n_interior, 1.0)
    bflow = bmask[None, :, :, None]

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
