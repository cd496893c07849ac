"""Multi-scale pyramid loss (port of `deepof_tpu/losses/pyramid.py`): the
two-frame `pyramid_loss`, with the backward-flow pyramid of the
occlusion option, and the T-frame volume `pyramid_loss_multi`.

  - preprocessing: BGR dataset-mean subtraction and /255 scaling, and the
    LRN copy used only inside the photometric loss;
  - resizing the LRN images to every pyramid level;
  - the warp of every level's resized next frame by its scaled flow, in
    one call (`backward_warp_levels`: one launch of each kernel on the
    card); for a volume, of every level's T-1 next frames, folded into
    the batch (`ops/warp.py::fold_pairs`), in that same one call; under
    `loss.gather_dtype="bfloat16"` the warped images are bf16 and each
    level takes the JAX package's route for it (`ops/warp.py`), the
    result cast back to the input dtype;
  - under `loss.occlusion`, the backward flows of every level warped by
    the forward ones in one more launch of the forward kernel (C = 2,
    no gradient: the mask ends in a comparison), for `occlusion_mask`;
  - per-level `loss_interp` and the weighted total, weights finest first.

The resize is `jax.image.resize(..., "bilinear")`, whose default is
`antialias=True`: every downsampled level is antialiased. PyTorch's
bilinear interpolation with half-pixel centres and `antialias=True` is
the same filter (hazard F2 in ROADMAP.md). This is not the serving
resize (`data/datasets.py::_resize`, no antialiasing, as cv2 does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import LossConfig, check_loss
from ..ops.lrn import local_response_normalization
from ..ops.warp import (backward_warp_levels, fold_pairs, unfold_pairs,
                        warp_levels_forward)
from .photometric import (LossDict, check_loss_multi, loss_interp,
                          loss_interp_multi, occlusion_mask, warp_operand)


def preprocess(images: torch.Tensor, mean) -> torch.Tensor:
    """(images - BGR mean) / 255, the network input scaling (NHWC)."""
    return (images - torch.as_tensor(mean, dtype=images.dtype,
                                     device=images.device)) / 255.0


def lrn_normalize(scaled: torch.Tensor) -> torch.Tensor:
    """LRN copy of preprocessed images for the photometric loss."""
    return local_response_normalization(scaled, depth_radius=4, beta=0.7)


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C), bilinear with antialiasing."""
    if img.shape[1] == h and img.shape[2] == w:
        return img
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(h, w),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def occlusion_masks(scaled: list[torch.Tensor],
                    flow_pyramid_bw: list[torch.Tensor],
                    scales: list[float], cfg: LossConfig
                    ) -> list[torch.Tensor]:
    """The occlusion mask of every level (`occlusion_mask`): scaled
    forward flows, raw backward flows and their scales; the backward
    flows of all levels are warped in one launch."""
    with torch.no_grad():
        fw = [f.detach() for f in scaled]
        bw = [f.detach() * s for f, s in zip(flow_pyramid_bw, scales)]
        warped = warp_levels_forward(bw, fw, cfg.warp_impl,
                                     site="occlusion")
        return [occlusion_mask(f, b, cfg, bw_at_fw=w)
                for f, b, w in zip(fw, bw, warped)]


def pyramid_loss(flow_pyramid: list[tuple[torch.Tensor, float]],
                 inputs_norm: torch.Tensor, outputs_norm: torch.Tensor,
                 cfg: LossConfig, smooth_border_mask: bool = False,
                 flow_pyramid_bw: list[torch.Tensor] | None = None
                 ) -> tuple[torch.Tensor, list[LossDict], torch.Tensor]:
    """flow_pyramid: [(flow_k (B, h, w, 2), flow_scale_k)] finest first.
    flow_pyramid_bw: optional matching backward flows (raw head outputs
    of the swapped pair, same scales), which turn on the per-level
    occlusion masking of the photometric term.

    Returns (weighted total, per-level loss dicts finest first, finest
    reconstruction). Raises on a loss setting of no known value and on
    the JAX package's bad pairings."""
    check_loss(cfg)
    sizes = [flow.shape[1:3] for flow, _ in flow_pyramid]
    scaled = [flow * scale for flow, scale in flow_pyramid]
    targets = [_resize(outputs_norm, h, w) for h, w in sizes]
    occ = [None] * len(sizes)
    if flow_pyramid_bw is not None:
        occ = occlusion_masks(scaled, flow_pyramid_bw,
                              [s for _, s in flow_pyramid], cfg)
    # every level in one launch of each warp kernel, of the loss's
    # gather dtype; the warped images come back in the input dtype
    recons = [r.to(inputs_norm.dtype) for r in backward_warp_levels(
        [warp_operand(t, cfg) for t in targets], scaled, impl=cfg.warp_impl)]
    losses: list[LossDict] = []
    total = torch.zeros((), device=inputs_norm.device)
    for k, (flow, scale) in enumerate(flow_pyramid):
        h, w = sizes[k]
        ld, _ = loss_interp(flow, _resize(inputs_norm, h, w), targets[k],
                            scale, cfg, smooth_border_mask, occ_mask=occ[k],
                            scaled=scaled[k], recon=recons[k])
        losses.append(ld)
        weight = cfg.weights[k] if k < len(cfg.weights) else cfg.weights[-1]
        total = total + weight * ld["total"]
    return total, losses, recons[0]


def pyramid_loss_multi(flow_pyramid: list[tuple[torch.Tensor, float]],
                       volume_norm: torch.Tensor, cfg: LossConfig,
                       pairs: tuple[int, int] | None = None
                       ) -> tuple[torch.Tensor, list[LossDict], torch.Tensor]:
    """The T-frame volume pyramid loss. flow_pyramid: [(flows_k
    (B, h, w, 2(T-1)), flow_scale_k)] finest first; volume_norm:
    (B, H, W, 3T) LRN-normalised frames, resized (with antialiasing) to
    each level. Every level's T-1 frame pairs are warped in one call of
    `backward_warp_levels`. Returns (weighted total, per-level loss
    dicts finest first, finest reconstructions (B, h, w, 3(T-1))).

    `pairs` (temporal pair parallelism over `mesh.time`): this rank's
    block [lo, hi) of the folded pair axis. Only the block's pairs are
    warped (one launch of each kernel over the block at every level) and
    the loss is this rank's share (`loss_interp_multi`); the finest
    reconstructions are then the block's, folded (hi - lo, h, w, 3)."""
    check_loss_multi(cfg)  # the JAX package's ValueErrors first
    check_loss(cfg)
    b = volume_norm.shape[0]
    vols = [_resize(volume_norm, *flow.shape[1:3])
            for flow, _ in flow_pyramid]
    scaled = [flow * scale for flow, scale in flow_pyramid]
    folded = [fold_pairs(warp_operand(v, cfg), s)
              for v, s in zip(vols, scaled)]
    if pairs is not None:
        folded = [(nxt[pairs[0]:pairs[1]], flw[pairs[0]:pairs[1]])
                  for nxt, flw in folded]
    recons = [r.to(volume_norm.dtype) for r in backward_warp_levels(
        [nxt for nxt, _ in folded], [flw for _, flw in folded],
        impl=cfg.warp_impl)]
    losses: list[LossDict] = []
    total = torch.zeros((), device=volume_norm.device)
    recon_finest = None
    for k, (flow, scale) in enumerate(flow_pyramid):
        recon = recons[k] if pairs is not None else unfold_pairs(recons[k], b)
        ld, _ = loss_interp_multi(flow, vols[k], scale, cfg,
                                  scaled=scaled[k], recon=recon, pairs=pairs)
        losses.append(ld)
        if k == 0:
            recon_finest = recon
        weight = cfg.weights[k] if k < len(cfg.weights) else cfg.weights[-1]
        total = total + weight * ld["total"]
    return total, losses, recon_finest
