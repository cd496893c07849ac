"""FlowNet-CS, stacked flow refinement (port of `FlowNetCS` and
`refinement_inputs` in `deepof_tpu/models/flownet2.py`; FlowNet 2.0,
arXiv:1612.01925 §3).

A FlowNet-C base estimate is upsampled to input resolution, frame 2 is
warped backward by it (`ops/warp.py`, the loss's warp: on the card the
CUDA warp and flow-gradient kernels), and a FlowNet-S refinement stage
reads [img1, img2, warped img2, flow, brightness error], 12 channels, to
predict the pyramid. The whole stack trains end to end: the gradient
reaches the base stage through the warp's flow input. 2-frame only.

Parameters are scoped `base` (the FlowNetC) and `refine` (the
FlowNetS), as in the flax module, so `convert.load_flax_params` loads a
JAX FlowNetCS tree unchanged.

`forward(pair, spatial)` with a `parallel.spatial.SpatialGroup` runs
FlowNet-CS row-sharded (spatial context parallelism; the caller has
checked the gate): the base FlowNet-C runs row-sharded and hands back
its flows gathered to full height; the x2 upsample and the refinement
input (the warp kernel) are computed on those full-height operands on
every spatial rank, as the correlation is on gathered rows; the
refinement FlowNet-S then runs row-sharded from that whole input, each
rank's first convs reading only their rows of it, so each rank's
cotangent of the refinement input is its own rows' part and the base
stage's gather sums them back to the owners.

`FlowNetRefine` is the refinement stage standalone: it takes a prior flow
from the caller instead of running a base network. Serving's temporal
warm start (`serve/engine.py::submit_next`) feeds it the previous video
frame's flow. Tensors are NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.warp import backward_warp_nchw
from ..parallel.spatial import SpatialGroup
from .flownet_c import FlowNetC
from .flownet_s import FLOW_SCALES, FlowNetS


def refinement_inputs(img1: torch.Tensor, img2: torch.Tensor,
                      flow: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The stacked refinement input, NCHW: [img1, img2, warp(img2, flow),
    flow, brightness error], (B, 12, H, W). `flow` (B, 2, H, W) is at
    input resolution in input pixels (its scale applied); the error is
    sqrt(sum over channels of (img1 - warped)^2 + 1e-12). The warp and
    the error are computed in float32 from the upcast images; the
    warped image, the flow and the error are then cast to `dtype`, and
    `torch.cat` promotes as `jnp.concatenate` does: bf16 images (the
    training input under `train.compute_dtype`) give a bf16 stack,
    float32 images (eval) a float32 one."""
    warped = backward_warp_nchw(img2.float(), flow)
    err = torch.sqrt(torch.sum(torch.square(img1.float() - warped), dim=1,
                               keepdim=True) + 1e-12)
    return torch.cat([img1, img2, warped.to(dtype), flow.to(dtype),
                      err.to(dtype)], dim=1)


def _up2(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bilinear x2 along `dim` with half-pixel centres and the edge
    clamped: output 2i is 0.75 x[i] + 0.25 x[i-1], output 2i+1 is
    0.75 x[i] + 0.25 x[i+1]. Slices, concatenations and elementwise
    products only, so its backward adds in a fixed order."""
    n = x.shape[dim]
    prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim)
    nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim)
    return torch.stack([0.75 * x + 0.25 * prev, 0.75 * x + 0.25 * nxt],
                       dim + 1).flatten(dim, dim + 1)


def upsample_flow(flow: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """The base stage's finest flow (B, 2, h, w), in its own pixels, at
    input resolution `hw` in input pixels: bilinear with half-pixel
    centres, vectors times 2. `jax.image.resize` antialiases only when it
    shrinks, so this matches it (F2).

    At exactly twice the size (every even input) the upsample is written
    out with fixed weights (`_up2`): `F.interpolate`'s CUDA backward adds
    with atomics, so a FlowNet-CS step through it is not bitwise
    repeatable (F15)."""
    h, w = flow.shape[-2:]
    if tuple(hw) == (2 * h, 2 * w):
        return _up2(_up2(flow, 2), 3) * 2.0
    return F.interpolate(flow, size=hw, mode="bilinear",
                         align_corners=False) * 2.0


class FlowNetCS(nn.Module):
    flow_scales = FLOW_SCALES
    max_downsample = 64

    def __init__(self, flow_channels: int = 2, max_disp: int = 20,
                 corr_stride: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        if flow_channels != 2:
            raise ValueError(
                "FlowNetCS is a 2-frame model (6 input channels, 2 flow "
                f"channels); got {flow_channels} flow channels")
        self.flow_channels = flow_channels
        self.max_disp = max_disp
        self.corr_stride = corr_stride
        self.dtype = dtype
        self.base = FlowNetC(flow_channels=2, max_disp=max_disp,
                             corr_stride=corr_stride, dtype=dtype)
        self.refine = FlowNetS(flow_channels=2, in_channels=12, dtype=dtype)

    def forward(self, pair: torch.Tensor,
                spatial: SpatialGroup | None = None) -> list[torch.Tensor]:
        if pair.shape[1] != 6:
            raise ValueError("FlowNetCS is a 2-frame model (6 input "
                             f"channels); got input {pair.shape[1]}ch")
        # the finest base level lives at half resolution; it is upsampled
        # in float32 (gathered to full height under `spatial`)
        flow = self.base(pair, spatial)[0].float() * self.flow_scales[0]
        flow = upsample_flow(flow, tuple(pair.shape[-2:]))
        return self.refine(refinement_inputs(pair[:, :3], pair[:, 3:], flow,
                                             self.dtype), spatial)


class FlowNetRefine(nn.Module):
    """The FlowNet-CS refinement stage standalone (the JAX package's
    `FlowNetRefine`): (pair (B, 6, H, W), prior (B, 2, h, w)) -> refined
    pyramid, finest first, no base network.

    `prior` is a previous dispatch's raw finest output,
    `flows[0] * flow_scales[0]`, on the finest head grid. It is upsampled
    x2 to input resolution for the warp, as FlowNetCS upsamples its base
    estimate. The inner FlowNetS is scoped `refine`, so:

      residual=False: the stage predicts the flow directly (FlowNetCS
          semantics); a FlowNet-CS model's `refine` weights load as they
          are;
      residual=True: each level is `gate * stage + prior` at that level,
          with the scalar `gate` initialised to zero. At the finest level
          the prior is used on its own grid; at the coarser ones it is
          resized with antialiasing (`jax.image.resize` antialiases when
          it shrinks, F2) and its vectors rescaled to the level's pixels.
    """

    flow_scales = FLOW_SCALES
    max_downsample = 64

    def __init__(self, flow_channels: int = 2, width_mult: float = 1.0,
                 residual: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        if flow_channels != 2:
            raise ValueError(
                "FlowNetRefine is a 2-frame stage (6 input channels, 2 flow "
                f"channels); got {flow_channels} flow channels")
        self.flow_channels = flow_channels
        self.width_mult = width_mult
        self.residual = residual
        self.dtype = dtype
        self.refine = FlowNetS(flow_channels=2, width_mult=width_mult,
                               in_channels=12, dtype=dtype)
        if residual:
            self.gate = nn.Parameter(torch.zeros(()))

    def forward(self, pair: torch.Tensor,
                prior: torch.Tensor) -> list[torch.Tensor]:
        if pair.shape[1] != 6:
            raise ValueError("FlowNetRefine is a 2-frame stage (6 input "
                             f"channels); got input {pair.shape[1]}ch")
        if prior.dim() != 4 or prior.shape[1] != 2 \
                or prior.shape[0] != pair.shape[0]:
            raise ValueError(f"prior flow must be (B, 2, h, w); got "
                             f"{tuple(prior.shape)} for pair "
                             f"{tuple(pair.shape)}")
        ph, pw = prior.shape[-2:]
        prior = prior.float()
        flow = upsample_flow(prior, tuple(pair.shape[-2:]))
        flows = self.refine(refinement_inputs(pair[:, :3], pair[:, 3:], flow,
                                              self.dtype))
        if not self.residual:
            return flows
        gate = self.gate.float()
        out = []
        for k, f in enumerate(flows):
            hk, wk = f.shape[-2:]
            if (hk, wk) == (ph, pw):
                p = prior / self.flow_scales[k]
            else:
                p = F.interpolate(prior, size=(hk, wk), mode="bilinear",
                                  align_corners=False, antialias=True)
                p = p * (torch.tensor([wk / pw, hk / ph],
                                      device=p.device).view(1, 2, 1, 1)
                         / self.flow_scales[k])
            out.append(gate * f.float() + p)
        return out
