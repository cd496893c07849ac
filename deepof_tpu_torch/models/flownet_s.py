"""FlowNet-Simple flow model (port of `deepof_tpu/models/flownet_s.py`).

10-conv contracting trunk, ELU activations, 6 pyramid heads with flow
scales 20/2^k, decoder deconvs of widths 512/256/128/64/32.

Input: preprocessed image pair concatenated on channels, NCHW
(B, 6, H, W). Output: list of flow predictions finest-first, in `dtype`
(the convolutions' compute dtype; parameters stay float32).

`forward(x, spatial)` with a `parallel.spatial.SpatialGroup` runs the
row-sharded model (spatial context parallelism; the caller has checked
the gate, `spatial_cp_active`): every rank of the group holds the whole
input, computes its block of each level's rows, and each level's flow
leaves the model gathered to full height for the loss.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.spatial import Rows, SpatialGroup, all_rows, levels
from .common import (FlowDecoder, add_flownet_trunk, flownet_trunk,
                     scaled_width)

FLOW_SCALES = (10.0, 5.0, 2.5, 1.25, 0.625, 0.3125)  # finest (pr1) first


class FlowNetS(nn.Module):
    flow_scales = FLOW_SCALES
    max_downsample = 64  # six stride-2 stages

    def __init__(self, flow_channels: int = 2, width_mult: float = 1.0,
                 in_channels: int | None = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow_channels = flow_channels
        self.width_mult = width_mult
        self.dtype = dtype
        # T frames of 3 channels give 2(T-1) flow channels; flax infers
        # the width from the input, so a stage over another input (the
        # FlowNet-CS refinement stage's 12 channels) names it
        if in_channels is None:
            in_channels = 3 * (flow_channels // 2 + 1)
        taps = add_flownet_trunk(self, in_channels, width_mult, dtype=dtype)
        self.decoder = FlowDecoder(
            taps[::-1],
            tuple(scaled_width(f, width_mult) for f in (512, 256, 128, 64, 32)),
            flow_channels, dtype)

    def forward(self, x: torch.Tensor,
                spatial: SpatialGroup | None = None) -> list[torch.Tensor]:
        if spatial is None:
            taps = flownet_trunk(self, x)
            return self.decoder(taps[::-1])[::-1]  # finest first
        rows = Rows(spatial, x.shape[-2], whole=True)
        taps = flownet_trunk(self, x, rows=rows)
        lv = levels(rows, 6)  # the taps' levels, finest first
        flows = self.decoder(taps[::-1], lv[::-1])[::-1]
        return [all_rows(f, r) for f, r in zip(flows, lv)]
