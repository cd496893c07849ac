"""FlowNet-Correlation flow model (port of `deepof_tpu/models/flownet_c.py`).

Siamese conv1..conv3 towers (one set of modules, shared weights) over
each preprocessed frame, the multiplicative correlation cost volume
(max displacement 20, stride 2 -> 441 maps) followed by ELU, a 1x1
`conv_redir` (32ch) of the first tower, then the FlowNet-S tail and
decoder with 6 pyramid heads. Every block computes in `dtype`, and so
does the cost volume and its ELU: the towers hand it `dtype` features.

`forward(pair, spatial)` with a `parallel.spatial.SpatialGroup` runs it
row-sharded (spatial context parallelism; the caller has checked the
gate): the towers and the rest compute this rank's rows of each level;
the correlation's displacement window crosses any split, so `f1` and
`f2` are gathered to full height, the cost volume is computed whole (the
kernel, unchanged, as the JAX partition rule keeps H whole) and this
rank keeps its rows; each level's flow leaves gathered to full height.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.corr import correlation_nchw
from ..parallel.spatial import Rows, SpatialGroup, all_rows, levels
from .common import (ConvELU, FlowDecoder, add_flownet_tail, flownet_tail,
                     scaled_width)
from .flownet_s import FLOW_SCALES


class FlowNetC(nn.Module):
    flow_scales = FLOW_SCALES
    max_downsample = 64

    def __init__(self, flow_channels: int = 2, max_disp: int = 20,
                 corr_stride: int = 2, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow_channels = flow_channels
        self.max_disp = max_disp
        self.corr_stride = corr_stride
        self.width_mult = width_mult
        self.dtype = dtype
        ch = lambda n: scaled_width(n, width_mult)  # noqa: E731
        self.conv1 = ConvELU(3, ch(64), (7, 7), 2, dtype=dtype)
        self.conv2 = ConvELU(ch(64), ch(128), (5, 5), 2, dtype=dtype)
        self.conv3 = ConvELU(ch(128), ch(256), (5, 5), 2, dtype=dtype)
        self.conv_redir = ConvELU(ch(256), ch(32), (1, 1), dtype=dtype)
        n = 2 * (max_disp // corr_stride) + 1
        self.conv3_1 = ConvELU(n * n + ch(32), ch(256), dtype=dtype)
        c4_2, c5_2, c6_2 = add_flownet_tail(self, ch(256), width_mult,
                                            dtype=dtype)
        self.decoder = FlowDecoder(
            (c6_2, c5_2, c4_2, ch(256), ch(128), ch(64)),
            tuple(ch(f) for f in (512, 256, 128, 64, 32)), flow_channels,
            dtype)

    def forward(self, pair: torch.Tensor,
                spatial: SpatialGroup | None = None) -> list[torch.Tensor]:
        b = pair.shape[0]
        rows, lv = None, [None] * 6
        if spatial is not None:
            rows = Rows(spatial, pair.shape[-2], whole=True)
            lv = levels(rows, 6)  # finest first: conv1's ... conv6's
        # both frames through the one tower in a single batch
        frames = torch.cat([pair[:, :3], pair[:, 3:]], dim=0)
        c1 = self.conv1(frames, rows)
        c2 = self.conv2(c1, lv[0])
        c3 = self.conv3(c2, lv[1])
        f1 = c3[:b]
        if spatial is None:
            corr = correlation_nchw(f1, c3[b:], self.max_disp,
                                    self.corr_stride)
        else:
            # both frames to full height in one gather; this rank's rows
            # of the whole cost volume
            g = all_rows(c3, lv[2])
            lo, hi = lv[2].block
            corr = correlation_nchw(g[:b], g[b:], self.max_disp,
                                    self.corr_stride)[..., lo:hi, :]
        net = torch.cat([F.elu(corr), self.conv_redir(f1, lv[2])], dim=1)
        conv3_1 = self.conv3_1(net, lv[2])
        conv4_2, conv5_2, conv6_2 = flownet_tail(self, conv3_1, rows=lv[2])
        flows = self.decoder([conv6_2, conv5_2, conv4_2, conv3_1, c2[:b],
                              c1[:b]], None if spatial is None else lv[::-1])
        if spatial is None:
            return flows[::-1]
        return [all_rows(f, r) for f, r in zip(flows[::-1], lv)]
