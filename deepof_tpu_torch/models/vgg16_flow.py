"""VGG16-backbone flow model (port of `deepof_tpu/models/vgg16_flow.py`),
the model of the `flyingchairs_vgg` preset.

Trunk: the 13 3x3 ELU convs of VGG16 (`_VGG_CFG`), each block ended by a
2x2/2 max-pool. Head: five pyramid levels on pool5..pool1 (512 / 512 /
256 / 128 / 64 channels), decoder deconvs of widths 256/128/64/32, flow
scales finest first 10 / 5 / 2.5 / 1.25 / 0.625. The finest flow is at
H/2. VGG16 has no width knob: its convs are always full width.

The module names are flax's (`encoder.conv1_1.conv.weight` is
`encoder/conv1_1/Conv_0/kernel`, `decoder.pr5...`), so `convert.py`
maps a flax tree one to one and `common.load_vgg16_npz` finds the trunk
under `encoder`. flax's `max_pool(2x2, stride 2, SAME)` pads an odd size
high by one with -inf (F1): `_max_pool`.

Tensors are NCHW; the input is the pair (B, 6, H, W).

`forward(x, spatial)` with a `parallel.spatial.SpatialGroup` runs it
row-sharded (spatial context parallelism; the caller has checked the
gate): every rank holds the whole input, each conv and pool computes
this rank's rows of its level (H, then H/2 ... H/32 after each pool),
and each level's flow leaves gathered to full height.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.spatial import Rows, SpatialGroup, all_rows, levels
from .common import ConvELU, FlowDecoder, max_pool

FLOW_SCALES = (10.0, 5.0, 2.5, 1.25, 0.625)  # finest (pr1) first

#: (features, convs) of each block
_VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

#: the trunk's conv names in order (the public npz's layer order)
VGG_CONVS = tuple(f"conv{b}_{i}" for b, (_, n) in enumerate(_VGG_CFG, 1)
                  for i in range(1, n + 1))


def _max_pool(x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """2x2, stride 2, SAME: flax's pad (low 0, high 1 at an odd size),
    with -inf. `rows`: row-sharded (`common.max_pool`)."""
    return max_pool(x, 2, 2, rows)


def vgg_pools(trunk: nn.Module, x: torch.Tensor, rows: Rows | None = None,
              act=None) -> list[torch.Tensor]:
    """[pool1..pool5] of a VGG16 trunk: its convs `conv{block}_{i}`
    (`_VGG_CFG`), each followed by `act` where given, each block ended by
    `_max_pool`. `rows`: x's level (the whole input); the pools are then
    this rank's blocks of `levels(rows, 5)`."""
    pools = []
    lv = [None] * 5 if rows is None else levels(rows, 5)
    for block, (_, n) in enumerate(_VGG_CFG, start=1):
        for i in range(1, n + 1):
            x = getattr(trunk, f"conv{block}_{i}")(x, rows)
            if act is not None:
                x = act(x)
            rows = rows and rows.down(1)  # this rank's block
        x = _max_pool(x, rows)
        pools.append(x)
        rows = lv[block - 1]
    return pools


class VGG16Trunk(nn.Module):
    """conv1_1..conv5_3 + pools; returns [pool1..pool5]."""

    def __init__(self, cin: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.widths = []
        for block, (feat, n) in enumerate(_VGG_CFG, start=1):
            for i in range(1, n + 1):
                setattr(self, f"conv{block}_{i}",
                        ConvELU(cin, feat, dtype=dtype))
                cin = feat
            self.widths.append(feat)

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> list[torch.Tensor]:
        """`rows`: row-sharded (`vgg_pools`)."""
        return vgg_pools(self, x, rows)


class VGG16Flow(nn.Module):
    flow_scales = FLOW_SCALES
    max_downsample = 32  # five max-pools

    def __init__(self, flow_channels: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow_channels = flow_channels
        # the pair, or a T-frame volume with flow_channels = 2(T-1)
        self.encoder = VGG16Trunk(3 * (flow_channels // 2 + 1), dtype)
        self.decoder = FlowDecoder(self.encoder.widths[::-1],
                                   (256, 128, 64, 32), flow_channels, dtype)

    def forward(self, x: torch.Tensor,
                spatial: SpatialGroup | None = None) -> list[torch.Tensor]:
        if spatial is None:
            return self.decoder(self.encoder(x)[::-1])[::-1]
        rows = Rows(spatial, x.shape[-2], whole=True)
        lv = levels(rows, 5)  # the pools' levels, finest first
        flows = self.decoder(self.encoder(x, rows)[::-1], lv[::-1])[::-1]
        return [all_rows(f, r) for f, r in zip(flows, lv)]
