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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import ConvELU, FlowDecoder, _same_pad

FLOW_SCALES = (10.0, 5.0, 2.5, 1.25, 0.625)  # finest (pr1) first

#: (features, convs) of each block
_VGG_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

#: the trunk's conv names in order (the public npz's layer order)
VGG_CONVS = tuple(f"conv{b}_{i}" for b, (_, n) in enumerate(_VGG_CFG, 1)
                  for i in range(1, n + 1))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2, stride 2, SAME: flax's pad (low 0, high 1 at an odd size),
    with -inf."""
    ph = _same_pad(x.shape[-2], 2, 2)
    pw = _same_pad(x.shape[-1], 2, 2)
    if any(ph) or any(pw):
        x = F.pad(x, (*pw, *ph), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


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

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        pools = []
        for block, (_, n) in enumerate(_VGG_CFG, start=1):
            for i in range(1, n + 1):
                x = getattr(self, f"conv{block}_{i}")(x)
            x = _max_pool(x)
            pools.append(x)
        return pools


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

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.decoder(self.encoder(x)[::-1])[::-1]
