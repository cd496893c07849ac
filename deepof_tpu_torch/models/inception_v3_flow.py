"""Inception-v3-backbone flow model (port of
`deepof_tpu/models/inception_v3_flow.py`), the flagship model of the
`flyingchairs` and `sintel` presets.

Base: Inception-v3 with SAME padding everywhere and ReLU activations,
conv + bias only (no normalisation). Head: six pyramid levels tapped at
Conv2d_1a_3x3 / MaxPool_3a_3x3 / MaxPool_5a_3x3 / Mixed_5d / Mixed_6e /
Mixed_7c (32 / 64 / 192 / 288 / 768 / 2048 channels at full width), ELU
decoder deconvs of widths 512/256/128/64/32, and a stride-1 2x2 deconv
between the Mixed_5d and MaxPool_5a taps, which share a spatial size.
Flow scales finest first: 10 / 5 / 2.5 / 2.5 / 1.25 / 0.625. The finest
flow is at H/2.

The module names are flax's (`encoder.Mixed_5b.b0_1x1.conv.weight` is
`encoder/Mixed_5b/b0_1x1/Conv_0/kernel`), so `convert.py` maps a flax
tree one to one. SAME padding, each of which is a pixel shift if done
symmetrically (F1):
  - the convs pad as flax does, low total // 2 and the rest high
    (`common.ConvELU`), per axis for the 1x7, 7x1, 1x3 and 3x1 kernels;
  - `nn.max_pool(3x3, stride 2, SAME)` pads with -inf the same way (at
    an even size low 0, high 1): `_max_pool`;
  - `nn.avg_pool(3x3, stride 1, SAME)` counts the zero padding (flax's
    `count_include_pad=True`): a border pixel divides by 9.

Tensors are NCHW; the input is the pair (B, 6, H, W), or a T-frame
volume (B, 3T, H, W) with `flow_channels = 2(T-1)`.

`forward(x, spatial)` with a `parallel.spatial.SpatialGroup` runs it
row-sharded (spatial context parallelism; the caller has checked the
gate): every rank holds the whole input, and each conv, pool and block
computes this rank's rows of its level (`common.py`'s row-sharded
layers), the levels H/2, H/4, H/8, H/16 and H/32 of the stride-2 stem
convs, the stem's two max-pools and the Reduction blocks; each level's
flow leaves gathered to full height. The decoder's scale-1 deconv
between the two H/8 taps makes exactly the skip's block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import Rows, SpatialGroup, all_rows, levels
from .common import ConvELU, FlowDecoder, avg_pool, max_pool, scaled_width

FLOW_SCALES = (10.0, 5.0, 2.5, 2.5, 1.25, 0.625)  # finest (pr1) first


class _Conv(ConvELU):
    """conv + bias + ReLU, SAME padding; `features` scaled by
    `width_mult` (`out` is the scaled width)."""

    def __init__(self, cin: int, features: int,
                 kernel: tuple[int, int] = (1, 1), stride: int = 1,
                 dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        out = scaled_width(features, width_mult)
        super().__init__(cin, out, kernel, stride, dtype=dtype)
        self.out = out

    @staticmethod
    def activation(x: torch.Tensor) -> torch.Tensor:
        return F.relu(x)


def _avg_pool(x: torch.Tensor, rows: Rows | None = None) -> torch.Tensor:
    """3x3, stride 1, SAME, the zero padding counted (flax's default).
    `rows`: row-sharded (`common.avg_pool`)."""
    return avg_pool(x, rows)


def _max_pool(x: torch.Tensor, stride: int = 2,
              rows: Rows | None = None) -> torch.Tensor:
    """3x3, SAME: flax's asymmetric pad, with -inf. `rows`: row-sharded
    (`common.max_pool`)."""
    return max_pool(x, 3, stride, rows)


class _Block(nn.Module):
    """A block of `_Conv`s: `_conv(name, cin, features, kernel, stride)`
    registers one on its branch's input width and returns its own."""

    def __init__(self, dtype: torch.dtype, width_mult: float):
        super().__init__()
        self._kw = {"dtype": dtype, "width_mult": width_mult}

    def _conv(self, name: str, cin: int, features: int,
              kernel: tuple[int, int] = (1, 1), stride: int = 1) -> int:
        conv = _Conv(cin, features, kernel, stride, **self._kw)
        setattr(self, name, conv)
        return conv.out


class _InceptionA(_Block):
    """Mixed_5b/5c/5d: 1x1 + 5x5 + double-3x3 + pool-proj branches."""

    def __init__(self, cin: int, pool_features: int,
                 dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        super().__init__(dtype, width_mult)
        b0 = self._conv("b0_1x1", cin, 64)
        b1 = self._conv("b1_1x1", cin, 48)
        b1 = self._conv("b1_5x5", b1, 64, (5, 5))
        b2 = self._conv("b2_1x1", cin, 64)
        b2 = self._conv("b2_3x3a", b2, 96, (3, 3))
        b2 = self._conv("b2_3x3b", b2, 96, (3, 3))
        b3 = self._conv("b3_proj", cin, pool_features)
        self.out = b0 + b1 + b2 + b3

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        r = rows
        return torch.cat([
            self.b0_1x1(x, r),
            self.b1_5x5(self.b1_1x1(x, r), r),
            self.b2_3x3b(self.b2_3x3a(self.b2_1x1(x, r), r), r),
            self.b3_proj(_avg_pool(x, r), r)], dim=1)


class _ReductionA(_Block):
    """Mixed_6a: stride-2 reduction to 768."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        super().__init__(dtype, width_mult)
        b0 = self._conv("b0_3x3", cin, 384, (3, 3), 2)
        b1 = self._conv("b1_1x1", cin, 64)
        b1 = self._conv("b1_3x3a", b1, 96, (3, 3))
        b1 = self._conv("b1_3x3b", b1, 96, (3, 3), 2)
        self.out = b0 + b1 + cin

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        """`rows`: the result is this rank's block of `rows.down(2)`."""
        r = rows
        return torch.cat([self.b0_3x3(x, r),
                          self.b1_3x3b(self.b1_3x3a(self.b1_1x1(x, r), r),
                                       r),
                          _max_pool(x, rows=r)], dim=1)


class _InceptionB(_Block):
    """Mixed_6b..6e: factorized 7x7 branches, 768 out."""

    def __init__(self, cin: int, mid: int,
                 dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        super().__init__(dtype, width_mult)
        b0 = self._conv("b0_1x1", cin, 192)
        b1 = self._conv("b1_1x1", cin, mid)
        b1 = self._conv("b1_1x7", b1, mid, (1, 7))
        b1 = self._conv("b1_7x1", b1, 192, (7, 1))
        b2 = self._conv("b2_1x1", cin, mid)
        b2 = self._conv("b2_7x1a", b2, mid, (7, 1))
        b2 = self._conv("b2_1x7a", b2, mid, (1, 7))
        b2 = self._conv("b2_7x1b", b2, mid, (7, 1))
        b2 = self._conv("b2_1x7b", b2, 192, (1, 7))
        b3 = self._conv("b3_proj", cin, 192)
        self.out = b0 + b1 + b2 + b3

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        r = rows
        b2 = self.b2_7x1a(self.b2_1x1(x, r), r)
        b2 = self.b2_1x7b(self.b2_7x1b(self.b2_1x7a(b2, r), r), r)
        return torch.cat([self.b0_1x1(x, r),
                          self.b1_7x1(self.b1_1x7(self.b1_1x1(x, r), r), r),
                          b2, self.b3_proj(_avg_pool(x, r), r)], dim=1)


class _ReductionB(_Block):
    """Mixed_7a: stride-2 reduction to 1280."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        super().__init__(dtype, width_mult)
        b0 = self._conv("b0_1x1", cin, 192)
        b0 = self._conv("b0_3x3", b0, 320, (3, 3), 2)
        b1 = self._conv("b1_1x1", cin, 192)
        b1 = self._conv("b1_1x7", b1, 192, (1, 7))
        b1 = self._conv("b1_7x1", b1, 192, (7, 1))
        b1 = self._conv("b1_3x3", b1, 192, (3, 3), 2)
        self.out = b0 + b1 + cin

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        """`rows`: the result is this rank's block of `rows.down(2)`."""
        r = rows
        b1 = self.b1_7x1(self.b1_1x7(self.b1_1x1(x, r), r), r)
        return torch.cat([self.b0_3x3(self.b0_1x1(x, r), r),
                          self.b1_3x3(b1, r), _max_pool(x, rows=r)], dim=1)


class _InceptionC(_Block):
    """Mixed_7b/7c: expanded-filter-bank blocks, 2048 out."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        super().__init__(dtype, width_mult)
        b0 = self._conv("b0_1x1", cin, 320)
        b1 = self._conv("b1_1x1", cin, 384)
        b1 = (self._conv("b1_1x3", b1, 384, (1, 3))
              + self._conv("b1_3x1", b1, 384, (3, 1)))
        b2 = self._conv("b2_1x1", cin, 448)
        b2 = self._conv("b2_3x3", b2, 384, (3, 3))
        b2 = (self._conv("b2_1x3", b2, 384, (1, 3))
              + self._conv("b2_3x1", b2, 384, (3, 1)))
        b3 = self._conv("b3_proj", cin, 192)
        self.out = b0 + b1 + b2 + b3

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        r = rows
        b1 = self.b1_1x1(x, r)
        b2 = self.b2_3x3(self.b2_1x1(x, r), r)
        return torch.cat([self.b0_1x1(x, r), self.b1_1x3(b1, r),
                          self.b1_3x1(b1, r), self.b2_1x3(b2, r),
                          self.b2_3x1(b2, r),
                          self.b3_proj(_avg_pool(x, r), r)], dim=1)


#: the decoder's taps, coarsest first
TAPS = ("Mixed_7c", "Mixed_6e", "Mixed_5d", "MaxPool_5a_3x3",
        "MaxPool_3a_3x3", "Conv2d_1a_3x3")
#: each tap's level: its index in `levels(input, 5)` (H/2 ... H/32)
TAP_LEVELS = (4, 3, 2, 2, 1, 0)
#: the Mixed blocks in order, each with its input's level (the same
#: index); a Reduction block's output is one level down
_BLOCKS = (("Mixed_5b", 2), ("Mixed_5c", 2), ("Mixed_5d", 2),
           ("Mixed_6a", 2), ("Mixed_6b", 3), ("Mixed_6c", 3),
           ("Mixed_6d", 3), ("Mixed_6e", 3), ("Mixed_7a", 3),
           ("Mixed_7b", 4), ("Mixed_7c", 4))


class InceptionV3Base(_Block):
    """Stem + Mixed blocks; `forward` returns the six tap activations by
    name, `taps` their channel counts."""

    def __init__(self, cin: int, dtype: torch.dtype = torch.float32,
                 width_mult: float = 1.0):
        super().__init__(dtype, width_mult)
        kw = self._kw
        taps = {}
        c = taps["Conv2d_1a_3x3"] = self._conv("Conv2d_1a_3x3", cin, 32,
                                                (3, 3), 2)
        c = self._conv("Conv2d_2a_3x3", c, 32, (3, 3))
        c = taps["MaxPool_3a_3x3"] = self._conv("Conv2d_2b_3x3", c, 64,
                                                 (3, 3))
        c = self._conv("Conv2d_3b_1x1", c, 80)
        c = taps["MaxPool_5a_3x3"] = self._conv("Conv2d_4a_3x3", c, 192,
                                                 (3, 3))
        for name, pool in (("Mixed_5b", 32), ("Mixed_5c", 64),
                           ("Mixed_5d", 64)):
            setattr(self, name, _InceptionA(c, pool, **kw))
            c = getattr(self, name).out
        taps["Mixed_5d"] = c
        self.Mixed_6a = _ReductionA(c, **kw)
        c = self.Mixed_6a.out
        for name, mid in (("Mixed_6b", 128), ("Mixed_6c", 160),
                          ("Mixed_6d", 160), ("Mixed_6e", 192)):
            setattr(self, name, _InceptionB(c, mid, **kw))
            c = getattr(self, name).out
        taps["Mixed_6e"] = c
        self.Mixed_7a = _ReductionB(c, **kw)
        c = self.Mixed_7a.out
        for name in ("Mixed_7b", "Mixed_7c"):
            setattr(self, name, _InceptionC(c, **kw))
            c = getattr(self, name).out
        taps["Mixed_7c"] = c
        self.taps = taps

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> dict[str, torch.Tensor]:
        """The taps by name. `rows`: x's level (the whole input), the
        taps this rank's blocks of their levels (`TAP_LEVELS`)."""
        lv = [None] * 5 if rows is None else levels(rows, 5)
        taps = {}
        net = taps["Conv2d_1a_3x3"] = self.Conv2d_1a_3x3(x, rows)
        net = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(net, lv[0]), lv[0])
        net = taps["MaxPool_3a_3x3"] = _max_pool(net, rows=lv[0])
        net = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(net, lv[1]), lv[1])
        net = taps["MaxPool_5a_3x3"] = _max_pool(net, rows=lv[1])
        for name, level in _BLOCKS:
            net = getattr(self, name)(net, lv[level])
            if name in TAPS:
                taps[name] = net
        return taps


class InceptionV3Flow(nn.Module):
    flow_scales = FLOW_SCALES
    max_downsample = 32  # five stride-2 stages

    def __init__(self, flow_channels: int = 2, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow_channels = flow_channels
        self.width_mult = width_mult
        self.dtype = dtype
        # T frames of 3 channels give 2(T-1) flow channels
        self.encoder = InceptionV3Base(3 * (flow_channels // 2 + 1), dtype,
                                       width_mult)
        self.decoder = FlowDecoder(
            [self.encoder.taps[t] for t in TAPS],
            tuple(scaled_width(f, width_mult)
                  for f in (512, 256, 128, 64, 32)),
            flow_channels, dtype,
            scales=(2, 2, 1, 2, 2))  # Mixed_5d and MaxPool_5a share a size

    def forward(self, x: torch.Tensor,
                spatial: SpatialGroup | None = None) -> list[torch.Tensor]:
        if spatial is None:
            taps = self.encoder(x)
            return self.decoder([taps[t] for t in TAPS])[::-1]  # finest 1st
        rows = Rows(spatial, x.shape[-2], whole=True)
        taps = self.encoder(x, rows)
        lv = levels(rows, 5)
        lv = [lv[i] for i in TAP_LEVELS]
        flows = self.decoder([taps[t] for t in TAPS], lv)
        return [all_rows(f, r) for f, r in zip(flows, lv)][::-1]
