"""UCF-101 action models (port of `deepof_tpu/models/two_stream.py`):
the spatial classifier, STsingle and STbaseline.

  - `UCF101Spatial`: VGG16 with ReLU (`VGGReLUTrunk`) on frame 1 only,
    then the fc head fc6 / fc7 (4096) / fc8 (classes); returns logits;
  - `STSingle`: one VGG16 trunk with ELU (`VGG16Trunk`) over the pair;
    the fc head (ELU) on pool5 and five flow heads on pool5..pool1
    (`FlowDecoder`, VGG16Flow's); returns (flows finest first, logits);
  - `STBaseline`: a FlowNet-S trunk (`Tconv*`) with its six flow heads,
    and a VGG16 ReLU trunk (`spatial`) on frame 1; the classifier reads
    concat(pool5, Tconv5_2) -> 2x2 max-pool -> concat(., Tconv6_2) ->
    1x1 conv 512 + ReLU -> the fc head (ReLU); returns (flows, logits).

The fc head flattens pool5 in flax's NHWC order, (h, w, c) (F20): the
port flattens a channels-last view, so `convert.py` carries fc6's kernel
with a plain transpose. fc6's width follows from the input size
(`image_size`, as flax infers it at init): 10 x 12 x 512 = 61440 at the
ucf101 preset's 320x384.

Dropout (keep 0.9, both after fc6 and fc7) is flax's rule
`where(keep, x / 0.9, 0)` on masks the caller draws
(`dropout_masks`): a model called without masks applies none (eval,
predict). The masks are a pure function of a seed and a step, drawn with
torch's generator on the tensors' device (F19: not threefry's bits), and
passed in as arguments so that a forward recomputed under
`torch.utils.checkpoint` sees the same ones.

Layer names are flax's: a bare `nn.Conv` is `Conv` (`spatial.conv1_1.
weight` is `spatial/conv1_1/kernel`), an `nn.Dense` is `Dense`
(`head.fc6.weight` is `head/fc6/kernel`, transposed). Tensors are NCHW.

`forward(..., spatial=...)` with a `parallel.spatial.SpatialGroup` runs a
model row-sharded (spatial context parallelism; the caller has checked
the gate): every rank holds the whole input, the trunks' convs and
pools compute this rank's rows of each level, the flows leave gathered
to full height, and the fc head reads its input gathered to full height
(`all_rows`) on every rank, so its flatten is the one-process flatten
and its gradients enter each rank's loss under the step's 1/S share
(`train/step.py`). The dropout masks are the global batch's, the same
on every spatial rank (F19). STBaseline's fusion (concat(pool5,
Tconv5_2), the 2x2 pool, concat(., Tconv6_2), the 1x1 conv) runs
row-sharded and is gathered once, before the head: its output at H/64
is the smallest tensor on that path, and its pool is the row-sharded
max-pool whose input blocks (H/32) and output blocks (H/64) need not
line up.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import (Rows, SpatialGroup, all_rows, levels,
                                take_window)
from .common import (FlowDecoder, _empty_block, _row_windows,
                     add_flownet_trunk, flownet_trunk)
from .flownet_s import FLOW_SCALES as FLOWNET_SCALES
from .vgg16_flow import _VGG_CFG, FLOW_SCALES as VGG_SCALES
from .vgg16_flow import VGG16Trunk, _max_pool, vgg_pools

FC_WIDTH = 4096
KEEP_PROB = 0.9  # slim keep_prob; flax Dropout(rate=0.1)
#: the ucf101 preset's image size, the models' default geometry
DEFAULT_IMAGE_SIZE = (320, 384)


class Conv(nn.Conv2d):
    """A bare flax `nn.Conv`: stride 1, SAME (symmetric at an odd
    kernel), computing in `dtype`; no activation."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, features, kernel, padding=kernel // 2)
        self.dtype = dtype

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> torch.Tensor:
        """`rows`: x is this rank's block of that level, and so is the
        result (its halo of kernel // 2 rows through the exchange)."""
        dt, pad = self.dtype, self.padding
        if rows is not None:
            x = take_window(x, rows, _row_windows(rows, self.kernel_size[0],
                                                  1))
            if not x.shape[-2]:
                return _empty_block(x, self.out_channels, 1)
            pad = (0, pad[1])
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), 1,
                        pad)


class Dense(nn.Linear):
    """A flax `nn.Dense` in `dtype`; `glorot` picks its init (glorot-
    uniform, else truncated normal 0.01: `common.init_weights`)."""

    def __init__(self, cin: int, features: int, glorot: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, features)
        self.glorot = glorot
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def apply_dropout(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """flax's Dropout on a drawn mask: where(keep, x / 0.9, 0). The
    divisor is a tensor on x's device: a Python scalar would let the
    card multiply by its reciprocal instead."""
    div = torch.tensor(KEEP_PROB, dtype=x.dtype, device=x.device)
    return torch.where(keep, x / div, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def dropout_seed(seed: int, step: int) -> int:
    """The generator seed of a step's masks: (seed, step) mixed by
    numpy's SeedSequence into 63 bits."""
    lo, hi = np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(step)]).generate_state(2, np.uint32)
    return (int(hi) << 31) ^ int(lo)


def dropout_masks(batch: int, seed: int, step: int,
                  device: str | torch.device = "cpu",
                  generator: torch.Generator | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The two keep masks (batch, 4096) of fc6 and fc7 at `step`: keep
    where a uniform draw is below 0.9 (jax.random.bernoulli's rule),
    from torch's generator on `device` seeded by `dropout_seed`. A
    `generator` of that device is reseeded and reused."""
    device = torch.device(device)
    g = generator if generator is not None else torch.Generator(device)
    g.manual_seed(dropout_seed(seed, step))
    return tuple(torch.rand((batch, FC_WIDTH), generator=g, device=device)
                 < KEEP_PROB for _ in range(2))


class VGGReLUTrunk(nn.Module):
    """VGG16's 13 3x3 convs with ReLU (the classifier flavour), each
    block ended by the -inf SAME 2x2 max-pool; returns [pool1..pool5]."""

    def __init__(self, cin: int = 3, dtype: torch.dtype = torch.float32):
        super().__init__()
        for block, (feat, n) in enumerate(_VGG_CFG, start=1):
            for i in range(1, n + 1):
                setattr(self, f"conv{block}_{i}", Conv(cin, feat, dtype=dtype))
                cin = feat

    def forward(self, x: torch.Tensor,
                rows: Rows | None = None) -> list[torch.Tensor]:
        """`rows`: row-sharded (`vgg16_flow.vgg_pools`)."""
        return vgg_pools(self, x, rows, F.relu)


class FCHead(nn.Module):
    """flatten (h, w, c) -> fc6 -> drop -> fc7 -> drop -> fc8 logits;
    ReLU with truncated-normal init, or ELU with glorot."""

    def __init__(self, cin: int, num_classes: int = 101, act: str = "relu",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        glorot = act == "elu"
        self.act = F.elu if glorot else F.relu
        self.fc6 = Dense(cin, FC_WIDTH, glorot, dtype)
        self.fc7 = Dense(FC_WIDTH, FC_WIDTH, glorot, dtype)
        self.fc8 = Dense(FC_WIDTH, num_classes, glorot, dtype)

    def forward(self, x: torch.Tensor, dropout=None) -> torch.Tensor:
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = self.act(self.fc6(x))
        if dropout is not None:
            x = apply_dropout(x, dropout[0])
        x = self.act(self.fc7(x))
        if dropout is not None:
            x = apply_dropout(x, dropout[1])
        return self.fc8(x)


def _down(size: int, times: int) -> int:
    """A size after `times` SAME stride-2 stages (ceil each)."""
    for _ in range(times):
        size = -(-size // 2)
    return size


def _whole(x: torch.Tensor, rows: Rows | None) -> torch.Tensor:
    """x gathered to full height where it is row-sharded."""
    return x if rows is None else all_rows(x, rows)


def _input_rows(x: torch.Tensor, spatial: SpatialGroup | None
                ) -> tuple[Rows | None, list]:
    """(the whole input's Rows, its stride-2 levels H/2 ... H/64), or
    (None, Nones) without a spatial group."""
    if spatial is None:
        return None, [None] * 6
    rows = Rows(spatial, x.shape[-2], whole=True)
    return rows, levels(rows, 6)


class UCF101Spatial(nn.Module):
    classifier_only = True  # the step's branch: logits, no flow pyramid
    max_downsample = 32

    def __init__(self, num_classes: int = 101,
                 image_size: tuple[int, int] = DEFAULT_IMAGE_SIZE,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = (_down(s, 5) for s in image_size)
        self.encoder = VGGReLUTrunk(3, dtype)
        self.head = FCHead(h * w * 512, num_classes, dtype=dtype)

    def forward(self, frame: torch.Tensor, dropout=None,
                spatial: SpatialGroup | None = None) -> torch.Tensor:
        rows, lv = _input_rows(frame, spatial)
        return self.head(_whole(self.encoder(frame, rows)[-1], lv[4]),
                         dropout)


class STSingle(nn.Module):
    """Shared-encoder two-stream model; input the pair (B, 6, H, W)."""

    flow_scales = VGG_SCALES
    max_downsample = 32
    has_action_head = True  # the step's branch: (flows, logits)

    def __init__(self, num_classes: int = 101, flow_channels: int = 2,
                 image_size: tuple[int, int] = DEFAULT_IMAGE_SIZE,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow_channels = flow_channels
        h, w = (_down(s, 5) for s in image_size)
        self.encoder = VGG16Trunk(3 * (flow_channels // 2 + 1), dtype)
        self.head = FCHead(h * w * 512, num_classes, act="elu", dtype=dtype)
        self.decoder = FlowDecoder(self.encoder.widths[::-1],
                                   (256, 128, 64, 32), flow_channels, dtype)

    def forward(self, pair: torch.Tensor, dropout=None,
                spatial: SpatialGroup | None = None):
        rows, lv = _input_rows(pair, spatial)
        pools = self.encoder(pair, rows)
        logits = self.head(_whole(pools[-1], lv[4]), dropout)
        if spatial is None:
            return self.decoder(pools[::-1])[::-1], logits
        flows = self.decoder(pools[::-1], lv[4::-1])[::-1]
        return [all_rows(f, r) for f, r in zip(flows, lv)], logits


class STBaseline(nn.Module):
    """Two streams and the temporal -> classifier fusion; input the pair
    (B, 6, H, W), the spatial stream reads frame 1 only."""

    flow_scales = FLOWNET_SCALES
    max_downsample = 64
    has_action_head = True

    def __init__(self, num_classes: int = 101, flow_channels: int = 2,
                 image_size: tuple[int, int] = DEFAULT_IMAGE_SIZE,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.flow_channels = flow_channels
        taps = add_flownet_trunk(self, 3 * (flow_channels // 2 + 1),
                                 prefix="Tconv", dtype=dtype)
        self.decoder = FlowDecoder(taps[::-1], (512, 256, 128, 64, 32),
                                   flow_channels, dtype)
        self.spatial = VGGReLUTrunk(3, dtype)
        self.fuse_1x1 = Conv(512 + taps[4] + taps[5], 512, kernel=1,
                             dtype=dtype)
        h, w = (_down(s, 6) for s in image_size)
        self.head = FCHead(h * w * 512, num_classes, dtype=dtype)

    def forward(self, pair: torch.Tensor, dropout=None,
                spatial: SpatialGroup | None = None):
        rows, lv = _input_rows(pair, spatial)
        taps = flownet_trunk(self, pair, prefix="Tconv", rows=rows)
        if spatial is None:
            flows = self.decoder(taps[::-1])[::-1]
        else:
            flows = [all_rows(f, r) for f, r in zip(
                self.decoder(taps[::-1], lv[::-1])[::-1], lv)]
        pool5 = self.spatial(pair[:, :3], rows)[-1]  # H/32, as Tconv5_2
        st = _max_pool(torch.cat([pool5, taps[4]], dim=1), lv[4])
        st = torch.cat([st, taps[5]], dim=1)  # H/64, as Tconv6_2
        st = F.relu(self.fuse_1x1(st, lv[5]))
        logits = self.head(_whole(st, lv[5]), dropout)
        return flows, logits
