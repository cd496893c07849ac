"""Shared model building blocks (port of `deepof_tpu/models/common.py`).

Conventions, as in the JAX package:
  - SAME padding everywhere. Flax pads a strided conv asymmetrically
    (low = total // 2, the rest high): conv1 (k=7, s=2) at 384 rows pads
    2 rows above and 3 below. `ConvELU` computes that pad per call, so a
    symmetric `padding=3` never shifts the output by a pixel;
  - encoder/decoder convs use ELU, except prediction (`pr*`) and
    flow-upsampling (`up_pr*`) layers, which are linear (the Inception
    base's convs use ReLU: `inception_v3_flow.py`);
  - conv weights init glorot-uniform, zero biases; feature deconvs init to
    bilinear upsampling with an identity channel map;
  - `dtype` (`train.compute_dtype`): each conv and deconv casts its
    input, weight and bias to it and computes in it, as flax's
    `nn.Conv(dtype=...)` does; the parameters stay float32, and their
    gradients come back float32 through the cast.

Tensors are NCHW inside the models.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def bilinear_upsample_kernel(kh: int, kw: int) -> np.ndarray:
    """(kh, kw) bilinear interpolation kernel (max 1 at the center)."""
    def axis(k):
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        return 1 - np.abs(np.arange(k) / f - c)

    return np.outer(axis(kh), axis(kw))


def bilinear_kernel_init(weight: torch.Tensor) -> None:
    """Fill a ConvTranspose2d weight (in, out, kh, kw) with bilinear
    upsampling, identity across channels (zero between different ones):
    the flax init's kernel, flipped as `convert.py` flips it, so the
    deconv computes what the flax one does. The flip matters where the
    kernel is not symmetric: the scale-1 deconv's (2, 2) kernel, one
    pixel's shift, not the identity."""
    cin, cout, kh, kw = weight.shape
    up = torch.as_tensor(bilinear_upsample_kernel(kh, kw)[::-1, ::-1].copy(),
                         dtype=weight.dtype)
    with torch.no_grad():
        weight.zero_()
        for c in range(min(cin, cout)):
            weight[c, c] = up


def _same_pad(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((math.ceil(size / s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class ConvELU(nn.Module):
    """Conv with SAME padding (flax's asymmetric rule) + optional ELU, in
    `dtype`. A subclass changes the activation through `activation`."""

    def __init__(self, cin: int, features: int,
                 kernel: tuple[int, int] = (3, 3), stride: int = 1,
                 act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = nn.Conv2d(cin, features, kernel, stride=stride)
        self.kernel = tuple(kernel)
        self.stride = stride
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), s = self.kernel, self.stride
        ph = _same_pad(x.shape[-2], kh, s)
        pw = _same_pad(x.shape[-1], kw, s)
        x = x.to(self.dtype)
        weight = self.conv.weight.to(self.dtype)
        bias = self.conv.bias.to(self.dtype)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            x = F.conv2d(x, weight, bias, s, (ph[0], pw[0]))
        else:
            x = F.conv2d(F.pad(x, (*pw, *ph)), weight, bias, s)
        return self.activation(x) if self.act else x

    @staticmethod
    def activation(x: torch.Tensor) -> torch.Tensor:
        return F.elu(x)


class Deconv(nn.Module):
    """Transposed conv, kernel (2*scale, 2*scale), stride=scale;
    initialised to bilinear upsampling; in `dtype`. Flax's ConvTranspose
    kernel is the spatially flipped torch weight (see `convert.py`). At
    an even scale the output is exactly scale x the input, as flax's
    SAME. At scale 1 (k = 2, stride 1, no padding) it is one row and one
    column longer: flax's SAME pads that kernel (1, 0), so its output is
    this one's first H x W, and `FlowDecoder` crops it there."""

    def __init__(self, cin: int, features: int, scale: int = 2,
                 act: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        k = 2 * scale
        self.deconv = nn.ConvTranspose2d(cin, features, k, stride=scale,
                                         padding=scale // 2)
        self.act = act
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.deconv
        x = F.conv_transpose2d(x.to(self.dtype), d.weight.to(self.dtype),
                               d.bias.to(self.dtype), d.stride, d.padding)
        return F.elu(x) if self.act else x


class FlowDecoder(nn.Module):
    """Multi-scale flow decoder. Consumes encoder features coarsest-first;
    at each level k:
        pr_k = 3x3 linear conv -> flow_channels
        feat = concat(skip_{k-1}, Deconv(feat), Deconv_linear(pr_k))
    `scales` are the deconvs' scales a transition (default 2; the
    Inception head passes 1 between its two same-size taps). Returns
    flows coarsest-first.
    """

    def __init__(self, in_channels: Sequence[int],
                 upconv_features: Sequence[int], flow_channels: int = 2,
                 dtype: torch.dtype = torch.float32,
                 scales: Sequence[int] | None = None):
        super().__init__()
        n = len(in_channels)
        scales = tuple(scales or (2,) * (n - 1))
        if len(upconv_features) != n - 1 or len(scales) != n - 1:
            raise ValueError(f"{n} feature levels need {n - 1} upconv "
                             f"widths and scales, got "
                             f"{len(upconv_features)} and {len(scales)}")
        self.n = n
        feat = in_channels[0]
        for k in range(n - 1):
            setattr(self, f"pr{n - k}", ConvELU(feat, flow_channels,
                                                act=False, dtype=dtype))
            setattr(self, f"upconv{n - k - 1}",
                    Deconv(feat, upconv_features[k], scales[k],
                           dtype=dtype))
            setattr(self, f"up_pr{n - k}to{n - k - 1}",
                    Deconv(flow_channels, flow_channels, scales[k],
                           act=False, dtype=dtype))
            feat = in_channels[k + 1] + upconv_features[k] + flow_channels
        self.pr1 = ConvELU(feat, flow_channels, act=False, dtype=dtype)

    def forward(self, feats_coarse_first: Sequence[torch.Tensor]
                ) -> list[torch.Tensor]:
        n = self.n
        flows = []
        feat = feats_coarse_first[0]
        for k in range(n - 1):
            pr = getattr(self, f"pr{n - k}")(feat)
            flows.append(pr)
            up_feat = getattr(self, f"upconv{n - k - 1}")(feat)
            up_pr = getattr(self, f"up_pr{n - k}to{n - k - 1}")(pr)
            # odd skip sizes: stride-2 deconvs overshoot by one, and a
            # scale-1 deconv always does; crop
            skip = feats_coarse_first[k + 1]
            sh, sw = skip.shape[-2:]
            feat = torch.cat([skip, up_feat[..., :sh, :sw],
                              up_pr[..., :sh, :sw]], dim=1)
        flows.append(self.pr1(feat))
        return flows


def scaled_width(features: int, mult: float) -> int:
    """Channel width under a width multiplier; floor of 8."""
    return max(int(features * mult), 8)


def add_flownet_tail(module: nn.Module, cin: int, width_mult: float = 1.0,
                     prefix: str = "conv",
                     dtype: torch.dtype = torch.float32
                     ) -> tuple[int, int, int]:
    """Register the conv4_1..conv6_2 contracting tail (strides 2 at
    4_1/5_1/6_1) on `module`, so the layer names land in the caller's
    flat scope as in the JAX package; returns the channel counts of
    (conv4_2, conv5_2, conv6_2)."""
    ch = lambda n: scaled_width(n, width_mult)  # noqa: E731
    specs = (("4_1", ch(512), 2), ("4_2", ch(512), 1), ("5_1", ch(512), 2),
             ("5_2", ch(512), 1), ("6_1", ch(1024), 2), ("6_2", ch(1024), 1))
    for name, feats, stride in specs:
        setattr(module, f"{prefix}{name}",
                ConvELU(cin, feats, stride=stride, dtype=dtype))
        cin = feats
    return ch(512), ch(512), ch(1024)


def flownet_tail(module: nn.Module, x: torch.Tensor, prefix: str = "conv"):
    """Run the tail registered by `add_flownet_tail`; returns
    (conv4_2, conv5_2, conv6_2)."""
    c = lambda name, t: getattr(module, f"{prefix}{name}")(t)  # noqa: E731
    c4_2 = c("4_2", c("4_1", x))
    c5_2 = c("5_2", c("5_1", c4_2))
    c6_2 = c("6_2", c("6_1", c5_2))
    return c4_2, c5_2, c6_2


def add_flownet_trunk(module: nn.Module, cin: int, width_mult: float = 1.0,
                      prefix: str = "conv",
                      dtype: torch.dtype = torch.float32) -> list[int]:
    """Register the 10-conv FlowNet-S trunk on `module`; returns the
    channel counts of its taps [conv1, conv2, conv3_2, conv4_2, conv5_2,
    conv6_2]."""
    ch = lambda n: scaled_width(n, width_mult)  # noqa: E731
    for name, cout, kernel, stride in (("1", ch(64), (7, 7), 2),
                                       ("2", ch(128), (5, 5), 2),
                                       ("3_1", ch(256), (5, 5), 2),
                                       ("3_2", ch(256), (3, 3), 1)):
        setattr(module, f"{prefix}{name}",
                ConvELU(cin, cout, kernel, stride, dtype=dtype))
        cin = cout
    tail = add_flownet_tail(module, ch(256), width_mult, prefix, dtype)
    return [ch(64), ch(128), ch(256), *tail]


def flownet_trunk(module: nn.Module, x: torch.Tensor,
                  prefix: str = "conv") -> list[torch.Tensor]:
    """Run the trunk registered by `add_flownet_trunk`; returns decoder
    taps coarsest-last: [conv1, conv2, conv3_2, conv4_2, conv5_2, conv6_2]."""
    c = lambda name, t: getattr(module, f"{prefix}{name}")(t)  # noqa: E731
    c1 = c("1", x)
    c2 = c("2", c1)
    c3_2 = c("3_2", c("3_1", c2))
    return [c1, c2, c3_2, *flownet_tail(module, c3_2, prefix)]


def truncated_normal_(w: torch.Tensor, stddev: float,
                      generator: torch.Generator) -> torch.Tensor:
    """flax's `initializers.truncated_normal(stddev)` (jax's): a standard
    normal truncated to [-2, 2], times `stddev`, with no correction for
    the truncation (F21): standard deviation 0.8796 `stddev`, values
    within +-2 `stddev`. Drawn by rejection (normals outside [-2, 2]
    drawn again), ten times faster on the CPU than torch's inverse-CDF
    `trunc_normal_` at fc6's 250 M entries."""
    with torch.no_grad():
        flat = w.view(-1)
        flat.normal_(generator=generator)
        redo = (flat.abs() > 2.0).nonzero().squeeze(1)
        while redo.numel():
            fresh = torch.randn(redo.numel(), generator=generator,
                                dtype=w.dtype)
            flat[redo] = fresh
            redo = redo[fresh.abs() > 2.0]
        return w.mul_(stddev)


def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """The JAX package's init: glorot-uniform conv weights, zero biases,
    bilinear feature deconvs; the action models' bare convs and ReLU
    head's dense layers truncated normal 0.01, their ELU head's dense
    layers glorot-uniform. Draws from a torch.Generator seeded with
    `seed` in module order (the numbers differ from jax.random's)."""
    from .two_stream import Conv, Dense

    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, ConvELU):
            nn.init.xavier_uniform_(m.conv.weight, generator=g)
            nn.init.zeros_(m.conv.bias)
        elif isinstance(m, Deconv):
            bilinear_kernel_init(m.deconv.weight)
            nn.init.zeros_(m.deconv.bias)
        elif isinstance(m, Dense) and m.glorot:
            nn.init.xavier_uniform_(m.weight, generator=g)
            nn.init.zeros_(m.bias)
        elif isinstance(m, (Conv, Dense)):
            truncated_normal_(m.weight, 0.01, g)
            nn.init.zeros_(m.bias)
    return model


def load_vgg16_npz(model: nn.Module, npz_path: str,
                   trunk_path: Sequence[str] = ("encoder",),
                   duplicate_input: bool = True) -> nn.Module:
    """Initialise a VGG16 trunk of `model` in place from the public
    `vgg16_weights.npz` (port of the JAX package's `load_vgg16_npz`):
    the 13 convs `conv{b}_{i}` in order, `_W` in HWIO going to OIHW and
    `_b` as it is, under the submodule `trunk_path` ("encoder" for
    VGG16Flow); the fc layers are skipped. With `duplicate_input`, a
    first conv that takes twice the file's input channels (the 6-channel
    pair) gets the file's filters tiled twice along them. A shape that
    does not match raises ValueError naming the layer. Nothing is
    downloaded: the caller provides the file."""
    data = np.load(npz_path)
    sub = model
    for p in trunk_path:
        sub = getattr(sub, p)
    names = [f"conv{b}_{i}" for b, n in zip(range(1, 6), (2, 2, 3, 3, 3))
             for i in range(1, n + 1)]
    for name in names:
        w = np.asarray(data[f"{name}_W"], np.float32).transpose(3, 2, 0, 1)
        bias = np.asarray(data[f"{name}_b"], np.float32)
        layer = getattr(sub, name)
        conv = getattr(layer, "conv", layer)  # a ConvELU or a bare Conv2d
        if (name == "conv1_1" and duplicate_input
                and conv.weight.shape[1] == 2 * w.shape[1]):
            w = np.concatenate([w, w], axis=1)
        if tuple(conv.weight.shape) != w.shape or \
                tuple(conv.bias.shape) != bias.shape:
            raise ValueError(
                f"load_vgg16_npz: {name}: the model's weight "
                f"{tuple(conv.weight.shape)} and bias "
                f"{tuple(conv.bias.shape)} (OIHW) vs the file's "
                f"{w.shape} and {bias.shape}")
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(w))
            conv.bias.copy_(torch.from_numpy(bias))
    return model
