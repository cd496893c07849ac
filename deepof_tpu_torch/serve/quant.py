"""Weight-precision serving tiers (port of `deepof_tpu/serve/quant.py`).

Each tier is a transform of the served model into a module of its own:

  f32   the model itself;
  bf16  every floating-point parameter cast to bfloat16. The blocks keep
        `dtype=float32` and upcast each weight at `forward`
        (`models/common.py`), as flax promotes bf16 parameters to its
        float32 compute dtype: the tier computes in float32 with rounded
        weights. The cost volume stays float32;
  int8  weight-only quantization of every conv and deconv weight with
        per-OUTPUT-channel scales: scale = amax(|w|) / 127 over every axis
        but the output channel (1.0 where a channel is all zero), q =
        clip(round(w / scale), -127, 127) as int8 (`torch.round` rounds
        half to even, as `jnp.round` does). The tier's module holds q and
        scale and no float32 copy of the weight; each forward dequantizes
        as `q.float() * scale`, one float32 multiply, as the JAX tier does
        inside its forward. Biases and the `gate` scalar stay float32.

The output channel is dim 0 of an `nn.Conv2d` weight (O, I, kh, kw) and
dim 1 of an `nn.ConvTranspose2d` weight (I, O, kh, kw); flax keeps it
last in both (ROADMAP F12). Scales over the wrong axis would still give
a plausible flow, so the tests compare q and scale with the JAX tier's
bit for bit.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..models.common import ConvELU, Deconv

#: The tier vocabulary. `serve.precisions` is an ordered subset; its
#: first entry is the default tier.
PRECISIONS = ("f32", "bf16", "int8")

#: int8 symmetric range: round(w / scale) clipped to [-QMAX, QMAX].
QMAX = 127.0


def resolve_precisions(cfg) -> tuple[str, ...]:
    """The config's tier ladder, in order; an unknown or repeated tier
    raises ValueError."""
    tiers = tuple(cfg.serve.precisions) or ("f32",)
    seen = set()
    for t in tiers:
        if t not in PRECISIONS:
            raise ValueError(f"serve.precisions entry {t!r} unknown; valid "
                             f"tiers: {PRECISIONS}")
        if t in seen:
            raise ValueError(f"serve.precisions names {t!r} twice: {tiers}")
        seen.add(t)
    return tiers


def _output_axis(layer: nn.Module) -> int:
    return 1 if isinstance(layer, nn.ConvTranspose2d) else 0


def quantize_weight(w: torch.Tensor,
                    axis: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One conv weight -> (q int8 of w's shape, scale float32 per channel
    along `axis`)."""
    dims = [d for d in range(w.dim()) if d != axis]
    amax = w.abs().amax(dim=dims)
    scale = torch.where(amax > 0, amax / QMAX,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(w / _along(scale, w.dim(), axis)), -QMAX,
                    QMAX).to(torch.int8)
    return q, scale


def _along(scale: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = -1
    return scale.view(shape)


class Int8Layer(nn.Module):
    """The int8 tier's stand-in for a block's `nn.Conv2d` or
    `nn.ConvTranspose2d`: the int8 weight `q`, its per-output-channel
    `scale` and the float32 `bias`; `weight` dequantizes on each read,
    and `stride`/`padding` are the layer's, so `ConvELU` and `Deconv`
    read it as they read the layer."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.axis = _output_axis(layer)
        q, scale = quantize_weight(layer.weight.detach(), self.axis)
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.bias = layer.bias
        self.stride, self.padding = layer.stride, layer.padding

    @property
    def weight(self) -> torch.Tensor:
        return self.q.float() * _along(self.scale, self.q.dim(), self.axis)


def _layers(model: nn.Module):
    """(block, attribute name) of every conv and deconv layer."""
    for m in model.modules():
        if isinstance(m, ConvELU):
            yield m, "conv"
        elif isinstance(m, Deconv):
            yield m, "deconv"


def quantize_model(model: nn.Module, tier: str) -> nn.Module:
    """The module that serves `tier` (see the module docstring): `model`
    itself for f32, a transformed copy on the model's device otherwise."""
    if tier == "f32":
        return model
    if tier not in PRECISIONS:
        raise ValueError(f"unknown precision tier {tier!r}; valid: "
                         f"{PRECISIONS}")
    out = copy.deepcopy(model)
    if tier == "bf16":
        return out.to(torch.bfloat16)
    with torch.no_grad():
        for block, name in _layers(out):
            setattr(block, name, Int8Layer(getattr(block, name)))
    return out


def int8_roundtrip_max_error(model: nn.Module) -> float:
    """max over the conv and deconv weights of |w - q * scale| / scale:
    the round-trip error in units of each channel's scale, at most 0.5
    (+ float eps)."""
    worst = 0.0
    with torch.no_grad():
        for block, name in _layers(model):
            layer = getattr(block, name)
            axis = _output_axis(layer)
            q, scale = quantize_weight(layer.weight, axis)
            s = _along(scale, q.dim(), axis)
            err = (layer.weight.float() - q.float() * s).abs() / s
            worst = max(worst, float(err.max()))
    return worst


def params_nbytes(model: nn.Module) -> int:
    """Bytes of a tier's parameters and buffers: the weight memory it
    holds on the device."""
    return sum(t.numel() * t.element_size()
               for t in (*model.parameters(), *model.buffers()))
