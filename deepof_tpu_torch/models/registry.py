"""Model registry (port of `deepof_tpu/models/registry.py`).

Ported so far: flownet_s, flownet_c, flownet_cs, inception_v3 and
vgg16. The other names of the JAX registry (the UCF-101 two-stream
models) raise NotImplementedError naming the ROADMAP item that ports
them.
"""

from __future__ import annotations

import inspect

import torch
from torch import nn

from ..core.device import resolve_device
from .common import init_weights
from .flownet2 import FlowNetCS
from .flownet_c import FlowNetC
from .flownet_s import FlowNetS
from .inception_v3_flow import InceptionV3Flow
from .vgg16_flow import VGG16Flow

MODELS = {
    "flownet_s": FlowNetS,
    "flownet_c": FlowNetC,
    "flownet_cs": FlowNetCS,
    "inception_v3": InceptionV3Flow,
    "vgg16": VGG16Flow,
}

#: JAX registry names not ported yet -> where ROADMAP.md plans them.
NOT_PORTED = {
    "st_single": "ROADMAP Queue A item 9.4 (UCF-101 two-stream models)",
    "st_baseline": "ROADMAP Queue A item 9.4 (UCF-101 two-stream models)",
    "ucf101_spatial": "ROADMAP Queue A item 9.4 (UCF-101 two-stream models)",
}

#: (config-surface name, model-field name, model-family default): knobs
#: honored only by models that declare the field; a non-default value for
#: a model without it raises a named error instead of being dropped.
_OPTIONAL_KNOBS = (
    ("width_mult", "width_mult", 1.0),
    ("corr_max_disp", "max_disp", 20),
    ("corr_stride", "corr_stride", 2),
)


def _fields(cls) -> set[str]:
    return set(inspect.signature(cls.__init__).parameters) - {"self"}


def build_model(name: str, flow_channels: int = 2, width_mult: float = 1.0,
                corr_max_disp: int = 20, corr_stride: int = 2,
                seed: int = 0, device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32, **kw) -> nn.Module:
    """The named model, initialised from `seed` as the JAX package
    initialises it, on `device` (default CUDA; raises without a card).
    Its convolutions and cost volume compute in `dtype`; its parameters
    are float32 whatever `dtype` is."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"model {name!r} is not ported to deepof_tpu_torch yet: "
            f"{NOT_PORTED[name]}")
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    dev = resolve_device(device)
    cls = MODELS[name]
    fields = _fields(cls)
    passed = {"width_mult": width_mult, "corr_max_disp": corr_max_disp,
              "corr_stride": corr_stride}
    for knob, field, default in _OPTIONAL_KNOBS:
        value = passed[knob]
        if field in fields and field not in kw:
            kw[field] = value
        elif value != default and field not in fields:
            supported = sorted(n for n, c in MODELS.items()
                               if field in _fields(c))
            raise ValueError(
                f"model {name!r} does not support {knob} (={value}); "
                f"models honoring it: {supported}")
    model = cls(flow_channels=flow_channels, dtype=dtype, **kw)
    return init_weights(model, seed).to(dev)
