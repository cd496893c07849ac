"""Model registry (port of `deepof_tpu/models/registry.py`).

Every name of the JAX registry: the flow models flownet_s, flownet_c,
flownet_cs, inception_v3 and vgg16, and the UCF-101 action models
st_single, st_baseline and ucf101_spatial, whose fc6 width follows from
`image_size` (the JAX model infers it from the init input).
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
from .two_stream import STBaseline, STSingle, UCF101Spatial
from .vgg16_flow import VGG16Flow

MODELS = {
    "flownet_s": FlowNetS,
    "flownet_c": FlowNetC,
    "flownet_cs": FlowNetCS,
    "inception_v3": InceptionV3Flow,
    "vgg16": VGG16Flow,
    "st_single": STSingle,
    "st_baseline": STBaseline,
    "ucf101_spatial": UCF101Spatial,
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
                dtype: torch.dtype = torch.float32,
                image_size: tuple[int, int] | None = None,
                **kw) -> nn.Module:
    """The named model, initialised from `seed` as the JAX package
    initialises it, on `device` (default CUDA; raises without a card).
    Its convolutions and cost volume compute in `dtype`; its parameters
    are float32 whatever `dtype` is. `image_size`, the network input's
    (H, W), sizes an action model's fc6 (None: the ucf101 preset's);
    the flow models take any size."""
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
    if "image_size" in fields and image_size is not None:
        kw["image_size"] = tuple(image_size)
    if "flow_channels" in fields:
        kw["flow_channels"] = flow_channels
    model = cls(dtype=dtype, **kw)
    return init_weights(model, seed).to(dev)
