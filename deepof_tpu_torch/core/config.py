"""Experiment configuration: the subset of `deepof_tpu/core/config.py`
that the PyTorch serving path reads.

Field names and defaults are those of the JAX package, so a config dict
written by `dataclasses.asdict` of a `deepof_tpu` config loads here
through `config_from_dict`. Keys this package does not read are ignored
and named in one warning, so a full JAX config JSON loads without error.
"""

from __future__ import annotations

import dataclasses
import typing
import warnings
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "flyingchairs"  # flyingchairs | sintel | ucf101 | synthetic
    image_size: tuple[int, int] = (384, 512)  # (H, W) network input
    time_step: int = 2  # frames per sample


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    # eval protocol: finest flow is multiplied by `eval_amplifier`,
    # clipped to `eval_clip`, and resized to the native resolution
    eval_amplifier: float = 2.0
    eval_clip: tuple[float, float] = (-300.0, 250.0)


@dataclass(frozen=True)
class ServeConfig:
    # Dynamic micro-batcher: up to max_batch pairs per forward; a partial
    # batch flushes when the oldest pending request has waited
    # batch_timeout_ms. Every dispatch is padded to exactly max_batch rows.
    max_batch: int = 8
    batch_timeout_ms: float = 10.0
    # (H, W) network-input buckets; () = one bucket at data.image_size.
    buckets: tuple[tuple[int, int], ...] = ()
    # Weight-precision tiers. Only "f32" is served by this package so far.
    precisions: tuple[str, ...] = ("f32",)
    # submit() blocks when this many requests are pending. 0 = unbounded.
    queue_depth: int = 256


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "flyingchairs_flownet_s"
    model: str = "flownet_s"  # flownet_s | flownet_c in this package
    width_mult: float = 1.0
    # FlowNet-C correlation geometry (FlowNet paper: 441 displacements)
    corr_max_disp: int = 20
    corr_stride: int = 2
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def _tupleize(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_tupleize(v) for v in value)
    return value


def _from_dict(cls: type, d: dict, path: str, ignored: list[str]) -> Any:
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    ignored.extend(f"{path}{k}" for k in sorted(set(d) - names))
    kwargs: dict[str, Any] = {}
    for name in names & set(d):
        value = d[name]
        hint = hints[name]
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            value = _from_dict(hint, value, f"{path}{name}.", ignored)
        else:
            value = _tupleize(value)
        kwargs[name] = value
    return cls(**kwargs)


def config_from_dict(d: dict) -> ExperimentConfig:
    """Nested dict (e.g. a `deepof_tpu` config JSON) -> ExperimentConfig.

    Missing keys keep their defaults; keys this package does not read are
    dropped and listed in one UserWarning."""
    ignored: list[str] = []
    cfg = _from_dict(ExperimentConfig, d, "", ignored)
    if ignored:
        warnings.warn(f"config_from_dict: ignored keys not read by "
                      f"deepof_tpu_torch: {ignored}", stacklevel=2)
    return cfg
