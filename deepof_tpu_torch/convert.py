"""Carry the JAX package's flax parameters into this package's modules.

The input is the flax `params` tree as nested dicts of numpy arrays (the
caller converts jax arrays with `np.asarray`; this module imports no
jax). Layer names map one to one: a flax `X/Conv_0/{kernel,bias}` is the
torch `X.conv.{weight,bias}`, a flax `X/ConvTranspose_0/{kernel,bias}` is
`X.deconv.{weight,bias}`. Layouts:
  - Conv kernels go HWIO -> OIHW;
  - ConvTranspose kernels are flipped spatially and laid out
    (in, out, kh, kw): flax's ConvTranspose (transpose_kernel=False) is
    the torch ConvTranspose2d with the spatially flipped weight;
  - biases pass through unchanged;
  - a scalar parameter of a module's own (`FlowNetRefine`'s `gate`) keeps
    its flax path as its torch name (`gate`, `<scope>.gate`).

A FlowNet-CS tree's `refine` subtree, `{"refine": params["refine"]}`,
loads into `FlowNetRefine(residual=False)` unchanged.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_LAYERS = {"Conv_0": "conv", "ConvTranspose_0": "deconv"}
#: scalar parameters declared by a module itself, not by a layer
_SCALARS = ("gate",)


def _leaves(tree: Mapping, path: tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, path + (str(k),))
        else:
            yield path + (str(k),), v


def state_dict_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """flax params tree (nested dicts of arrays) -> torch state_dict."""
    out: dict[str, torch.Tensor] = {}
    bad = []
    for path, leaf in _leaves(params):
        if path[-1] in _SCALARS and np.ndim(leaf) == 0:
            out[".".join(path)] = torch.tensor(np.float32(leaf))
            continue
        if len(path) < 2:
            bad.append("/".join(path))
            continue
        *scope, layer, kind = path
        if layer not in _LAYERS or kind not in ("kernel", "bias"):
            bad.append("/".join(path))
            continue
        a = np.asarray(leaf, np.float32)
        if kind == "kernel" and layer == "Conv_0":
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif kind == "kernel":
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)  # flip, (in, out, kh, kw)
        key = ".".join([*scope, _LAYERS[layer],
                        "weight" if kind == "kernel" else "bias"])
        out[key] = torch.from_numpy(a.copy())  # owned, writable, contiguous
    if bad:
        raise ValueError(f"state_dict_from_flax: unrecognised flax params "
                         f"(expected <scope>/Conv_0|ConvTranspose_0/"
                         f"kernel|bias, or a scalar {_SCALARS}): {bad}")
    return out


def load_flax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Load a flax params tree into `model` in place. Raises, naming the
    keys, on any missing or extra key and any shape mismatch."""
    sd = state_dict_from_flax(params)
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    shapes = sorted(f"{k}: flax {tuple(sd[k].shape)} vs torch "
                    f"{tuple(want[k].shape)}"
                    for k in set(sd) & set(want)
                    if sd[k].shape != want[k].shape)
    if missing or extra or shapes:
        raise ValueError(f"load_flax_params: missing {missing}, extra "
                         f"{extra}, shape mismatches {shapes}")
    model.load_state_dict(sd, strict=True)
    return model
