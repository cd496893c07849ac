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
    its flax path as its torch name (`gate`, `<scope>.gate`);
  - a bare `nn.Conv` or `nn.Dense` leaf `<scope>/<name>/{kernel,bias}`
    (the action models' `spatial/conv1_1`, `fuse_1x1`, `head/fc6`) is
    `<scope>.<name>.{weight,bias}`, placed by the kernel's rank: a 4-D
    kernel goes HWIO -> OIHW, a 2-D one (in, out) is transposed to
    torch's (out, in). fc6 reads pool5 flattened in flax's (h, w, c)
    order on both sides (`models/two_stream.py`), so its rows need no
    permutation.

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
        a = np.asarray(leaf, np.float32)
        bare = layer not in _LAYERS  # a bare nn.Conv or nn.Dense
        if kind not in ("kernel", "bias") or (
                bare and a.ndim not in ((2, 4) if kind == "kernel" else (1,))):
            bad.append("/".join(path))
            continue
        if kind == "kernel" and layer == "ConvTranspose_0":
            a = a[::-1, ::-1].transpose(2, 3, 0, 1)  # flip, (in, out, kh, kw)
        elif kind == "kernel":
            # HWIO -> OIHW; a dense (in, out) -> (out, in)
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
        module = [*scope, layer if bare else _LAYERS[layer]]
        key = ".".join([*module, "weight" if kind == "kernel" else "bias"])
        out[key] = torch.from_numpy(a.copy())  # owned, writable, contiguous
    if bad:
        raise ValueError(f"state_dict_from_flax: unrecognised flax params "
                         f"(expected <scope>/Conv_0|ConvTranspose_0/"
                         f"kernel|bias, a bare conv's 4-D or dense's 2-D "
                         f"kernel and 1-D bias, or a scalar {_SCALARS}): "
                         f"{bad}")
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
