"""Augmentation on the device (port of `deepof_tpu/data/augmentation.py`).

Each family is split into a *sample* step, which draws the per-sample
parameters from a `torch.Generator` on the batch's device, and an
*apply* step, a pure function of the images and those parameters:

  - geometric (`sample_geo_params`, `apply_geo`): rotation (+-17 deg),
    scale (0.9-2.0), translation (+-0.2 of the size) and a left-right
    flip, as an inverse-affine displacement field fed to the loss's own
    warp (`ops/warp.py`), so on a CUDA tensor the hand-written warp
    kernel resamples (clip at the border, bilinear);
  - photometric (`sample_photo_params`, `apply_photo`): contrast,
    brightness, per-channel colour, gamma and Gaussian noise, the same
    parameters for both frames of a sample.

Images are raw 0-255 NHWC throughout. `augment_batch` keeps the JAX
package's dual-stream contract: the geometric-only `source`/`target`
feed the loss, the photometric `net_source`/`net_target` the network.

The draws are PyTorch's, not `jax.random`'s threefry bits (F18 in
ROADMAP.md), so a run with augmentation is not the JAX run step for
step: what is held to the JAX package is *apply* given the same
parameters and noise, and *sample* is held to the same ranges and to
determinism. A batch's augmentation is a pure function of its seed (drawn
by the train loop from the batch's own rng, where the JAX loop draws
it) and of the device: two generators seeded from it, one for each
family, so the photometric draws do not depend on whether the geometric
family is on.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ..ops.warp import warp_levels_forward

# the numpy pipeline's ranges (the JAX module's constants)
TRANSLATION = 0.2
ROTATION_DEG = 17.0
SCALE_RANGE = (0.9, 2.0)
CONTRAST = (-0.8, 0.4)
BRIGHTNESS_SIGMA = 0.2
COLOR_RANGE = (0.5, 2.0)
GAMMA_RANGE = (0.7, 1.5)
NOISE_SIGMA_MAX = 0.04

#: the batch entry holding a batch's augmentation seed (one per stacked
#: micro-batch under train.steps_per_call > 1)
SEED_KEY = "aug_seed"
# generator streams of one seed: geometric, photometric
_GEO, _PHOTO = 0, 1

Params = dict[str, torch.Tensor]


def generator(seed: int, stream: int,
              device: torch.device | str) -> torch.Generator:
    """The generator of family `stream` for `seed` (0 <= seed < 2**31)."""
    return torch.Generator(device=device).manual_seed(
        int(seed) + stream * 2 ** 31)


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=g, device=g.device)
    return lo + (hi - lo) * u


def sample_geo_params(g: torch.Generator, batch: int,
                      rotation: bool = True) -> Params:
    """Per-sample geometric parameters on the generator's device: angle
    (rad), scale, translation fractions tx/ty, and the flip flag."""
    rot = math.radians(ROTATION_DEG) if rotation else 0.0
    return {"angle": _uniform(g, (batch,), -rot, rot),
            "scale": _uniform(g, (batch,), *SCALE_RANGE),
            "tx": _uniform(g, (batch,), -TRANSLATION, TRANSLATION),
            "ty": _uniform(g, (batch,), -TRANSLATION, TRANSLATION),
            "flip": torch.rand((batch,), generator=g, device=g.device) < 0.5}


def geo_flow(params: Params, h: int, w: int) -> torch.Tensor:
    """The displacement field (B, H, W, 2) of the inverse affine: output
    pixel p samples the input at
    c + R(-angle)/scale * flip_x * (p - c) - t * (W, H),
    in the JAX package's order of operations."""
    dev = params["scale"].device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    dx = (xs - cx)[None]  # (1, H, W)
    dy = (ys - cy)[None]
    ang = params["angle"].float()[:, None, None]
    inv_s = 1.0 / params["scale"].float()[:, None, None]
    fx = torch.where(params["flip"], -1.0, 1.0).float()[:, None, None]
    cos, sin = torch.cos(-ang), torch.sin(-ang)
    dxf = dx * fx  # flip about the vertical axis first (in output space)
    src_x = cx + inv_s * (cos * dxf - sin * dy) \
        - params["tx"].float()[:, None, None] * w
    src_y = cy + inv_s * (sin * dxf + cos * dy) \
        - params["ty"].float()[:, None, None] * h
    return torch.stack([src_x - xs[None], src_y - ys[None]], dim=-1)


def apply_geo(images: Sequence[torch.Tensor], params: Params
              ) -> list[torch.Tensor]:
    """Resample each of `images` (B, H, W, C), float32, by the per-sample
    inverse affine of `params`: all of them in one warp launch on the
    card (one level each, one shared flow), none copied."""
    b, h, w, _ = images[0].shape
    flow = geo_flow(params, h, w)
    return warp_levels_forward(list(images), [flow] * len(images),
                               site="augment")


def sample_photo_params(g: torch.Generator, batch: int) -> Params:
    """Per-sample photometric parameters, shaped to broadcast over
    (B, H, W, 3): contrast, brightness, colour (per channel), gamma and
    the noise's sigma."""
    return {"contrast": _uniform(g, (batch, 1, 1, 1), *CONTRAST),
            "brightness": torch.randn((batch, 1, 1, 1), generator=g,
                                      device=g.device) * BRIGHTNESS_SIGMA,
            "color": _uniform(g, (batch, 1, 1, 3), *COLOR_RANGE),
            "gamma": _uniform(g, (batch, 1, 1, 1), *GAMMA_RANGE),
            "sigma": _uniform(g, (batch, 1, 1, 1), 0.0, NOISE_SIGMA_MAX)}


def apply_photo(frames: Sequence[torch.Tensor], params: Params,
                noises: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Contrast, brightness, colour, gamma and noise on 0-255 frames,
    the same parameters for every frame of a sample; `noises` are
    standard normal draws shaped as the frames (scaled by sigma here)."""
    out = []
    for f, n in zip(frames, noises):
        x = f / 255.0
        x = x * (1.0 + params["contrast"])  # contrast about black
        x = x + params["brightness"]
        x = x * params["color"]
        x = torch.clamp(x, 0.0, 1.0) ** params["gamma"]
        x = torch.clamp(x + n * params["sigma"], 0.0, 1.0)
        out.append(x * 255.0)
    return out


def _cat(rows: list[Params]) -> Params:
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def augment_batch(batch: dict, seed, geo: bool = True,
                  photo: bool = True) -> dict:
    """Dual-stream augmentation of a batch of tensors: `source`/`target`
    (B, H, W, 3), or K stacked micro-batches (K, B, H, W, 3) with one
    seed each (`seed` an int, or a sequence of K ints). Returns the batch
    with the geometric-only source/target and, with `photo`, the
    photometric net_source/net_target; other entries pass through. The
    K micro-batches take one warp launch together, and each gets what it
    would get alone."""
    src, tgt = batch["source"], batch["target"]
    seeds = [int(s) for s in np.atleast_1d(np.asarray(seed))]
    if len(seeds) != (src.shape[0] if src.dim() == 5 else 1):
        raise ValueError(f"augment_batch: {len(seeds)} seeds for a batch "
                         f"of shape {tuple(src.shape)}")
    lead = src.shape[:-3]
    b = src.shape[-4]
    flat = [t.reshape(-1, *t.shape[-3:]) for t in (src, tgt)]
    dev = src.device
    out = dict(batch)
    if geo:
        params = _cat([sample_geo_params(generator(s, _GEO, dev), b)
                       for s in seeds])
        flat = apply_geo(flat, params)
        out["source"], out["target"] = (t.reshape(*lead, *t.shape[1:])
                                        for t in flat)
    if photo:
        rows, noises = [], [[], []]
        for s in seeds:
            g = generator(s, _PHOTO, dev)
            rows.append(sample_photo_params(g, b))
            for i, t in enumerate(flat):
                noises[i].append(torch.randn((b, *t.shape[1:]), generator=g,
                                             device=dev))
        nets = apply_photo(flat, _cat(rows), [torch.cat(n) for n in noises])
        out["net_source"], out["net_target"] = (
            t.reshape(*lead, *t.shape[1:]) for t in nets)
    return out


def make_augment_fn(geo: bool, photo: bool):
    """The train loop's transform of a staged batch (tensors on the
    device, `SEED_KEY` on the host): `augment_batch` under its seed(s).
    None when neither family is on."""
    if not (geo or photo):
        return None

    def fn(batch: dict) -> dict:
        with torch.no_grad():
            return augment_batch(batch, batch[SEED_KEY], geo=geo,
                                 photo=photo)

    return fn
