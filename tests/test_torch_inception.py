"""The port's Inception-v3 flow model (`models/inception_v3_flow.py`)
against the flax model, through the weight converter: the pyramid at an
input size that is a multiple of 32 and at an odd one (70 x 100: the
-inf max-pool pad, the counted avg-pool pad and the scale-1 deconv's
crop at every odd level), the tap widths, a T = 3 volume, and the scale-1
deconv alone against flax's SAME ConvTranspose.

Every flax parameter is a RandomState normal (the bilinear deconv init
is symmetric and would hide a missing kernel flip), drawn for the shapes
`jax.eval_shape` gives; the JAX side runs under `jax.jit` on the CPU.
Pyramids agree at atol/rtol 1e-4, as in test_torch_models.py: float32
convolutions sum in another order in XLA and in PyTorch (measured at
most 1.0e-6 on these inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.models.common import Deconv
from deepof_tpu_torch.models.inception_v3_flow import (TAPS,
                                                       InceptionV3Flow)
from deepof_tpu_torch.models.registry import build_model

WIDTH = 0.25


def _random_params(shapes, rs):
    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return (rs.randn(*a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, shapes)


def _compare(x, flow_channels=2):
    """The flax and the port's pyramids of `x` (B, H, W, C), from the same
    random parameters; returns the port's level shapes."""
    rs = np.random.RandomState(x.shape[1])
    jm = jax_build_model("inception_v3", flow_channels=flow_channels,
                         width_mult=WIDTH)
    params = _random_params(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"], rs)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params,
                                                           jnp.asarray(x))
    model = build_model("inception_v3", flow_channels=flow_channels,
                        width_mult=WIDTH, device="cpu")
    load_flax_params(model, params)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 6
    shapes = []
    for level, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, level
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {level}")
        shapes.append(g.shape[1:])
    return shapes


@pytest.mark.parametrize("hw,levels", [
    ((64, 96), [(32, 48), (16, 24), (8, 12), (8, 12), (4, 6), (2, 3)]),
    # odd at every level: pads low 0 / high 1 or 1 / 1, crops
    ((70, 100), [(35, 50), (18, 25), (9, 13), (9, 13), (5, 7), (3, 4)])])
def test_pyramid_matches_flax(hw, levels):
    x = np.random.RandomState(1).randn(2, *hw, 6).astype(np.float32)
    shapes = _compare(x)
    assert shapes == [(*s, 2) for s in levels]


def test_volume_pyramid_matches_flax():
    """T = 3: 9 input channels, flow_channels = 4 on every level."""
    x = np.random.RandomState(2).randn(1, 64, 64, 9).astype(np.float32)
    shapes = _compare(x, flow_channels=4)
    assert [s[-1] for s in shapes] == [4] * 6


@pytest.mark.parametrize("width_mult,taps", [
    (1.0, (2048, 768, 288, 192, 64, 32)),
    (WIDTH, (512, 192, 72, 48, 16, 8))])
def test_tap_widths(width_mult, taps):
    model = InceptionV3Flow(width_mult=width_mult)
    assert tuple(model.encoder.taps[t] for t in TAPS) == taps
    assert model.flow_scales == (10.0, 5.0, 2.5, 2.5, 1.25, 0.625)
    assert model.max_downsample == 32


def test_scale_one_deconv_cropped_is_flax_same():
    """The stride-1 2x2 transposed conv: flax's SAME output is the first
    H x W of the port's (H+1) x (W+1), with the converter's flipped
    kernel."""
    rs = np.random.RandomState(3)
    x = rs.randn(2, 7, 9, 5).astype(np.float32)
    fl = fnn.ConvTranspose(4, (2, 2), strides=(1, 1), padding="SAME")
    params = _random_params(jax.eval_shape(
        fl.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"], rs)
    want = np.asarray(fl.apply({"params": params}, jnp.asarray(x)))
    layer = Deconv(5, 4, scale=1, act=False)
    load_flax_params(layer, {"ConvTranspose_0": params})
    with torch.no_grad():
        got = layer(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 4, 8, 10)
    np.testing.assert_allclose(got[..., :7, :9].permute(0, 2, 3, 1).numpy(),
                               want, atol=1e-5, rtol=1e-5)
