"""The PyTorch port's loss path against the JAX package's: LRN, the
smoothness ops, the masks, `loss_interp`, `pyramid_loss` and its
antialiased resize.

Inputs are numpy draws from fixed seeds, fed to both packages.
Tolerances, each with its reason:
  - ops, masks and the resize: 1e-6 absolute (elementwise float32
    arithmetic; the antialiased resize weights are computed in another
    order, measured 1.8e-7 at every downscale the pyramid uses); the
    Sobel and difference ops of 0-255 images: 1e-4 absolute;
  - loss values: 5e-5 relative. Each is a float32 sum over up to 10^4
    terms. XLA's CPU reduction is the less exact of the two: on the
    2048-term V_loss of the 32x32 level it is 1.7e-5 away from a float64
    sum of the same float32 terms, PyTorch's 1e-7;
  - flow gradients: 1e-3 relative plus 1e-4 of the largest gradient of
    the level. The photometric gradient goes as |x|^(2 alpha_c - 1) =
    |x|^-0.5 of x = 255 (recon - input), a difference of nearly equal
    numbers at some pixels, so a float32 rounding of the warped image
    there moves the gradient by up to ~2e-4 of its value.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.losses import photometric as jph
from deepof_tpu.losses import pyramid as jpy
from deepof_tpu.ops import smoothness as jsm
from deepof_tpu.ops.lrn import local_response_normalization as jax_lrn
from deepof_tpu_torch.core.config import LossConfig
from deepof_tpu_torch.losses import photometric as tph
from deepof_tpu_torch.losses import pyramid as tpy
from deepof_tpu_torch.ops import smoothness as tsm
from deepof_tpu_torch.ops.lrn import local_response_normalization

KEYS = ("total", "Charbonnier_reconstruct", "U_loss", "V_loss", "smooth")

# (loss overrides, smooth_border_mask): the default branch and its options
VARIANTS = [({}, False), ({}, True), ({"smoothness_order": 2}, False),
            ({"smooth_scaled_flow": False, "lambda_smooth": 0.5}, False)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(**kw):
    return JaxLossConfig(**kw), LossConfig(**kw)


@pytest.mark.parametrize("c", [3, 12])
def test_lrn_matches_jax(c):
    x = np.random.RandomState(c).randn(2, 5, 7, c).astype(np.float32)
    np.testing.assert_allclose(local_response_normalization(_t(x)).numpy(),
                               np.asarray(jax_lrn(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["forward_diff_x", "forward_diff_y",
                                  "second_diff_x", "second_diff_y",
                                  "sobel_gradients", "to_grayscale"])
def test_smoothness_ops_match_jax(name):
    rs = np.random.RandomState(1)
    x = rs.rand(2, 6, 9, 1 if name == "sobel_gradients" else 3)
    x = x.astype(np.float32) * 255
    got = getattr(tsm, name)(_t(x))
    want = getattr(jsm, name)(jnp.asarray(x))
    if name != "sobel_gradients":
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=1e-6)


@pytest.mark.parametrize("h,w,ratio,min_width", [
    (32, 32, 0.1, 0), (12, 16, 0.1, 0), (2, 2, 0.1, 0), (1, 1, 0.1, 0),
    (24, 40, 0.25, 0), (10, 12, 0.1, 3)])
def test_masks_match_jax(h, w, ratio, min_width):
    np.testing.assert_array_equal(
        tph.border_mask(h, w, ratio, min_width).numpy(),
        np.asarray(jph.border_mask(h, w, ratio, min_width)))
    np.testing.assert_array_equal(tph.smoothness_mask_x(h, w).numpy(),
                                  np.asarray(jph.smoothness_mask_x(h, w)))
    np.testing.assert_array_equal(tph.smoothness_mask_y(h, w).numpy(),
                                  np.asarray(jph.smoothness_mask_y(h, w)))


def _level_inputs(rs, b, h, w):
    flow = (rs.randn(b, h, w, 2) * 0.5).astype(np.float32)
    prev = rs.rand(b, h, w, 3).astype(np.float32)
    nxt = rs.rand(b, h, w, 3).astype(np.float32)
    return flow, prev, nxt


@pytest.mark.parametrize("kw,sbm", VARIANTS)
def test_loss_interp_matches_jax(kw, sbm):
    jcfg, tcfg = _cfgs(**kw)
    flow, prev, nxt = _level_inputs(np.random.RandomState(2), 2, 20, 28)
    want, wrec = jph.loss_interp(jnp.asarray(flow), jnp.asarray(prev),
                                 jnp.asarray(nxt), 2.5, jcfg, sbm)
    got, rec = tph.loss_interp(_t(flow), _t(prev), _t(nxt), 2.5, tcfg, sbm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=5e-5, err_msg=k)
    np.testing.assert_allclose(rec.numpy(), np.asarray(wrec), atol=1e-5)


def _pyramid(rs, b=2, size=64):
    """Six flow levels of a FlowNet at size x size: 32 down to 1, the
    2x2 and 1x1 levels without a border-mask interior."""
    flows = [(rs.randn(b, size >> (k + 1), size >> (k + 1), 2)
              * 0.5).astype(np.float32) for k in range(6)]
    scales = [10.0 / 2 ** k for k in range(6)]
    imgs = [rs.rand(b, size, size, 3).astype(np.float32) * 255
            for _ in range(2)]
    return flows, scales, imgs


def _jax_pyramid(flows, scales, imgs, cfg, sbm):
    src, tgt = (jpy.lrn_normalize(jpy.preprocess(jnp.asarray(i),
                                                 (97.5, 99.2, 97.1)))
                for i in imgs)

    def total(fs):
        tot, losses, rec = jpy.pyramid_loss(list(zip(fs, scales)), src, tgt,
                                            cfg, sbm)
        return tot, (losses, rec)

    # op by op, as the JAX tests run it: jit's fusions round the
    # photometric difference elsewhere (see the gradient tolerance)
    (tot, (losses, rec)), grads = jax.value_and_grad(total, has_aux=True)(
        [jnp.asarray(f) for f in flows])
    return tot, losses, rec, grads


@pytest.mark.parametrize("kw,sbm", VARIANTS[:2])
def test_pyramid_loss_and_flow_gradients_match_jax(kw, sbm):
    jcfg, tcfg = _cfgs(**kw)
    flows, scales, imgs = _pyramid(np.random.RandomState(3))
    jtot, jlosses, jrec, jgrads = _jax_pyramid(flows, scales, imgs, jcfg,
                                               sbm)

    tflows = [_t(f).requires_grad_(True) for f in flows]
    src, tgt = (tpy.lrn_normalize(tpy.preprocess(_t(i), (97.5, 99.2, 97.1)))
                for i in imgs)
    tot, losses, rec = tpy.pyramid_loss(list(zip(tflows, scales)), src, tgt,
                                        tcfg, sbm)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=5e-5)
    np.testing.assert_allclose(rec.detach().numpy(), np.asarray(jrec),
                               atol=1e-5)
    for level, (got, want) in enumerate(zip(losses, jlosses)):
        for k in KEYS:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=5e-5, atol=1e-7,
                                       err_msg=f"level {level} {k}")
    # the 2x2 and 1x1 levels have no interior: exactly zero terms
    for level in (4, 5):
        assert losses[level]["total"].item() == 0.0
    for level, (f, want) in enumerate(zip(tflows, jgrads)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * scale,
                                   err_msg=f"flow gradient, level {level}")


@pytest.mark.parametrize("hw", [(32, 48), (16, 24), (8, 12), (4, 6),
                                (2, 3), (1, 2), (64, 96)])
def test_loss_resize_is_antialiased_like_jax(hw):
    x = np.random.RandomState(4).rand(2, 64, 96, 3).astype(np.float32)
    want = jpy._resize(jnp.asarray(x), *hw)
    np.testing.assert_allclose(tpy._resize(_t(x), *hw).numpy(),
                               np.asarray(want), atol=1e-6)


def test_unported_loss_settings_raise():
    """Of the loss settings, only gather_dtype='bfloat16' is refused
    (F11); the others run (test_torch_loss_variants.py holds them to
    JAX), or raise the JAX package's ValueError on a bad
    pairing (edge_aware with canonical smoothness)."""
    flow, prev, nxt = _level_inputs(np.random.RandomState(5), 1, 8, 8)
    for kw in ({"photometric": "census"}, {"smoothness": "depthwise"},
               {"gather_dtype": "bfloat16"}, {"edge_aware": True},
               {"edge_aware_photo": True}, {"occlusion": True}):
        cfg = dataclasses.replace(LossConfig(), **kw)
        if "gather_dtype" in kw:
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                tpy.pyramid_loss([(_t(flow), 1.0)], _t(prev), _t(nxt), cfg)
        elif "edge_aware" in kw:
            with pytest.raises(ValueError, match="depthwise"):
                tpy.pyramid_loss([(_t(flow), 1.0)], _t(prev), _t(nxt), cfg)
        else:
            total, _, _ = tpy.pyramid_loss([(_t(flow), 1.0)], _t(prev),
                                           _t(nxt), cfg)
            assert torch.isfinite(total), kw
