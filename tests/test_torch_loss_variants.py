"""The rest of the two-frame loss family in the port against the JAX
package: depthwise smoothness, with the Sobel `edge_aware` weights,
`edge_aware_photo` with both smoothness branches, the census photometric
term (two-frame and volume) and the forward-backward occlusion mask, at
a level with a border-mask interior (24 x 32) and one without (2 x 3);
the census ops; the Sobel preprocessing; the ValueErrors of the JAX
functions on bad pairings.

Inputs are numpy draws from fixed seeds; the JAX losses run on the CPU
(its warp is the XLA route) op by op, and the census ones and the
pyramid under `jax.jit` (op by op, the 49-slice census takes 12-16 s a
test). Under jit, XLA fuses 255 (recon - input) into the Charbonnier
term and rounds it apart where the two nearly cancel: with the
`edge_aware_photo` weight the flow gradient then moved by 2.5e-3 of the
level's largest at 2 of 3072 entries, so those variants run op by op,
as test_torch_loss.py runs its loss. Tolerances, as in test_torch_loss.py and
for its reasons: loss values 5e-5 relative (the float32 sums round
apart, XLA's the less exact), flow gradients 1e-3 relative plus 1e-4 of
the level's largest (the Charbonnier gradient amplifies a rounding of
the warped image where recon and input nearly cancel), the Sobel masks
1e-5 absolute, census descriptors and distances 1e-4 (measured 1.4e-5:
a descriptor is a difference of two grayscale values of up to 255,
whose float32 ulp is 1.5e-5, and the packages round the grayscale dot
product apart).

The Sobel floor (ROADMAP Queue C): `_normalized_sobel` floors
255 (x - min) / (max - min), and a value within an ulp of an integer
could floor apart in the two packages. On 460,800 pixels of LRN-
normalised and uniform inputs (20 seeds, the shapes below) it floored
alike at every pixel, op by op and under `jax.jit` (241 of them lay
within 1e-4 of an integer, the extremes among them);
`test_the_sobel_floor_lands_alike` pins it on 4 seeds. So the edge-aware
variants keep the tolerances above; a pixel that floored apart would
move its Sobel responses by 1-2 units of up to ~1000 and a mask by up to
2e-3.
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
from deepof_tpu.ops import census as jcensus
from deepof_tpu_torch.core.config import LossConfig
from deepof_tpu_torch.losses import photometric as tph
from deepof_tpu_torch.losses import pyramid as tpy
from deepof_tpu_torch.ops import census as tcensus

KEYS = ("total", "Charbonnier_reconstruct", "U_loss", "V_loss", "smooth")
MEAN = (104.920005, 110.1753, 114.785955)

VARIANTS = {
    "depthwise": {"smoothness": "depthwise"},
    "depthwise_edge_aware": {"smoothness": "depthwise", "edge_aware": True},
    "edge_aware_photo_canonical": {"edge_aware_photo": True},
    "edge_aware_photo_depthwise": {"smoothness": "depthwise",
                                   "edge_aware_photo": True,
                                   "edge_aware": True},
    "census": {"photometric": "census"},
    "census_depthwise": {"photometric": "census",
                         "smoothness": "depthwise"},
}
LEVELS = {"interior": (24, 32), "no_interior": (2, 3)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _lrn(x):
    """LRN-normalised frames (the BGR mean of each), as the loss receives
    them."""
    mean = jnp.asarray(MEAN * (x.shape[-1] // 3))
    return np.asarray(jpy.lrn_normalize(jpy.preprocess(jnp.asarray(x),
                                                       mean)))


def _inputs(rs, b, h, w, mag=0.5):
    flow = (rs.randn(b, h, w, 2) * mag).astype(np.float32)
    prev = _lrn(rs.rand(b, h, w, 3).astype(np.float32) * 255)
    nxt = _lrn(rs.rand(b, h, w, 3).astype(np.float32) * 255)
    return flow, prev, nxt


def _compare_losses(got, want):
    assert set(got) == set(want)
    for k in KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=5e-5,
                                   atol=1e-7, err_msg=k)


def _compare_grad(got, want, what):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3,
                               atol=1e-4 * scale, err_msg=what)


@pytest.mark.parametrize("level", sorted(LEVELS))
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_two_frame_variant_matches_jax(name, level):
    kw = VARIANTS[name]
    h, w = LEVELS[level]
    flow, prev, nxt = _inputs(np.random.RandomState(h + len(name)), 2, h, w)

    def jtotal(f):
        ld, rec = jph.loss_interp(f, jnp.asarray(prev), jnp.asarray(nxt),
                                  2.5, JaxLossConfig(**kw))
        return ld["total"], (ld, rec)

    grad_fn = jax.value_and_grad(jtotal, has_aux=True)
    if "census" in name:
        grad_fn = jax.jit(grad_fn)
    (_, (want, wrec)), wgrad = grad_fn(jnp.asarray(flow))
    tf = _t(flow).requires_grad_(True)
    got, rec = tph.loss_interp(tf, _t(prev), _t(nxt), 2.5, LossConfig(**kw))
    got["total"].backward()
    _compare_losses(got, want)
    np.testing.assert_allclose(rec.detach().numpy(), np.asarray(wrec),
                               atol=1e-5)
    _compare_grad(tf.grad, wgrad, f"{name} flow gradient")
    if level == "no_interior":
        assert float(got["U_loss"]) == float(got["V_loss"]) == 0.0


@pytest.mark.parametrize("photometric", ["charbonnier", "census"])
def test_occlusion_pyramid_matches_jax(photometric, monkeypatch):
    """The occlusion mask through `pyramid_loss` on two levels (one
    without an interior): the backward flows of both warped in one call
    (C = 2), no gradient through the mask, the loss and the forward
    flows' gradients as JAX's; and `occlusion_mask` alone equal."""
    kw = {"occlusion": True, "photometric": photometric, "weights": (4, 1)}
    rs = np.random.RandomState(3)
    sizes, scales = [(24, 32), (2, 3)], [5.0, 2.5]
    fw = [(rs.randn(2, h, w, 2) * 0.7).astype(np.float32) for h, w in sizes]
    bw = [(-f + rs.randn(*f.shape) * 0.3).astype(np.float32) for f in fw]
    # some pixels occluded, some visible
    prev = _lrn(rs.rand(2, 48, 64, 3).astype(np.float32) * 255)
    nxt = _lrn(rs.rand(2, 48, 64, 3).astype(np.float32) * 255)

    def jtotal(fs):
        tot, losses, _ = jpy.pyramid_loss(
            list(zip(fs, scales)), jnp.asarray(prev), jnp.asarray(nxt),
            JaxLossConfig(**kw), flow_pyramid_bw=[jnp.asarray(b)
                                                  for b in bw])
        return tot, losses

    (jtot, jlosses), jgrads = jax.jit(jax.value_and_grad(
        jtotal, has_aux=True))([jnp.asarray(f) for f in fw])
    calls = []
    warp = tpy.warp_levels_forward

    def counted(images, flows, impl="auto", site="loss"):
        calls.append((site, [tuple(i.shape) for i in images]))
        return warp(images, flows, impl, site)

    monkeypatch.setattr(tpy, "warp_levels_forward", counted)
    tfw = [_t(f).requires_grad_(True) for f in fw]
    tot, losses, _ = tpy.pyramid_loss(
        list(zip(tfw, scales)), _t(prev), _t(nxt), LossConfig(**kw),
        flow_pyramid_bw=[_t(b) for b in bw])
    tot.backward()
    assert calls == [("occlusion", [(2, 24, 32, 2), (2, 2, 3, 2)])]
    np.testing.assert_allclose(float(tot), float(jtot), rtol=5e-5)
    for got, want in zip(losses, jlosses):
        _compare_losses(got, want)
    for k, (f, g) in enumerate(zip(tfw, jgrads)):
        _compare_grad(f.grad, g, f"level {k} flow gradient")
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)
    want = jph.occlusion_mask(jnp.asarray(fw[0] * 5), jnp.asarray(bw[0] * 5),
                              jcfg)
    got = tph.occlusion_mask(_t(fw[0] * 5), _t(bw[0] * 5), tcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < float(got.mean()) < 1


@pytest.mark.parametrize("h,w", [(24, 32), (2, 3)])
def test_census_volume_matches_jax(h, w):
    kw = {"photometric": "census"}
    rs = np.random.RandomState(h)
    t = 3
    flows = (rs.randn(2, h, w, 2 * (t - 1)) * 0.5).astype(np.float32)
    vol = _lrn(rs.rand(2, h, w, 3 * t).astype(np.float32) * 255)

    def jtotal(f):
        ld, rec = jph.loss_interp_multi(f, jnp.asarray(vol), 2.5,
                                        JaxLossConfig(**kw))
        return ld["total"], (ld, rec)

    (_, (want, _)), wgrad = jax.jit(jax.value_and_grad(
        jtotal, has_aux=True))(jnp.asarray(flows))
    tf = _t(flows).requires_grad_(True)
    got, _ = tph.loss_interp_multi(tf, _t(vol), 2.5, LossConfig(**kw))
    got["total"].backward()
    _compare_losses(got, want)
    _compare_grad(tf.grad, wgrad, "volume census flow gradient")


def test_census_ops_match_jax():
    rs = np.random.RandomState(4)
    a = rs.rand(2, 9, 13, 3).astype(np.float32)
    b = rs.rand(2, 9, 13, 3).astype(np.float32)
    for window in (3, 7):
        ja = jcensus.census_transform(jnp.asarray(a), window)
        jb = jcensus.census_transform(jnp.asarray(b), window)
        ta = tcensus.census_transform(_t(a), window)
        tb = tcensus.census_transform(_t(b), window)
        assert ta.shape == (2, 9, 13, window ** 2)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-4)
        np.testing.assert_allclose(
            tcensus.census_distance(ta, tb).numpy(),
            np.asarray(jcensus.census_distance(ja, jb)), atol=1e-4)


def test_the_sobel_floor_lands_alike():
    """`_normalized_sobel`'s floor on LRN-normalised and uniform inputs:
    the same integer image in both packages at every pixel, and the two
    edge masks within 1e-5."""
    n = 0

    @jax.jit
    def jfloor(x):
        mn = jnp.min(x, axis=(1, 2, 3), keepdims=True)
        mx = jnp.max(x, axis=(1, 2, 3), keepdims=True)
        return jnp.floor(255.0 * (x - mn) / jnp.maximum(mx - mn, 1e-12))

    for seed in range(4):
        rs = np.random.RandomState(seed)
        for x in (_lrn(rs.rand(2, 48, 64, 3).astype(np.float32) * 255),
                  rs.rand(2, 24, 32, 3).astype(np.float32)):
            t = _t(x)
            mn = t.amin(dim=(1, 2, 3), keepdim=True)
            mx = t.amax(dim=(1, 2, 3), keepdim=True)
            got = torch.floor(255.0 * (t - mn) / torch.clamp(mx - mn,
                                                             min=1e-12))
            np.testing.assert_array_equal(got.numpy(),
                                          np.asarray(jfloor(jnp.asarray(x))))
            n += x.size
            for tfn, jfn in ((tph._photo_gradient_mask,
                              jph._photo_gradient_mask),):
                np.testing.assert_allclose(tfn(t).numpy(),
                                           np.asarray(jfn(jnp.asarray(x))),
                                           atol=1e-5)
            for g, w in zip(tph._edge_aware_masks(t),
                            jph._edge_aware_masks(jnp.asarray(x))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5)
    assert n == 4 * 2 * (48 * 64 + 24 * 32) * 3


@pytest.mark.parametrize("kw,match", [
    ({"edge_aware": True}, "pairs only with smoothness='depthwise'"),
    ({"edge_aware_photo": True, "photometric": "census"},
     "pairs only with photometric='charbonnier'"),
    ({"photometric": "ssim"}, "unknown photometric variant"),
    ({"smoothness": "tv"}, "unknown smoothness variant")])
def test_bad_pairings_raise_as_in_jax(kw, match):
    flow, prev, nxt = _inputs(np.random.RandomState(6), 1, 8, 8)
    with pytest.raises(ValueError, match=match):
        jph.loss_interp(jnp.asarray(flow), jnp.asarray(prev),
                        jnp.asarray(nxt), 1.0, JaxLossConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tph.loss_interp(_t(flow), _t(prev), _t(nxt), 1.0, LossConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tpy.pyramid_loss([(_t(flow), 1.0)], _t(prev), _t(nxt),
                         LossConfig(**kw))


@pytest.mark.parametrize("kw,match", [
    ({"edge_aware_photo": True}, "edge_aware_photo is two-frame only"),
    ({"edge_aware": True}, "edge_aware is two-frame depthwise only"),
    ({"occlusion": True}, "occlusion=true is unsupported"),
    ({"smoothness": "depthwise"}, "smoothness='depthwise' is unsupported")])
def test_volume_refusals_are_the_jax_valueerrors(kw, match):
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.step import make_train_step

    rs = np.random.RandomState(7)
    flows = (rs.randn(1, 8, 8, 4) * 0.5).astype(np.float32)
    vol = rs.rand(1, 8, 8, 9).astype(np.float32)
    with pytest.raises(ValueError, match=match):
        jph.loss_interp_multi(jnp.asarray(flows), jnp.asarray(vol), 1.0,
                              JaxLossConfig(**kw))
    with pytest.raises(ValueError, match=match):
        tph.loss_interp_multi(_t(flows), _t(vol), 1.0,
                              dataclasses.replace(LossConfig(), **kw))
    # and before the first step, from the step's builder
    cfg = ExperimentConfig(model="flownet_s", width_mult=0.125,
                           loss=LossConfig(**kw),
                           data=DataConfig(time_step=3),
                           train=TrainConfig())
    model = build_model("flownet_s", flow_channels=4, width_mult=0.125,
                        device="cpu")
    with pytest.raises(ValueError, match=match):
        make_train_step(model, cfg, MEAN)
