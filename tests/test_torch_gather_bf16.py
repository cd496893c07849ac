"""`loss.gather_dtype="bfloat16"` in the PyTorch port against the JAX
package (F11), and the "affine" synthetic style against its cv2.remap
(F9).

The bf16 warp operand: each level takes one of the JAX package's two
routes, chosen by `loss.warp_impl` as the JAX package chooses on a TPU
(`ops/warp.py::pallas_route`): "xla" (`deepof_tpu/ops/warp.py`, bf16
values blended with float32 weights, a float32 result), "pallas"
(`ops/pallas/warp.py`, run here in interpret mode as
`tests/test_pallas_warp.py` runs it: the float32 result rounded to bf16,
and a bf16 cotangent), "auto" the Pallas route at W <= 128 and
H <= 128. Inputs are numpy draws from fixed seeds, fed to both packages;
the JAX losses run under jax.jit.
Tolerances, each with its reason:
  - the warp on the XLA route: 1e-5 absolute on values in [0, 1] (both
    blend in float32, in another order); flow gradients 1e-4 of the
    largest entry;
  - the warp on the Pallas route: 1 bf16 ulp (2^-8 relative): the two
    float32 blends (the port's, and the Pallas row sweep's) round once
    to bf16 and may fall on two sides of a rounding boundary;
  - the two-frame and the volume loss at one scale, on the same images
    in both packages (so the cast to bf16 is the same): values 1e-5
    relative (measured at most 1.8e-6 over four seeds and both routes),
    flow gradients 1e-3 relative plus 5e-4 of the largest entry
    (measured at most 1.1e-4 of it: jit's fusions round the photometric
    difference elsewhere, and its |x|^-0.5 gradient amplifies that);
  - the pyramid losses, whose images each package resizes itself (1.8e-7
    apart, so a cast to bf16 may round a value the other way): their
    values and every level's terms 1e-5 relative (measured at most
    4.1e-7 over five seeds); their gradients are held to the port's own
    composition of the one-scale losses above, bit for bit. (Against
    JAX's, a value rounded the other way moves the Charbonnier gradient
    |x|^-0.5 at a pixel where x is near 0: measured up to 5.9e-2 of one
    level's gradient norm under jax.jit, F6.)
The affine style: the ground-truth flow and the target equal bit for
bit; the source against cv2.remap 0.0 on the installed OpenCV (5.0.0:
a float32 fraction and fused lerps, which `remap_linear_replicate`
repeats; measured 0 of 9.2 M values apart over 5 sizes, 3 bounds and 6
seeds, and on out-of-bounds maps).
"""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.losses import photometric as jph
from deepof_tpu.losses import pyramid as jpy
from deepof_tpu.ops.pallas.warp import backward_warp_pallas
from deepof_tpu.ops.warp import backward_warp as jax_warp
from deepof_tpu_torch.core.config import DataConfig, LossConfig
from deepof_tpu_torch.data.datasets import (SyntheticData,
                                            remap_linear_replicate)
from deepof_tpu_torch.losses import photometric as tph
from deepof_tpu_torch.losses import pyramid as tpy
from deepof_tpu_torch.ops.warp import (BackwardWarpLevels,
                                       backward_warp_levels,
                                       backward_warp_reference,
                                       pallas_route, warp_flow_grad_reference,
                                       warped_dtype)

BF16_ULP = 2.0 ** -8
MEAN = (97.5, 99.2, 97.1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _warp_inputs(seed, b=2, h=12, w=20, c=3, mag=3.0):
    rs = np.random.RandomState(seed)
    img = rs.rand(b, h, w, c).astype(np.float32)
    flow = ((rs.rand(b, h, w, 2) - 0.5) * 2 * mag).astype(np.float32)
    ct = rs.randn(b, h, w, c).astype(np.float32)
    return img, flow, ct


def _jax_route(img, flow, ct, route):
    """The JAX warp of a bf16 image on `route`, its output in float32,
    and the flow gradient of <out, ct> with the cotangent in the
    output's dtype."""
    fn = ((lambda f: backward_warp_pallas(img_b, f)) if route == "pallas"
          else (lambda f: jax_warp(img_b, f, impl="xla")))
    img_b = jnp.asarray(img).astype(jnp.bfloat16)
    out, vjp = jax.vjp(fn, jnp.asarray(flow))
    (g,) = vjp(jnp.asarray(ct).astype(out.dtype))
    return out, np.asarray(out.astype(jnp.float32)), np.asarray(g)


@pytest.mark.parametrize("route", ["xla", "pallas"])
def test_bf16_warp_and_flow_gradient_match_each_jax_route(route):
    img, flow, ct = _warp_inputs(0)
    jout, want, gwant = _jax_route(img, flow, ct, route)
    pallas = route == "pallas"
    ti = _t(img).bfloat16().permute(0, 3, 1, 2)
    tf = _t(flow).permute(0, 3, 1, 2).requires_grad_(True)
    out = BackwardWarpLevels.apply((pallas,), ti, tf)[0]
    assert out.dtype == (torch.bfloat16 if pallas else torch.float32)
    assert str(jout.dtype) == ("bfloat16" if pallas else "float32")
    got = out.float().permute(0, 2, 3, 1).detach().numpy()
    if pallas:
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=0)
    else:
        np.testing.assert_allclose(got, want, atol=1e-5)
    tct = _t(ct).permute(0, 3, 1, 2).to(out.dtype)
    (out * tct).float().sum().backward()
    scale = float(np.abs(gwant).max())
    np.testing.assert_allclose(tf.grad.permute(0, 2, 3, 1).numpy(), gwant,
                               atol=1e-4 * scale)
    # the flow gradient is the plain version's, the cotangent read as the
    # output's dtype, bit for bit
    assert torch.equal(tf.grad, warp_flow_grad_reference(
        ti, tf.detach(), tct))


def test_the_two_routes_differ_and_auto_takes_the_tpu_route_per_level():
    """The routes are visible: on a bf16 image the XLA route's float32
    output is not the Pallas route's bf16 one. "auto" takes, level by
    level, the route the JAX package takes on a TPU: Pallas for the
    level of W <= 128 and H <= 128, XLA for the wider one."""
    img, flow, _ = _warp_inputs(2, h=8, w=136)
    small = img[:, :, :64], flow[:, :, :64]
    xla = backward_warp_reference(_t(img).bfloat16().permute(0, 3, 1, 2),
                                  _t(flow).permute(0, 3, 1, 2))
    pal = backward_warp_reference(_t(img).bfloat16().permute(0, 3, 1, 2),
                                  _t(flow).permute(0, 3, 1, 2), pallas=True)
    assert xla.dtype == torch.float32 and pal.dtype == torch.bfloat16
    assert not torch.equal(xla, pal.float())
    assert torch.equal(xla.bfloat16(), pal)  # the same float32 blend
    assert [pallas_route("auto", 8, w) for w in (136, 64)] == [False, True]
    assert [pallas_route("auto", 129, 64), pallas_route("xla", 8, 64),
            pallas_route("pallas", 8, 136)] == [False, False, True]
    assert warped_dtype(torch.float32, True) == torch.float32
    outs = backward_warp_levels(
        [_t(img).bfloat16(), _t(small[0]).bfloat16()],
        [_t(flow), _t(small[1])], impl="auto")
    assert [o.dtype for o in outs] == [torch.float32, torch.bfloat16]
    wide = np.asarray(jax_warp(jnp.asarray(img).astype(jnp.bfloat16),
                               jnp.asarray(flow), impl="xla"))
    narrow = np.asarray(backward_warp_pallas(
        jnp.asarray(small[0]).astype(jnp.bfloat16),
        jnp.asarray(small[1])).astype(jnp.float32))
    np.testing.assert_allclose(outs[0].numpy(), wide, atol=1e-5)
    np.testing.assert_allclose(outs[1].float().numpy(), narrow,
                               rtol=BF16_ULP, atol=0)


def _grad_check(got, want):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4 * scale)


def _check_terms(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_loss_interp_matches_jax(impl):
    """The two-frame loss at one scale, the same images in both
    packages."""
    rs = np.random.RandomState(6)
    flow = (rs.randn(2, 20, 28, 2) * 0.5).astype(np.float32)
    prev, nxt = (rs.rand(2, 20, 28, 3).astype(np.float32) for _ in range(2))
    kw = dict(gather_dtype="bfloat16", warp_impl=impl)
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)

    def jloss(f):
        ld, rec = jph.loss_interp(f, jnp.asarray(prev), jnp.asarray(nxt),
                                  2.5, jcfg)
        return ld["total"], (ld, rec)

    (_, (want, wrec)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(flow))
    tf = _t(flow).requires_grad_(True)
    got, rec = tph.loss_interp(tf, _t(prev), _t(nxt), 2.5, tcfg)
    assert rec.dtype == torch.float32 and str(wrec.dtype) == "float32"
    _check_terms(got, want)
    got["total"].backward()
    _grad_check(tf.grad.numpy(), jg)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_volume_loss_interp_matches_jax(impl):
    """The T-frame volume loss at one scale (T = 3), the same volume in
    both packages: the pairs warped in bf16 on the route of `impl`."""
    rs = np.random.RandomState(5)
    t = 3
    flows = (rs.randn(1, 16, 16, 2 * (t - 1)) * 0.5).astype(np.float32)
    vol = rs.rand(1, 16, 16, 3 * t).astype(np.float32)
    kw = dict(gather_dtype="bfloat16", warp_impl=impl)
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)

    def jloss(f):
        ld, rec = jph.loss_interp_multi(f, jnp.asarray(vol), 2.5, jcfg)
        return ld["total"], (ld, rec)

    (_, (want, wrec)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(flows))
    tf = _t(flows).requires_grad_(True)
    got, rec = tph.loss_interp_multi(tf, _t(vol), 2.5, tcfg)
    assert rec.dtype == torch.float32 and str(wrec.dtype) == "float32"
    _check_terms(got, want)
    got["total"].backward()
    _grad_check(tf.grad.numpy(), jg)


def _composed(flows, scales, src, tgt, cfg, routes):
    """The port's pyramid loss composed from its one-scale losses, each
    level warped alone on its route (`routes`: impl by level)."""
    total = torch.zeros(())
    for k, (f, s) in enumerate(zip(flows, scales)):
        h, w = f.shape[1:3]
        c = dataclasses.replace(cfg, warp_impl=routes[k])
        ld, _ = tph.loss_interp(f, tpy._resize(src, h, w),
                                tpy._resize(tgt, h, w), s, c)
        total = total + cfg.weights[k] * ld["total"]
    return total


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_pyramid_losses_match_jax(impl):
    """The two-frame pyramid (4 levels, 32x32 down) and the volume
    pyramid (T = 3, 3 levels): values and every level's terms against
    JAX; the two-frame gradients against the port's composition of
    `loss_interp` (held to JAX above)."""
    rs = np.random.RandomState(6)
    b, size = 2, 32
    flows = [(rs.randn(b, size >> (k + 1), size >> (k + 1), 2)
              * 0.5).astype(np.float32) for k in range(4)]
    scales = [10.0 / 2 ** k for k in range(4)]
    imgs = [rs.rand(b, size, size, 3).astype(np.float32) * 255
            for _ in range(2)]
    kw = dict(gather_dtype="bfloat16", warp_impl=impl,
              weights=(16.0, 8.0, 4.0, 2.0))
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)
    jsrc, jtgt = (jpy.lrn_normalize(jpy.preprocess(jnp.asarray(i), MEAN))
                  for i in imgs)
    jtot, jlosses, _ = jax.jit(lambda fs: jpy.pyramid_loss(
        list(zip(fs, scales)), jsrc, jtgt, jcfg))(
            [jnp.asarray(f) for f in flows])
    tflows = [_t(f).requires_grad_(True) for f in flows]
    src, tgt = (tpy.lrn_normalize(tpy.preprocess(_t(i), MEAN)) for i in imgs)
    tot, losses, rec = tpy.pyramid_loss(list(zip(tflows, scales)), src, tgt,
                                        tcfg)
    assert rec.dtype == torch.float32
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for got, want in zip(losses, jlosses):
        _check_terms(got, want)
    tot.backward()
    grads = [f.grad.clone() for f in tflows]
    for f in tflows:
        f.grad = None
    _composed(tflows, scales, src, tgt, tcfg, [impl] * 4).backward()
    assert all(torch.equal(g, f.grad) for g, f in zip(grads, tflows))

    t = 3
    vol = rs.rand(1, size, size, 3 * t).astype(np.float32) * 255
    vflows = [(rs.randn(1, size >> (k + 1), size >> (k + 1), 2 * (t - 1))
               * 0.5).astype(np.float32) for k in range(3)]
    vkw = dict(kw, weights=(4.0, 2.0, 1.0), lambda_smooth=0.5)
    jvol = jpy.lrn_normalize(jpy.preprocess(jnp.asarray(vol), MEAN * t))
    jvtot, jvlosses, _ = jax.jit(lambda fs: jpy.pyramid_loss_multi(
        list(zip(fs, scales)), jvol, JaxLossConfig(**vkw)))(
            [jnp.asarray(f) for f in vflows])
    vtot, vlosses, vrec = tpy.pyramid_loss_multi(
        list(zip([_t(f) for f in vflows], scales)),
        tpy.lrn_normalize(tpy.preprocess(_t(vol), MEAN * t)),
        LossConfig(**vkw))
    assert vrec.dtype == torch.float32
    np.testing.assert_allclose(float(vtot), float(jvtot), rtol=1e-5)
    for got, want in zip(vlosses, jvlosses):
        _check_terms(got, want)


def test_bf16_auto_pyramid_takes_the_tpu_route_level_by_level():
    """Under "auto" a level of W > 128 takes the XLA route and the
    narrower ones the Pallas route: the pyramid equals its composition
    with those routes, bit for bit in value and gradients, and differs
    from the all-XLA pyramid."""
    rs = np.random.RandomState(9)
    sizes = [(8, 136), (4, 68), (2, 34)]
    flows = [_t((rs.randn(2, h, w, 2) * 0.5).astype(np.float32))
             .requires_grad_(True) for h, w in sizes]
    scales = [10.0, 5.0, 2.5]
    src, tgt = (tpy.lrn_normalize(tpy.preprocess(
        _t(rs.rand(2, 16, 272, 3).astype(np.float32) * 255), MEAN))
        for _ in range(2))
    cfg = LossConfig(gather_dtype="bfloat16", warp_impl="auto",
                     weights=(4.0, 2.0, 1.0))
    routes = ["pallas" if pallas_route("auto", h, w) else "xla"
              for h, w in sizes]
    assert routes == ["xla", "pallas", "pallas"]
    tot, _, _ = tpy.pyramid_loss(list(zip(flows, scales)), src, tgt, cfg)
    tot.backward()
    grads = [f.grad.clone() for f in flows]
    for f in flows:
        f.grad = None
    want = _composed(flows, scales, src, tgt, cfg, routes)
    want.backward()
    assert torch.equal(tot, want)
    assert all(torch.equal(g, f.grad) for g, f in zip(grads, flows))
    xla = _composed(flows, scales, src, tgt, cfg, ["xla"] * 3)
    assert not torch.equal(xla, want)


# ------------------------------------------------------------- affine (F9)


@pytest.mark.parametrize("hw,bound", [((16, 24), 4.0), ((33, 47), 2.0),
                                      ((64, 96), 12.0)])
def test_affine_style_matches_jax(hw, bound):
    jds = JaxSynthetic(JaxDataConfig(image_size=hw), style="affine",
                       max_shift=bound)
    tds = SyntheticData(DataConfig(image_size=hw), style="affine",
                        max_shift=bound)
    for seed in range(4):
        jsrc, jtgt, jflow = jds._sample(seed)
        src, tgt, flow = tds._sample(seed)
        np.testing.assert_array_equal(flow, jflow)
        np.testing.assert_array_equal(tgt, jtgt)
        np.testing.assert_array_equal(src, jsrc)  # the measured gap: 0
    jb = jds.sample_train(3, iteration=1)
    tb = tds.sample_train(3, iteration=1)
    for k in ("source", "target", "flow", "label"):
        np.testing.assert_array_equal(tb[k], jb[k])
    # the curriculum's bound override moves the flow alone, as in JAX
    np.testing.assert_array_equal(tds._sample(5, 1.5)[2],
                                  jds._sample(5, 1.5)[2])


def test_remap_matches_cv2_on_out_of_bounds_maps():
    rs = np.random.RandomState(8)
    for _ in range(10):
        h, w = rs.randint(2, 40, 2)
        img = (rs.rand(h, w, 3) * 255).astype(np.float32)
        mx = ((rs.rand(h + 3, w) * 1.6 - 0.3) * w).astype(np.float32)
        my = ((rs.rand(h + 3, w) * 1.6 - 0.3) * h).astype(np.float32)
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REPLICATE)
        np.testing.assert_array_equal(remap_linear_replicate(img, mx, my),
                                      want)


def test_unknown_styles_and_gather_dtypes_still_raise():
    with pytest.raises(ValueError, match="style"):
        SyntheticData(DataConfig(), style="swirl")
    cfg = dataclasses.replace(LossConfig(), gather_dtype="float16")
    with pytest.raises(ValueError, match="gather_dtype"):
        tph.warp_operand(torch.zeros(1), cfg)
