"""The T-frame volume loss of the port against the JAX package's:
`backward_warp_volume`, `loss_interp_multi` and `pyramid_loss_multi`, at
T = 2 and T = 3, values and flow gradients; and the one warp call of
`pyramid_loss_multi` over every level and pair.

Inputs are numpy draws from fixed seeds, fed to both packages; JAX runs
on the CPU through its XLA warp (the pyramid jitted, which the gradient
tolerance covers). Tolerances, each with its
reason (as in test_torch_loss.py, whose two-frame loss this one
generalises):
  - the warp: 1e-5 absolute, the JAX kernel tests' tolerance; its flow
    gradient: 1e-5 of the largest entry (the plain flow gradient sums
    the channels in another order than XLA's autodiff);
  - loss values: 5e-5 relative (float32 sums of up to 10^4 terms;
    XLA's CPU reduction is the less exact);
  - flow gradients: 1e-3 relative plus 1e-4 of the largest gradient of
    the level: the alpha_c = 0.25 photometric gradient amplifies the
    float32 rounding of the warped frames (F6).
The fold is the point of the gradient checks: a wrong pair order gives
a plausible loss and a wrong gradient.
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
from deepof_tpu.ops.warp import backward_warp_volume as jax_warp_volume
from deepof_tpu_torch.core.config import LossConfig
from deepof_tpu_torch.losses import photometric as tph
from deepof_tpu_torch.losses import pyramid as tpy
from deepof_tpu_torch.ops import warp as twarp
from deepof_tpu_torch.ops.warp import backward_warp_volume, fold_pairs

KEYS = ("total", "Charbonnier_reconstruct", "U_loss", "V_loss", "smooth")
SINTEL_LOSS = {"alpha_c": 0.3, "alpha_s": 0.3, "lambda_smooth": 0.0,
               "weights": (16, 8, 4, 4, 2, 1)}
# the default loss (smoothness on), the sintel preset's, and order 2
VARIANTS = [{}, SINTEL_LOSS, {"smoothness_order": 2, "lambda_smooth": 0.5}]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _volume(rs, b, h, w, t, mag=2.0):
    vol = rs.rand(b, h, w, 3 * t).astype(np.float32)
    flows = (rs.randn(b, h, w, 2 * (t - 1)) * mag).astype(np.float32)
    return vol, flows


@pytest.mark.parametrize("t", [2, 3])
def test_backward_warp_volume_and_flow_gradient_match_jax(t):
    vol, flows = _volume(np.random.RandomState(t), 2, 11, 17, t, mag=4.0)
    ct = np.random.RandomState(9).randn(2, 11, 17, 3 * (t - 1)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda f: jax_warp_volume(jnp.asarray(vol), f),
                        jnp.asarray(flows))
    (want_grad,) = vjp(jnp.asarray(ct))
    f = _t(flows).requires_grad_(True)
    got = backward_warp_volume(_t(vol), f)
    got.backward(_t(ct))
    assert got.shape == (2, 11, 17, 3 * (t - 1))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(f.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())


def test_fold_places_pairs_as_jax_does():
    """Pair t of row b at b(T-1) + t, each the frame t+1 and flow t."""
    b, h, w, t = 2, 3, 4, 4
    vol = torch.arange(b * h * w * 3 * t, dtype=torch.float32).reshape(
        b, h, w, 3 * t)
    flows = -torch.arange(b * h * w * 2 * (t - 1),
                          dtype=torch.float32).reshape(b, h, w, 2 * (t - 1))
    nxt, flw = fold_pairs(vol, flows)
    for row in range(b):
        for p in range(t - 1):
            n = row * (t - 1) + p
            assert torch.equal(nxt[n], vol[row, ..., 3 * (p + 1):3 * (p + 2)])
            assert torch.equal(flw[n], flows[row, ..., 2 * p:2 * p + 2])
    # the flows of a model's NCHW output fold without a copy
    out = torch.zeros(b, 2 * (t - 1), h, w)
    assert fold_pairs(vol, out.permute(0, 2, 3, 1))[1].data_ptr() == \
        out.data_ptr()


@pytest.mark.parametrize("kw", VARIANTS)
@pytest.mark.parametrize("t", [2, 3])
def test_loss_interp_multi_matches_jax(t, kw):
    rs = np.random.RandomState(10 + t)
    vol, flows = _volume(rs, 2, 20, 28, t, mag=0.5)
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)
    want, wrec = jph.loss_interp_multi(jnp.asarray(flows), jnp.asarray(vol),
                                       2.5, jcfg)
    got, rec = tph.loss_interp_multi(_t(flows), _t(vol), 2.5, tcfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=5e-5, err_msg=k)
    np.testing.assert_allclose(rec.numpy(), np.asarray(wrec), atol=1e-5)


def _pyramid(rs, b, size, t):
    """Six flow levels of a FlowNet-S at `size` (H, W): ceil halvings,
    down to levels without a border-mask interior."""
    h, w = size
    flows, scales = [], []
    for k in range(6):
        h, w = -(-h // 2), -(-w // 2)
        flows.append((rs.randn(b, h, w, 2 * (t - 1)) * 0.5).astype(
            np.float32))
        scales.append(10.0 / 2 ** k)
    vol = rs.rand(b, *size, 3 * t).astype(np.float32) * 255
    return flows, scales, vol


def _mean(t):
    return (70.1433, 83.1915, 92.8827) * t


@pytest.mark.parametrize("kw", VARIANTS[:2])
@pytest.mark.parametrize("t", [2, 3])
def test_pyramid_loss_multi_and_flow_gradients_match_jax(t, kw):
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)
    flows, scales, vol = _pyramid(np.random.RandomState(20 + t), 2,
                                  (56, 72), t)
    jvol = jpy.lrn_normalize(jpy.preprocess(jnp.asarray(vol),
                                            jnp.asarray(_mean(t))))

    def total(fs):
        tot, losses, rec = jpy.pyramid_loss_multi(list(zip(fs, scales)),
                                                  jvol, jcfg)
        return tot, (losses, rec)

    (jtot, (jlosses, jrec)), jgrads = jax.jit(jax.value_and_grad(
        total, has_aux=True))([jnp.asarray(f) for f in flows])

    tflows = [_t(f).requires_grad_(True) for f in flows]
    tvol = tpy.lrn_normalize(tpy.preprocess(_t(vol), _mean(t)))
    tot, losses, rec = tpy.pyramid_loss_multi(list(zip(tflows, scales)),
                                              tvol, tcfg)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=5e-5)
    assert rec.shape == (2, 28, 36, 3 * (t - 1))
    np.testing.assert_allclose(rec.detach().numpy(), np.asarray(jrec),
                               atol=1e-5)
    for level, (got, want) in enumerate(zip(losses, jlosses)):
        for k in KEYS:
            np.testing.assert_allclose(got[k].item(), float(want[k]),
                                       rtol=5e-5, atol=1e-7,
                                       err_msg=f"level {level} {k}")
    for level, (f, want) in enumerate(zip(tflows, jgrads)):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-12)
        np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * scale,
                                   err_msg=f"flow gradient, level {level}")


def test_pyramid_loss_multi_warps_every_level_and_pair_in_one_call(
        monkeypatch):
    """One call of `backward_warp_levels` a loss: six levels of B(T-1)
    folded pairs (one launch of each warp kernel on the card)."""
    calls = []
    inner = tpy.backward_warp_levels

    def counted(images, flows, impl="auto"):
        calls.append([tuple(i.shape) for i in images])
        return inner(images, flows, impl)

    monkeypatch.setattr(tpy, "backward_warp_levels", counted)
    monkeypatch.setattr(twarp, "backward_warp_levels", counted)
    flows, scales, vol = _pyramid(np.random.RandomState(1), 2, (30, 44), 4)
    tot, _, _ = tpy.pyramid_loss_multi(
        [(_t(f), s) for f, s in zip(flows, scales)],
        tpy.lrn_normalize(_t(vol) / 255.0), LossConfig())
    assert torch.isfinite(tot)
    assert calls == [[(6, f.shape[1], f.shape[2], 3) for f in flows]]


def test_volume_loss_refuses_what_the_jax_package_refuses():
    flows, scales, vol = _pyramid(np.random.RandomState(2), 1, (16, 16), 3)
    pyr = [(_t(f), s) for f, s in zip(flows, scales)]
    for kw, match in (({"edge_aware_photo": True}, "two-frame only"),
                      ({"edge_aware": True}, "two-frame depthwise only"),
                      ({"occlusion": True}, "no backward flows"),
                      ({"smoothness": "depthwise"}, "per-pair")):
        cfg = dataclasses.replace(LossConfig(), **kw)
        with pytest.raises(ValueError, match=match):
            tpy.pyramid_loss_multi(pyr, _t(vol), cfg)
        with pytest.raises(ValueError, match=match):
            jph.loss_interp_multi(jnp.asarray(flows[0]),
                                  jnp.zeros((1, 8, 8, 9)), 1.0,
                                  JaxLossConfig(**kw))
    # census runs in the volume loss (test_torch_loss_variants.py holds
    # it to JAX); gather_dtype is still refused
    tot, _, _ = tpy.pyramid_loss_multi(pyr, _t(vol),
                                       LossConfig(photometric="census"))
    assert torch.isfinite(tot)
    with pytest.raises(NotImplementedError, match="item 9"):
        tpy.pyramid_loss_multi(pyr, _t(vol),
                               LossConfig(gather_dtype="bfloat16"))
