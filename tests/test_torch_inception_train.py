"""Training Inception-v3 in the port against the JAX package: the pyramid
loss on Inception's levels (two of one size, the finest at H/2, flow
scales 10 / 5 / 2.5 / 2.5 / 1.25 / 0.625) and one train step of a thin
model (width 0.25) with the `flyingchairs` preset's loss settings on a
pair batch, from the same flax weights. The `sintel` preset's T = 3
volume runs the same checks in test_torch_inception_volume.py.

Inputs are numpy draws from fixed seeds; the JAX side runs under
`jax.jit` on the CPU (its warp is the XLA route, which its Pallas tests
hold to the kernel in interpret mode), the Sintel loss alone op by op
(as test_torch_loss.py runs it: at one pixel of its finest level, where
recon and input nearly cancel, jit's fusion rounds the photometric
difference elsewhere, and the flow gradient there moves by 1.1e-2 of the
level's largest). Tolerances, each with its reason:
  - the loss alone on given flows: its value 1e-5 relative, its
    per-level components 5e-5 (measured 1.2e-5 on the Sintel finest
    level's U_loss: XLA's CPU reduction is the less exact,
    test_torch_loss.py), the flow gradients 1e-3 relative plus 1e-4 of
    the level's largest, as test_torch_loss.py (the photometric gradient
    goes as |x|^(2 alpha_c - 1) of x = 255 (recon - input));
  - a train step: the loss and its per-level components 1e-5 relative
    (measured at most 6.0e-6), the global gradient norm 1e-4 relative
    (measured at most 3.2e-5) and each tensor's gradient 5e-3 of its
    largest entry (measured at most 4.3e-4 on the pair, 1.4e-3 on the
    volume): the convolutions sum in another order in XLA and in
    PyTorch, and the Charbonnier gradient amplifies that at pixels where
    recon and input nearly cancel (F6, test_torch_train.py). The biases
    are normals of 0.1, as test_torch_models.py draws them: with biases
    of 0.01 many ReLU inputs sit at rounding distance from 0, a unit
    that one side turns off passes no gradient, and single tensors then
    differ by up to 2.9e-2 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.losses import pyramid as jpy
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import LossConfig, get_config
from deepof_tpu_torch.data.datasets import DATASET_MEANS
from deepof_tpu_torch.losses import pyramid as tpy
from deepof_tpu_torch.models.inception_v3_flow import FLOW_SCALES
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.step import SCALE_KEYS, model_losses

KEYS = ("total", "Charbonnier_reconstruct", "U_loss", "V_loss", "smooth")
HW = (64, 96)
T = 3


def _loss_kw(preset):
    lc = get_config(preset).loss
    return {k: getattr(lc, k) for k in ("epsilon", "alpha_c", "alpha_s",
                                        "lambda_smooth", "weights")}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _levels(rs, t, b=2):
    """Flows on Inception's six levels of an HW input (finest H/2, two at
    H/8) and the input frames (B, H, W, 3T), 0-255."""
    h, w = HW
    sizes = [(h >> k, w >> k) for k in (1, 2, 3, 3, 4, 5)]
    flows = [(rs.randn(b, sh, sw, 2 * (t - 1)) * 0.5).astype(np.float32)
             for sh, sw in sizes]
    return flows, rs.rand(b, h, w, 3 * t).astype(np.float32) * 255


def check_loss_on_inception_levels(preset, t, monkeypatch,
                                   op_by_op=False):
    """The port's pyramid loss of `preset` on Inception's levels against
    the JAX package's, under `jax.jit` or `op_by_op`."""
    kw = _loss_kw(preset)
    flows, vol = _levels(np.random.RandomState(t), t)
    mean = DATASET_MEANS[preset] * t
    jcfg, tcfg = JaxLossConfig(**kw), LossConfig(**kw)
    pyr = list(zip(flows, FLOW_SCALES))

    def jtotal(fs):
        norm = jpy.lrn_normalize(jpy.preprocess(jnp.asarray(vol),
                                                jnp.asarray(mean)))
        levels = list(zip(fs, FLOW_SCALES))
        if t == 2:
            tot, losses, rec = jpy.pyramid_loss(levels, norm[..., :3],
                                                norm[..., 3:], jcfg)
        else:
            tot, losses, rec = jpy.pyramid_loss_multi(levels, norm, jcfg)
        return tot, (losses, rec)

    grad_fn = jax.value_and_grad(jtotal, has_aux=True)
    (jtot, (jlosses, jrec)), jgrads = (grad_fn if op_by_op else jax.jit(
        grad_fn))([jnp.asarray(f) for f, _ in pyr])

    calls = []
    warp = tpy.backward_warp_levels

    def counted(images, fl, impl="auto"):
        calls.append([tuple(i.shape) for i in images])
        return warp(images, fl, impl)

    monkeypatch.setattr(tpy, "backward_warp_levels", counted)
    tflows = [_t(f).requires_grad_(True) for f in flows]
    norm = tpy.lrn_normalize(tpy.preprocess(_t(vol), mean))
    levels = list(zip(tflows, FLOW_SCALES))
    if t == 2:
        tot, losses, rec = tpy.pyramid_loss(levels, norm[..., :3],
                                            norm[..., 3:], tcfg)
    else:
        tot, losses, rec = tpy.pyramid_loss_multi(levels, norm, tcfg)
    tot.backward()
    # one call of the warp over the six levels, the two H/8 ones equal
    assert len(calls) == 1 and len(calls[0]) == 6
    assert calls[0][2] == calls[0][3]
    assert calls[0][0][1:3] == (HW[0] // 2, HW[1] // 2)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
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


def _batch(rs, t, b=2):
    """A texture moving by (1, 2) px a frame: a pair or a T-frame volume
    of 0-255 BGR frames at HW."""
    h, w = HW
    base = rs.rand(b, h + 8, w + 8 + 2 * t, 3).astype(np.float32) * 200 + 20
    frames = [base[:, 4 + i:4 + i + h, 4 + 2 * i:4 + 2 * i + w]
              for i in range(t)]
    if t == 2:
        return {"source": frames[0], "target": frames[1]}
    return {"volume": np.concatenate(frames, -1)}


def test_loss_on_inception_levels_matches_jax(monkeypatch):
    check_loss_on_inception_levels("flyingchairs", 2, monkeypatch)


def check_train_step(preset, t):
    """One train step of a thin Inception-v3 with `preset`'s loss on a
    batch of `t` frames against the JAX package's."""
    kw = _loss_kw(preset)
    mean = DATASET_MEANS[preset]
    batch = _batch(np.random.RandomState(10 + t), t)
    jm = jax_build_model("inception_v3", flow_channels=2 * (t - 1),
                         width_mult=0.25)
    rs = np.random.RandomState(t)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3 * t)))["params"]
    # normals over sqrt(fan-in) for kernels, of 0.1 for biases
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * (0.1 if len(a.shape) == 1 else
                   1.0 / np.sqrt(np.prod(a.shape[:-1])))).astype(np.float32),
        shapes)

    @jax.jit
    def objective(p):
        def f(p):
            return jax_model_losses(jm, p, {k: jnp.asarray(v)
                                            for k, v in batch.items()},
                                    mean, JaxLossConfig(**kw))
        (total, aux), grads = jax.value_and_grad(f, has_aux=True)(p)
        return total, {k: jnp.stack([d[k] for d in aux["losses"]])
                       for k in SCALE_KEYS}, grads

    jtot, jscales, jgrads = objective(params)

    model = build_model("inception_v3", flow_channels=2 * (t - 1),
                        width_mult=0.25, device="cpu")
    load_flax_params(model, params)
    total, aux = model_losses(model, {k: _t(v) for k, v in batch.items()},
                              mean, LossConfig(**kw))
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtot), rtol=1e-5)
    for k in SCALE_KEYS:
        got = [d[k].item() for d in aux["losses"]]
        np.testing.assert_allclose(got, np.asarray(jscales[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    norm = float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    want_norm = float(torch.sqrt(sum(g.square().sum()
                                     for g in want.values())))
    np.testing.assert_allclose(norm, want_norm, rtol=1e-4)
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(grads[name].numpy(), w.numpy(), rtol=0,
                                   atol=5e-3 * scale, err_msg=name)


def test_train_step_loss_and_gradients_match_jax():
    check_train_step("flyingchairs", 2)
