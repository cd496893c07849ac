"""Training the UCF-101 action models in the port against the JAX
package: `model_losses` (the classifier's cross-entropy, the two-stream
models' pyramid loss plus loss.weights[0] x the cross-entropy, with the
smoothness border mask the loop turns on for them) and its gradients,
from the same flax weights through the converter, at train=False; then
the port's dropout in the train step, which the JAX reference draws with
threefry and the port with torch (F19): a pure function of (train.seed,
global step), so K = 2 steps a call give the bits of two single calls,
and the forward recomputed under train.remat sees the masks it was
given.

Tolerances, each with its reason:
  - float32 at the ucf101 preset's loss (st_single, the preset's model,
    64 x 96, batch 2): the total and the action loss 1e-5 relative, the
    accuracy equal (one label set to the JAX logits' argmax, so it reads
    0.5, not a trivial 0);
  - the loss, the action loss and every parameter's gradient in
    float64 on both sides (`jax.enable_x64` inside the test only; the
    parameters float32 values, the converter's dtype), the preset's loss
    with the photometric and smoothness exponents at 0.5: each gradient
    within 1e-4 of its tensor's largest entry, rtol 1e-4 (measured:
    ucf101_spatial 1.2e-7, st_single 3.9e-6, st_baseline 1.3e-5), the
    losses 1e-6 relative. Both steps cast the model's outputs to float32
    before the loss whatever the compute dtype, and the Charbonnier
    gradient at the preset's 0.25 goes as |x|^-0.5 of x = recon - input,
    which amplifies that rounding: there the gaps reach 7.9e-5 at 64x64
    and 2.3e-4 at 32x48. Not in float32 at all: a 2x2 max-pool window
    whose two largest entries differ by an ulp picks either, and JAX's
    own float32 gradients sit 1.3e-2 of a tensor's largest entry from its
    float64 ones (st_single, up_pr4to3's bias), the port's 2.2e-3.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          LossConfig, TrainConfig,
                                          get_config)
from deepof_tpu_torch.data.datasets import UCF101_MEAN
from deepof_tpu_torch.models import two_stream
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import (STEP_KEY, batch_to_device,
                                         make_eval_fn, make_train_step,
                                         model_losses)

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CASES = [("ucf101_spatial", (32, 32)), ("st_single", (64, 64)),
         ("st_baseline", (64, 64))]


def _loss_kw(name, **kw):
    lc = get_config("ucf101").loss
    out = {k: getattr(lc, k) for k in ("epsilon", "alpha_c", "alpha_s",
                                       "lambda_smooth", "weights")}
    if name == "st_baseline":  # FlowNet-S's six levels
        out["weights"] = (16.0, 8.0, 4.0, 2.0, 1.0, 1.0)
    out.update(kw)
    return out


def _batch(hw, seed, b=2, dtype=np.float32):
    rs = np.random.RandomState(seed)
    return {"source": (rs.rand(b, *hw, 3) * 255).astype(dtype),
            "target": (rs.rand(b, *hw, 3) * 255).astype(dtype),
            "label": rs.randint(0, 101, b).astype(np.int32)}


def _params(jm, hw, channels, seed, dtype=jnp.float32):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, channels), dtype))["params"]
    np_dtype = np.dtype(dtype)

    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        # float32 values (the converter's dtype) held in `dtype`
        return (rng.standard_normal(a.shape) * scale).astype(
            np.float32).astype(np_dtype)

    return jax.tree_util.tree_map(draw, shapes)


def _jax_losses(jm, params, batch, kw, smooth, dtype, grad=True):
    """(total, aux, grads or None) of the JAX model_losses at
    train=False, under jax.jit."""
    def f(p):
        return jax_model_losses(
            jm, p, {k: jnp.asarray(v) for k, v in batch.items()},
            UCF101_MEAN, JaxLossConfig(**kw), smooth_border_mask=smooth,
            compute_dtype=dtype)

    if not grad:
        return (*jax.jit(f)(params), None)
    (total, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    return total, aux, grads


def _torch(batch):
    return {k: torch.from_numpy(v).long() if k == "label"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_preset_loss_values_match_jax_in_float32():
    hw, kw = (64, 96), _loss_kw("st_single")
    jm = jax_build_model("st_single")
    params = _params(jm, hw, 6, 0)
    batch = _batch(hw, 1)
    model = build_model("st_single", device="cpu", image_size=hw)
    load_flax_params(model, params)
    with torch.no_grad():
        _, aux = model_losses(model, _torch(batch), UCF101_MEAN,
                              LossConfig(**kw), smooth_border_mask=True)
    batch["label"][0] = int(aux["logits"][0].argmax())
    batch["label"][1] = (int(aux["logits"][1].argmax()) + 1) % 101
    jtotal, jaux, _ = _jax_losses(jm, params, batch, kw, True, jnp.float32,
                                  grad=False)
    with torch.no_grad():
        total, aux = model_losses(model, _torch(batch), UCF101_MEAN,
                                  LossConfig(**kw), smooth_border_mask=True)
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(aux["action_loss"].item(),
                               float(jaux["action_loss"]), rtol=1e-5)
    assert aux["accuracy"].item() == float(jaux["accuracy"]) == 0.5
    np.testing.assert_allclose(aux["logits"].numpy(),
                               np.asarray(jaux["logits"]), atol=1e-4,
                               rtol=1e-4)
    for d, jd in zip(aux["losses"], jaux["losses"]):
        np.testing.assert_allclose(d["total"].item(), float(jd["total"]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,hw", CASES)
def test_losses_and_every_gradient_match_jax_in_float64(name, hw):
    kw = _loss_kw(name, alpha_c=0.5, alpha_s=0.5)
    smooth = name != "ucf101_spatial"  # the loop's rule
    batch = _batch(hw, 2, dtype=np.float64)
    with jax.enable_x64(True):
        jm = jax_build_model(name, dtype=jnp.float64)
        params = _params(jm, hw, 3 if name == "ucf101_spatial" else 6, 3,
                         jnp.float64)
        jtotal, jaux, jgrads = _jax_losses(jm, params, batch, kw, smooth,
                                           jnp.float64)
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        jtotal = float(jtotal)
        jaux = {k: np.asarray(jaux[k]) for k in ("action_loss", "logits")}
    model = build_model(name, device="cpu", image_size=hw,
                        dtype=torch.float64).double()
    model.load_state_dict({k: v.double() for k, v in
                           state_dict_from_flax(params).items()})
    total, aux = model_losses(model, _torch(batch), UCF101_MEAN,
                              LossConfig(**kw), smooth_border_mask=smooth,
                              compute_dtype=torch.float64)
    total.backward()
    np.testing.assert_allclose(total.item(), jtotal, rtol=1e-6)
    np.testing.assert_allclose(aux["action_loss"].item(),
                               float(jaux["action_loss"]), rtol=1e-6)
    np.testing.assert_allclose(aux["logits"].detach().numpy(),
                               jaux["logits"], rtol=1e-6, atol=1e-6)
    assert ("accuracy" in aux) == (name != "ucf101_spatial")
    assert ("losses" in aux) == (name != "ucf101_spatial")
    want = state_dict_from_flax(jgrads)
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert set(grads) == set(want)
    for n, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(grads[n].float().numpy(), w.numpy(),
                                   rtol=1e-4, atol=1e-4 * scale, err_msg=n)


def _state_and_step(name, hw, **train):
    cfg = ExperimentConfig(
        model=name, loss=LossConfig(**_loss_kw(name)),
        data=DataConfig(image_size=hw, batch_size=2),
        train=TrainConfig(seed=3, **train))
    model = build_model(name, device="cpu", image_size=hw, seed=0)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    return state, make_train_step(model, cfg, UCF101_MEAN,
                                  smooth_border_mask=name != "ucf101_spatial")


def test_two_steps_a_call_equal_two_single_calls_with_dropout():
    hw = (32, 32)
    batches = [_batch(hw, 10 + i) for i in range(2)]
    one, one_step = _state_and_step("ucf101_spatial", hw)
    want = [one_step(one, {**b, STEP_KEY: 5 + i})
            for i, b in enumerate(batches)]
    two, two_step = _state_and_step("ucf101_spatial", hw, steps_per_call=2)
    got = two_step(two, {**{k: np.stack([b[k] for b in batches])
                            for k in batches[0]}, STEP_KEY: 5})
    assert set(got) == {"total", "grad_norm", "update_skipped",
                        "action_loss"}
    for key in got:
        assert torch.equal(got[key], torch.stack([w[key] for w in want])), \
            key
    for n, t in two.model.state_dict().items():
        assert torch.equal(t, one.model.state_dict()[n]), n
    # dropout was on: the same steps at other global steps differ
    other, other_step = _state_and_step("ucf101_spatial", hw)
    moved = other_step(other, {**batches[0], STEP_KEY: 9})
    assert moved["grad_norm"] != want[0]["grad_norm"]


def test_remat_equals_no_remat_with_dropout(monkeypatch):
    """st_single's head under torch.utils.checkpoint: the masks are drawn
    before the forward, so the recomputed forward applies the same ones;
    the loss, the metrics and the updated parameters are bit for bit
    those without remat. Recomputing a forward that drew its own masks
    would draw other bits: the masks are drawn once a step."""
    hw = (32, 32)
    batch = {**_batch(hw, 20), STEP_KEY: 4}
    draws = {"n": 0}
    real = two_stream.dropout_masks

    def counted(*a, **kw):
        draws["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr("deepof_tpu_torch.train.step.dropout_masks", counted)
    runs = []
    for remat in (False, True):
        state, step = _state_and_step("st_single", hw, remat=remat)
        draws["n"] = 0
        runs.append((step(state, batch), state.model.state_dict(),
                     draws["n"]))
    (m0, sd0, n0), (m1, sd1, n1) = runs
    assert n0 == n1 == 1
    assert set(m0) >= {"action_loss", "accuracy", "scale_total"}
    for key in m0:
        assert torch.equal(m0[key], m1[key]), key
    for n, t in sd0.items():
        assert torch.equal(t, sd1[n]), n


def test_eval_fn_returns_logits_and_no_dropout():
    hw = (32, 32)
    cfg = ExperimentConfig(model="ucf101_spatial",
                           data=DataConfig(image_size=hw))
    model = build_model("ucf101_spatial", device="cpu", image_size=hw)
    model.train()
    batch = _batch(hw, 30)
    out = make_eval_fn(cfg, UCF101_MEAN)(model, batch)
    assert set(out) == {"total", "logits"} and model.training
    with torch.no_grad():
        _, aux = model_losses(model, batch_to_device(batch, "cpu"),
                              UCF101_MEAN, cfg.loss)
    np.testing.assert_array_equal(out["logits"], aux["logits"].numpy())
    assert batch_to_device(batch, "cpu")["label"].dtype == torch.int64


def test_occlusion_with_an_action_model_raises():
    cfg = ExperimentConfig(model="st_single",
                           loss=LossConfig(occlusion=True),
                           data=DataConfig(image_size=(32, 32)))
    model = build_model("st_single", device="cpu", image_size=(32, 32))
    with pytest.raises(ValueError, match="occlusion"):
        make_train_step(model, cfg, UCF101_MEAN)
