"""The PyTorch port's training slice against the JAX package's:
`SyntheticData`, `derive_batch_rng`, the learning-rate schedule, and
three train steps of FlowNet-S (width 0.25, 64x64, batch 2) from the
same flax weights, against `model_losses` + optax Adam in JAX.

Tolerances, each with its reason:
  - "noise" canvases: 1e-3 grey levels. The port upsamples with
    PyTorch's bicubic filter, the JAX package with cv2's INTER_CUBIC (the
    same kernel, other rounding: 9.2e-5 measured). "blobs" canvases and
    flows are pure numpy in both: exact.
  - train steps: 1e-4 relative on the loss, its per-level components and
    the gradient norm, and 1e-4 of each tensor's largest entry on the
    first step's gradients. Convolutions sum in another order in XLA and
    in PyTorch (the model alone agrees at 1e-4, test_torch_models.py).
    That holds with an L1-like Charbonnier (alpha_c = alpha_s = 0.5),
    whose gradient does not amplify rounding. The default alpha_c = 0.25
    penalty's gradient goes as |x|^-0.5 of x = 255 (recon - input), a
    difference of nearly equal numbers at some pixels: in float32 both
    packages' gradients are then ~1e-4 (norm) and up to 1e-2 (a tensor's
    largest entry) away from a float64 run of the same step (measured on
    this test's inputs). And Adam's first update is lr * sign(g), so a
    gradient entry that rounds to the other sign moves its weight by
    2 lr. With the default loss the test therefore holds the loss values
    at 1e-4, the gradient norm at 3e-3 (measured 1.45e-4 on the first
    step, 1.4e-3 after one update), and each tensor's first-step gradient
    at 2e-2 of its largest entry (measured 9.9e-3 on
    decoder.up_pr2to1.deconv.bias, at most 1.6e-3 on every other tensor;
    the L1-like loss measures 2.4e-5 against its 1e-4).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.core.config import OptimConfig as JaxOptimConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.data.pipeline import derive_batch_rng as jax_batch_rng
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.schedule import step_decay_schedule as jax_schedule
from deepof_tpu.train.state import make_optimizer as jax_optimizer
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import (ACTION_MODELS, DataConfig,
                                          ExperimentConfig,
                                          LossConfig, OptimConfig,
                                          RecipeConfig, ResilienceConfig,
                                          TrainConfig, check_trainable)
from deepof_tpu_torch.data.datasets import (FlyingChairsData, SyntheticData,
                                            build_dataset)
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.io.ppm import write_ppm_bgr
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import SCALE_KEYS, make_train_step

HW = (64, 64)
# learning rate high enough that three updates move the loss, halved
# after every step (num_train = batch size: one step per epoch)
OPTIM = dict(learning_rate=1e-3, epochs_per_decay=1)


@pytest.mark.parametrize("style,hw,tol", [("noise", (64, 64), 1e-3),
                                          ("noise", (384, 512), 1e-3),
                                          ("blobs", (64, 64), 0.0)])
def test_synthetic_batches_match_jax(style, hw, tol):
    jd = JaxSynthetic(JaxDataConfig(dataset="synthetic", image_size=hw),
                      style=style)
    td = SyntheticData(DataConfig(dataset="synthetic", image_size=hw),
                       style=style)
    seed = np.array([3, 7], np.uint32)
    for i in range(2):
        want = jd.sample_train(2, rng=jax_batch_rng(seed, i))
        got = td.sample_train(2, rng=derive_batch_rng(seed, i))
        assert set(got) == set(want)
        for k in ("source", "target"):
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0)
        np.testing.assert_array_equal(got["flow"], want["flow"])
        np.testing.assert_array_equal(got["label"], want["label"])
    np.testing.assert_array_equal(td.sample_val(3, 1)["flow"],
                                  jd.sample_val(3, 1)["flow"])


@pytest.mark.parametrize("base,index,salt", [
    (0, 0, 0), (5, 123, 0), (np.array([1, 2], np.uint32), 7, 0),
    (np.array([9, 4], np.uint32), 2**40 + 3, 2), (2**33 + 1, 1, 0)])
def test_derive_batch_rng_matches_jax(base, index, salt):
    got = derive_batch_rng(base, index, salt).randint(0, 2**31, 16)
    want = jax_batch_rng(base, index, salt).randint(0, 2**31, 16)
    np.testing.assert_array_equal(got, want)


def test_step_decay_schedule_matches_jax():
    for kw in ({}, {"decay_factor": 0.3, "epochs_per_decay": 2}):
        t = step_decay_schedule(OptimConfig(**kw), 5)
        j = jax_schedule(JaxOptimConfig(**kw), 5)
        for step in (0, 4, 5, 9, 10, 89, 90, 91, 500):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-12)


def _batches(n, bs=2):
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=HW))
    seed = np.array([0, 0], np.uint32)
    return [ds.sample_train(bs, rng=derive_batch_rng(seed, i))
            for i in range(n)]


def _jax_steps(params, batches, clip, loss, optim, model="flownet_s",
               **model_kw):
    jm = jax_build_model(model, width_mult=0.25, **model_kw)
    tx = jax_optimizer(JaxOptimConfig(grad_clip_norm=clip, **optim),
                       jax_schedule(JaxOptimConfig(**optim), 1))

    @jax.jit
    def step(params, opt_state, batch):
        def objective(p):
            return jax_model_losses(jm, p, batch, (0.0, 0.0, 0.0),
                                    JaxLossConfig(**loss))

        (total, aux), grads = jax.value_and_grad(objective,
                                                 has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        metrics = {"total": total, "grad_norm": optax.global_norm(grads)}
        for k in SCALE_KEYS:
            metrics[f"scale_{k}"] = jnp.stack([d[k] for d in aux["losses"]])
        return optax.apply_updates(params, updates), opt_state, metrics, grads

    opt_state = tx.init(params)
    out, first_grads = [], None
    for b in batches:
        params, opt_state, m, grads = step(
            params, opt_state, {k: jnp.asarray(b[k])
                                for k in ("source", "target")})
        out.append(jax.tree_util.tree_map(np.asarray, m))
        first_grads = grads if first_grads is None else first_grads
    return out, jax.tree_util.tree_map(np.asarray, first_grads)


def _port_trainer_parts(params, clip, loss=None, optim=OPTIM):
    cfg = ExperimentConfig(width_mult=0.25, loss=LossConfig(**(loss or {})),
                           optim=OptimConfig(grad_clip_norm=clip, **optim))
    model = build_model("flownet_s", width_mult=0.25, device="cpu")
    load_flax_params(model, params)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    return model, state, make_train_step(model, cfg, (0.0, 0.0, 0.0))


def _flax_params(seed=0, model="flownet_s", **model_kw):
    jm = jax_build_model(model, width_mult=0.25, **model_kw)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed),
                              jnp.zeros((1, *HW, 6)))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


L1_LIKE = {"alpha_c": 0.5, "alpha_s": 0.5}


# (loss, clip, optimizer): a well-conditioned loss with a high, decaying
# learning rate and the global-norm clip engaged; the default
# configuration (its 1.6e-5 learning rate keeps rounding-level gradient
# differences from moving the weights apart)
@pytest.mark.parametrize("loss,clip,optim", [(L1_LIKE, 1000.0, OPTIM),
                                             ({}, None, {})])
def test_three_train_steps_match_jax(loss, clip, optim):
    params = _flax_params()
    batches = _batches(3)
    want, want_grads = _jax_steps(params, batches, clip, loss, optim)
    model, state, step = _port_trainer_parts(params, clip, loss, optim)
    for i, b in enumerate(batches):
        got = step(state, b)
        assert got["update_skipped"] == 0.0
        for k, w in want[i].items():
            rtol = 3e-3 if k == "grad_norm" and not loss else 1e-4
            np.testing.assert_allclose(np.asarray(got[k]), w, rtol=rtol,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        if i == 0:
            if loss:
                # the clip is exercised (|g| > max); it acts inside the
                # update, as optax's does, and leaves .grad as it was
                assert got["grad_norm"] > clip
            tol = 1e-4 if loss else 2e-2
            grads = dict(model.named_parameters())
            for name, w in state_dict_from_flax(want_grads).items():
                g = grads[name].grad.numpy()
                scale = float(np.abs(w.numpy()).max())
                np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                           atol=tol * scale, err_msg=name)
    assert state.step == 3


def test_flownet_c_trainer_steps_match_jax(tmp_path):
    """A FlowNet-C `Trainer` at geometry 4 / 1 builds its model at that
    geometry (the JAX loop passes it on; F8) and its steps are the JAX
    steps, at F6's limits for the default loss (module docstring)."""
    geometry = {"corr_max_disp": 4, "corr_stride": 1}
    cfg = ExperimentConfig(
        model="flownet_c", width_mult=0.25, **geometry,
        data=DataConfig(dataset="synthetic", image_size=HW, batch_size=2),
        train=TrainConfig(log_dir=str(tmp_path)))
    trainer = Trainer(cfg, device="cpu")
    assert (trainer.model.max_disp, trainer.model.corr_stride) == (4, 1)
    params = _flax_params(model="flownet_c", **geometry)
    load_flax_params(trainer.model, params)
    batches = _batches(2)
    want, want_grads = _jax_steps(params, batches, None, {}, {},
                                  model="flownet_c", **geometry)
    for i, b in enumerate(batches):
        got = trainer.train_step(trainer.state, b)
        assert got["update_skipped"] == 0.0
        for k, w in want[i].items():
            rtol = 3e-3 if k == "grad_norm" else 1e-4
            np.testing.assert_allclose(np.asarray(got[k]), w, rtol=rtol,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        if i == 0:
            grads = dict(trainer.model.named_parameters())
            for name, w in state_dict_from_flax(want_grads).items():
                scale = float(np.abs(w.numpy()).max())
                np.testing.assert_allclose(grads[name].grad.numpy(),
                                           w.numpy(), rtol=0,
                                           atol=2e-2 * scale, err_msg=name)
    assert trainer.state.step == 2


def test_nonfinite_batch_is_skipped():
    params = _flax_params()
    batches = _batches(2)
    model, state, step = _port_trainer_parts(params, None)
    step(state, batches[0])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    moments = [{k: v.clone() for k, v in s.items()}
               for s in state.optimizer.state.values()]
    bad = dict(batches[1], source=batches[1]["source"].copy())
    bad["source"][0, 0, 0, 0] = np.nan
    m = step(state, bad)
    assert m["update_skipped"] == 1.0 and not np.isfinite(m["total"])
    assert state.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    for s, was in zip(state.optimizer.state.values(), moments):
        for k, v in s.items():
            assert torch.equal(v, was[k]), k
    assert step(state, batches[1])["update_skipped"] == 0.0
    assert state.step == 2


def test_trainer_fits_on_cpu(tmp_path):
    cfg = ExperimentConfig(
        width_mult=0.25,
        data=DataConfig(dataset="synthetic", image_size=HW, batch_size=2),
        train=TrainConfig(log_every=1, log_dir=str(tmp_path)))
    trainer = Trainer(cfg, device="cpu")
    assert trainer.steps_per_epoch == 32  # 64 procedural pairs / 2
    # batch i of a fit from step s is drawn from derive_batch_rng([seed, s],
    # i): record what the fit's sampler draws
    drawn = []
    draw = trainer._next_train_batch

    def recording_draw(it, rng):
        drawn.append(draw(it, rng))
        return drawn[-1]

    trainer._next_train_batch = recording_draw
    summary = trainer.fit(max_steps=2)
    assert trainer.state.step == 2
    assert summary["steps_per_sec"] > 0 and summary["phase_dispatch_s"] > 0
    records = [json.loads(ln) for ln in open(tmp_path / "metrics.jsonl")]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    for r in train:
        assert np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
        assert len(r["loss_total_by_scale"]) == 6
    want = trainer.dataset.sample_train(
        2, rng=derive_batch_rng(np.array([0, 0], np.uint32), 1))
    np.testing.assert_array_equal(drawn[1]["source"], want["source"])


# vgg16, census and augment_geo are ported: their cases became the
# settings still refused; the UCF-101 models are ported (item 9.4):
# their cases check that they are admitted
@pytest.mark.parametrize("kw", [
    {"model": "st_baseline"}, {"loss": LossConfig(gather_dtype="bfloat16")},
    {"model": "st_single"},
    {"model": "ucf101_spatial"},
    {"recipe": RecipeConfig(enabled=True)}])
def test_unported_settings_raise(kw):
    # the bf16 gather is ported (F11), the recipe too (item 9.5): their
    # cases check that they are admitted
    if kw.get("model") in ACTION_MODELS or "loss" in kw or "recipe" in kw:
        check_trainable(ExperimentConfig(**kw))
        return
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item"):
        check_trainable(ExperimentConfig(**kw))


def test_only_the_synthetic_dataset_is_built(tmp_path):
    assert isinstance(build_dataset(DataConfig(dataset="synthetic")),
                      SyntheticData)
    # flyingchairs builds (on a tree with one pair); sintel and ucf101
    # have their own tests (test_torch_sintel.py, test_torch_ucf101.py):
    # ucf101 reads <data_path>/frames, and without it the tree is missing
    write_ppm_bgr(tmp_path / "00001_img1.ppm", np.zeros((4, 6, 3), np.uint8))
    assert isinstance(build_dataset(DataConfig(dataset="flyingchairs",
                                               data_path=str(tmp_path))),
                      FlyingChairsData)
    with pytest.raises(FileNotFoundError, match="frames"):
        build_dataset(DataConfig(dataset="ucf101", data_path=str(tmp_path)))
    # the affine style is ported (F9): it builds, an unknown style raises
    assert SyntheticData(DataConfig(), style="affine")._sample(0)[0].shape \
        == (*DataConfig().image_size, 3)
    with pytest.raises(ValueError, match="style"):
        SyntheticData(DataConfig(), style="swirl")
    assert ExperimentConfig(resilience=ResilienceConfig(
        skip_nonfinite=False)).resilience.skip_nonfinite is False
    assert dataclasses.asdict(ExperimentConfig())["loss"]["warp_impl"] == \
        "auto"
