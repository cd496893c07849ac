"""FlowNet-S on T-frame volumes against the JAX package: the forward at
an input size that is not a multiple of 64 (the stride-2 pads and the
decoder's crops on odd sizes), two train steps on Sintel-shaped volumes
at T = 3 from the same flax weights, the AEE protocol on volumes, and
the two-frame models' refusal of volumes; then a `Trainer` and the
command line on a Sintel fixture tree.

Tolerances, each with its reason (those of test_torch_train.py and
test_torch_models.py, whose two-frame cases these generalise):
  - the forward: 1e-4 absolute and relative (float32 convolutions sum in
    another order in XLA and in PyTorch);
  - train steps: the loss and its per-level components 1e-4 relative,
    the gradient norm 3e-3 relative on the first step and 5e-3 on the
    second (measured 3.3e-4 and 3.0e-3), and each tensor's first-step
    gradient 2e-2 of its largest entry (measured at most 2.8e-3): the
    Charbonnier photometric gradient (alpha_c 0.3 here, |x|^-0.4)
    amplifies float32 rounding of the warped frames (F6), and Adam's
    first update, lr * sign(g), moves the weights apart where a small
    gradient entry rounds to the other sign;
  - AEE, AAE and the flow statistics: 1e-5 relative. The JAX package
    resizes each flow pair with cv2 (INTER_LINEAR on float32), the port
    all pairs at once with PyTorch's bilinear interpolation, the same
    sampling rule; cv2 rounds its float weights differently.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from deepof_tpu.core.config import ExperimentConfig as JaxExperimentConfig
from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.core.config import OptimConfig as JaxOptimConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.evaluate import evaluate_aee as jax_evaluate_aee
from deepof_tpu.train.schedule import step_decay_schedule as jax_schedule
from deepof_tpu.train.state import make_optimizer as jax_optimizer
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch import cli
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          LossConfig, OptimConfig,
                                          TrainConfig, check_trainable,
                                          get_config)
from deepof_tpu_torch.data.datasets import SINTEL_MEAN, SintelData
from deepof_tpu_torch.io.png import read_png_bgr
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.evaluate import evaluate_aee
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import SCALE_KEYS, make_train_step

T = 3
CROP = (56, 120)  # 56 -> 28 -> 14 -> 7 -> 4 -> 2 -> 1, 120 -> ... -> 4 -> 2
SINTEL_LOSS = {"alpha_c": 0.3, "alpha_s": 0.3, "lambda_smooth": 0.0,
               "weights": (16, 8, 4, 4, 2, 1)}
# the default Adam: its 1.6e-5 learning rate keeps rounding-level
# gradient differences from moving the weights apart (lr * sign(g))
OPTIM = {}


def _flax(t=T, size=CROP):
    jm = jax_build_model("flownet_s", flow_channels=2 * (t - 1),
                         width_mult=0.25)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, *size, 3 * t)))["params"]
    return jm, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, t=T):
    model = build_model("flownet_s", flow_channels=2 * (t - 1),
                        width_mult=0.25, device="cpu")
    return load_flax_params(model, params)


def test_forward_on_a_volume_at_a_size_off_the_64_grid_matches_flax():
    rs = np.random.RandomState(0)
    jm, params = _flax()
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * (0.1 if a.ndim == 1 else 1.0 /
                   np.sqrt(np.prod(a.shape[:-1])))).astype(np.float32),
        params)
    x = rs.randn(2, *CROP, 3 * T).astype(np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = _port_model(params)(torch.from_numpy(x).permute(0, 3, 1, 2))
    sizes = [(28, 60), (14, 30), (7, 15), (4, 8), (2, 4), (1, 2)]
    for level, (g, w) in enumerate(zip(got, want)):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape == (2, *sizes[level], 2 * (T - 1))
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=1e-4,
                                   err_msg=f"level {level}")


def _batches(n):
    rs = np.random.RandomState(5)
    base = rs.rand(n, CROP[0] + 8, CROP[1] + 8, 3) * 200 + 20
    out = []
    for k in range(n):  # frames of a texture moving by 1, 2 px a frame
        frames = [base[k, 4 + i:4 + i + CROP[0], 4 + 2 * i:4 + 2 * i
                       + CROP[1]] for i in range(T)]
        vol = np.concatenate(frames, -1)[None].repeat(2, 0)
        vol[1] = vol[1, ::-1]
        out.append({"volume": vol.astype(np.float32)})
    return out


def test_two_volume_train_steps_match_jax():
    _, params = _flax()
    batches = _batches(2)
    jm = jax_build_model("flownet_s", flow_channels=2 * (T - 1),
                         width_mult=0.25)
    tx = jax_optimizer(JaxOptimConfig(**OPTIM),
                       jax_schedule(JaxOptimConfig(**OPTIM), 1))

    @jax.jit
    def jstep(p, opt_state, batch):
        def objective(q):
            return jax_model_losses(jm, q, batch, SINTEL_MEAN,
                                    JaxLossConfig(**SINTEL_LOSS))

        (total, aux), grads = jax.value_and_grad(objective,
                                                 has_aux=True)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        m = {"total": total, "grad_norm": optax.global_norm(grads)}
        for k in SCALE_KEYS:
            m[f"scale_{k}"] = jnp.stack([d[k] for d in aux["losses"]])
        return optax.apply_updates(p, updates), opt_state, m, grads

    cfg = ExperimentConfig(
        width_mult=0.25, loss=LossConfig(**SINTEL_LOSS),
        optim=OptimConfig(**OPTIM),
        data=DataConfig(dataset="sintel", time_step=T, crop_size=CROP))
    model = _port_model(params)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    step = make_train_step(model, cfg, SINTEL_MEAN)
    jp, opt_state = params, tx.init(params)
    for i, b in enumerate(batches):
        jp, opt_state, want, jgrads = jstep(
            jp, opt_state, {"volume": jnp.asarray(b["volume"])})
        got = step(state, b)
        assert got["update_skipped"] == 0.0
        for k, w in want.items():
            rtol = (3e-3, 5e-3)[i] if k == "grad_norm" else 1e-4
            np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                       rtol=rtol, atol=1e-7,
                                       err_msg=f"step {i} {k}")
        if i == 0:
            grads = dict(model.named_parameters())
            for name, w in state_dict_from_flax(
                    jax.tree_util.tree_map(np.asarray, jgrads)).items():
                scale = float(np.abs(w.numpy()).max())
                np.testing.assert_allclose(grads[name].grad.numpy(),
                                           w.numpy(), rtol=0,
                                           atol=2e-2 * scale, err_msg=name)
    assert state.step == 2


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sintel")
    chip_smoke.write_sintel(str(root), {"alley_1": 5, "bamboo_2": 7,
                                        "market_2": 4}, (36, 60), seed=4)
    return str(root)


@pytest.mark.parametrize("bs", [2, 3])
def test_aee_over_all_pairs_at_native_size_matches_jax(tree, bs):
    """Both protocols on the same volumes and the same predicted flows
    (a fixed function of each volume at half size): AEE and AAE over all
    T-1 pairs at the native 36x60, the loss's row-weighted mean, and the
    flow statistics."""
    kw = dict(time_step=T, image_size=(24, 40), gt_size=(36, 60))
    ds = SintelData(DataConfig(dataset="sintel", data_path=tree, **kw))

    def eval_fn(_, batch):
        vol = np.asarray(batch["volume"], np.float32)
        half = vol[:, ::2, ::2]
        flow = np.stack([(half[..., c] - half[..., c + 3]) / 40.0
                         for c in range(2 * (T - 1))], -1)
        return {"total": np.float32(vol.mean()), "flow": flow,
                "recon": half[..., :3 * (T - 1)] / 255.0}

    train = dict(eval_batch_size=bs, eval_amplifier=3.0,
                 eval_clip=(-420.621, 426.311))
    got = evaluate_aee(eval_fn, None, ds, ExperimentConfig(
        train=TrainConfig(**train)))
    want = jax_evaluate_aee(eval_fn, None, ds, JaxExperimentConfig(
        train=JaxTrainConfig(**train)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("model", ["flownet_c", "flownet_cs"])
def test_two_frame_models_refuse_volumes_as_jax_does(model):
    cfg = ExperimentConfig(model=model, data=DataConfig(time_step=T))
    with pytest.raises(ValueError, match="two-frame model"):
        check_trainable(cfg)
    check_trainable(ExperimentConfig(data=DataConfig(time_step=10)))
    kw = {"width_mult": 0.25} if model == "flownet_c" else {}
    jm = jax_build_model(model, flow_channels=2 * (T - 1), **kw)
    with pytest.raises(Exception) as e:  # where the JAX package breaks
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3 * T)))
    assert type(e.value).__name__ in ("ScopeParamShapeError", "ValueError")


def _tiny(tree, log_dir, **kw):
    """The sintel preset at width 0.25 and T = 3, its sizes cut."""
    cfg = get_config("sintel")
    return cfg.replace(
        model="flownet_s", width_mult=0.25,
        data=dataclasses.replace(cfg.data, data_path=tree, time_step=T,
                                 image_size=(32, 48), crop_size=(24, 40),
                                 gt_size=(36, 60)),
        train=dataclasses.replace(cfg.train, log_dir=log_dir, **kw))


def test_trainer_fits_sintel_volumes_and_dumps_visuals(tree, tmp_path):
    trainer = Trainer(_tiny(tree, str(tmp_path), dump_visuals=True),
                      device="cpu")
    assert isinstance(trainer.dataset, SintelData)
    summary = trainer.fit(max_steps=2)
    assert trainer.state.step == 2
    for k in ("aee", "aae", "val_loss"):
        assert np.isfinite(summary[k]), k
    vis = tmp_path / "visuals"
    n_val = trainer.dataset.num_val
    assert sorted(p.name for p in vis.iterdir()) == sorted(
        f"val0_s{i}_{kind}.png" for i in range(min(n_val, 8))
        for kind in ("flow", "gt", "recon"))
    assert read_png_bgr(vis / "val0_s0_gt.png").shape == (36, 60, 3)


def test_cli_trains_the_sintel_preset_and_evaluates_with_visuals(tree,
                                                                 tmp_path,
                                                                 capsys):
    common = ["--preset", "sintel", "--model", "flownet_s", "--data-path",
              tree, "--device", "cpu", "--log-dir", str(tmp_path),
              "--set", "width_mult=0.25", "--set", f"data.time_step={T}",
              "--set", "data.image_size=[32,48]",
              "--set", "data.crop_size=[24,40]",
              "--set", "data.gt_size=[36,60]"]
    assert cli.main(["train", *common, "--max-steps", "1"]) == 0
    capsys.readouterr()
    assert cli.main(["eval", *common, "--dump-visuals"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["aee"])
    assert (tmp_path / "visuals" / "val0_s0_flow.png").exists()
