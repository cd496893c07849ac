"""Training in bf16 compute (`train.compute_dtype="bfloat16"`): two
`Trainer` steps of FlowNet-C (width 0.25, geometry 4 / 1, 64x64, batch
2, the default loss) against the JAX package's `Trainer` with the same
setting and the same flax weights, on the CPU; and the command line's
`train` and `eval` in bf16.

The JAX step's gradients are read from its Adam state: after the first
update optax's first moment is (1 - beta1) * g.

Tolerances, each with its reason and the value measured on an x86-64
CPU (the JAX Trainer in float32 beside it, as the scale of what bf16
rounding alone does to this step):
  - loss: 5e-4 relative (measured 1.9e-5 at step 1, 1.0e-4 at step 2).
  - gradient norm of step 1: 1e-2 relative (measured 2.0e-3; JAX bf16 vs
    JAX float32 1.1e-1). Of step 2: 0.35 relative (measured 0.166; JAX
    bf16 vs JAX float32 0.27): Adam's first update moves each weight by
    lr * sign(g), and with the alpha_c = 0.25 Charbonnier (ROADMAP F6)
    the entries whose sign bf16 rounding decides then carry the norm.
    This check catches a second step that goes wrong; it cannot fail a
    port that computes in float32.
  - each tensor's gradient of step 1: 0.2 of its largest entry (measured
    8.8e-2, on decoder.pr1.conv.bias). A port computing in float32 fails
    this: JAX's bf16 and float32 gradients differ by up to 2.08 of a
    tensor's largest entry (decoder.up_pr2to1.deconv.weight).
Parameters, gradients and Adam's moments stay float32.
"""

import dataclasses
import json
import os
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import ObsConfig as JaxObsConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.parallel.mesh import local_mesh, replicated_sharding
from deepof_tpu.train import loop as jax_loop
from deepof_tpu.train.loop import Trainer as JaxTrainer
from deepof_tpu.train.state import create_train_state as jax_create_state
from deepof_tpu_torch import cli
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.models.common import ConvELU
from deepof_tpu_torch.train.checkpoint import CheckpointManager
from deepof_tpu_torch.train.loop import Trainer

LOSS_RTOL = 5e-4
GRAD_NORM_RTOL = (1e-2, 0.35)  # step 1, step 2
GRAD_TOL = 0.2


def _jax_cfg(log_dir):
    return JaxConfig(
        model="flownet_c", width_mult=0.25, corr_max_disp=4, corr_stride=1,
        data=JaxDataConfig(dataset="synthetic", image_size=(64, 64),
                           gt_size=(64, 64), batch_size=2),
        train=JaxTrainConfig(log_dir=str(log_dir), compute_dtype="bfloat16"),
        obs=JaxObsConfig(heartbeat=False, flops=False, ledger=False))


def _create_state_jitted(model, example_input, tx, seed=0, log=None):
    """The JAX package's `create_train_state` with the flax init under
    `jax.jit` (op by op it takes several times longer on the CPU)."""
    return jax_create_state(types.SimpleNamespace(init=jax.jit(model.init)),
                            example_input, tx, seed=seed, log=log)


def test_bf16_trainer_steps_match_jax(tmp_path):
    jcfg = _jax_cfg(tmp_path / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", _create_state_jitted)
        jt = JaxTrainer(jcfg, mesh=local_mesh(1))
    # placed as the step returns it: the second step reuses the first's
    # compilation
    jt.state = jax.device_put(jt.state, replicated_sharding(jt.mesh))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        cfg = config_from_dict(dataclasses.asdict(jcfg))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_dir=str(tmp_path / "port")))
    trainer = Trainer(cfg, device="cpu")
    assert {m.dtype for m in trainer.model.modules()
            if isinstance(m, ConvELU)} == {torch.bfloat16}
    load_flax_params(trainer.model, params)
    data = SyntheticData(cfg.data)
    seed = np.array([0, 0], np.uint32)
    beta1 = cfg.optim.beta1
    for i in range(2):
        batch = data.sample_train(2, rng=derive_batch_rng(seed, i))
        jt.state, want = jt.train_step(
            jt.state, {k: batch[k] for k in ("source", "target")})
        got = trainer.train_step(trainer.state, batch)
        assert got["update_skipped"] == 0.0
        np.testing.assert_allclose(got["total"], float(want["total"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got["grad_norm"],
                                   float(want["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL[i],
                                   err_msg=f"step {i}")
        if i == 0:
            mu = jt.state.opt_state[0].mu
            grads = state_dict_from_flax(jax.tree_util.tree_map(
                lambda m: np.asarray(m) / np.float32(1 - beta1), mu))
            for name, p in trainer.model.named_parameters():
                w = grads[name].numpy()
                assert p.dtype == p.grad.dtype == torch.float32, name
                np.testing.assert_allclose(
                    p.grad.numpy(), w, rtol=0,
                    atol=GRAD_TOL * np.abs(w).max(), err_msg=name)
    assert trainer.state.step == 2
    moments = [t for s in trainer.state.optimizer.state.values()
               for t in s.values() if t.is_floating_point()]
    assert moments and {t.dtype for t in moments} == {torch.float32}


def test_bf16_command_line_trains_and_evaluates(tmp_path, capsys):
    """`train --set train.compute_dtype=bfloat16` builds a bf16 model,
    takes its steps with finite losses and writes a checkpoint of float32
    tensors only (parameters and Adam's moments); `eval` reads it."""
    log_dir = str(tmp_path)
    argv = ["--synthetic", "--model", "flownet_c", "--device", "cpu",
            "--set", "width_mult=0.25", "--set", "data.batch_size=2",
            "--set", "corr_max_disp=4", "--set", "corr_stride=1",
            "--set", "train.compute_dtype=bfloat16", "--log-dir", log_dir]
    assert cli.main(["train", *argv, "--steps", "2",
                     "--set", "train.log_every=1"]) == 0
    capsys.readouterr()
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        train = [r for r in map(json.loads, f) if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"), create=False)
    model = ckpt.restore_raw(subtree="model")
    optim = ckpt.restore_raw(subtree="optimizer")
    tensors = list(model.values()) + [
        t for s in optim["state"].values() for t in s.values()
        if t.is_floating_point()]
    assert {t.dtype for t in tensors} == {torch.float32}
    assert cli.main(["eval", *argv]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("aee", "aae", "val_loss"):
        assert np.isfinite(out[k]), k
