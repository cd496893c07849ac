"""The PyTorch port's `Trainer.fit` and `evaluate_aee` against the JAX
package's `Trainer` (width 0.25, 64x64, batch 2, on the CPU), from the
same flax weights carried over by `convert.py`, on the same "blobs"
synthetic data (pure numpy in both packages).

Tolerances, each with its reason:
  - train losses (and their per-scale parts): 1e-4 relative; gradient
    norms: 3e-3 relative. Those of `test_torch_train.py` for the default
    loss: convolutions sum in another order in XLA and in PyTorch, and
    the alpha_c = 0.25 Charbonnier gradient amplifies the rounding.
  - val_loss: 1e-4 relative (the same objective, no gradient); aee and
    aae: 1e-3 relative. The finest flow (32x32) is resized to the 64x64
    ground truth by cv2 in the JAX package and by PyTorch in the port;
    their bilinear weights differ at ~1e-4 relative.
The divergence ladder and the loss sequence across prefetch depths and
worker counts, which need no JAX run, are in `test_torch_loop.py`.
"""

import dataclasses
import json
import os
import types
import warnings

import jax
import numpy as np
import pytest

pytest.importorskip("cv2")  # the JAX side's eval resize

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import ObsConfig as JaxObsConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.parallel.mesh import local_mesh
from deepof_tpu.train import loop as jax_loop
from deepof_tpu.train.loop import Trainer as JaxTrainer
from deepof_tpu.train.state import create_train_state as jax_create_state
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.train.loop import Trainer

STEPS = 4
EVAL_KEYS = ("aee", "aae", "val_loss", "pred_abs_mean", "gt_abs_mean",
             "gt_abs_max")


def _jax_cfg(log_dir, **data_kw):
    return JaxConfig(
        width_mult=0.25,
        data=JaxDataConfig(dataset="synthetic", image_size=(64, 64),
                           gt_size=(64, 64), batch_size=2, **data_kw),
        train=JaxTrainConfig(log_every=1, eval_every=2, ckpt_every_steps=2,
                             eval_batch_size=6, log_dir=str(log_dir)),
        obs=JaxObsConfig(heartbeat=False, flops=False, ledger=False))


def _port_cfg(jax_cfg):
    """The port's config from the JAX config's dict (keys the port does
    not read are dropped with a warning)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return config_from_dict(dataclasses.asdict(jax_cfg))


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _port_trainer(log_dir, params, **data_kw):
    cfg = _port_cfg(_jax_cfg(log_dir, **data_kw))
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                      device="cpu")
    load_flax_params(trainer.model, params)
    return trainer


def _create_state_jitted(model, example_input, tx, seed=0, log=None):
    """The JAX package's `create_train_state` with the flax init under
    `jax.jit`: op by op, FlowNet-S's init takes ~18 s on the CPU, jitted
    ~5 s. The weights are carried over to the port either way."""
    return jax_create_state(types.SimpleNamespace(init=jax.jit(model.init)),
                            example_input, tx, seed=seed, log=log)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A fit of STEPS steps in each package, from the same weights, with
    an eval every 2 steps (`Trainer.evaluate` in both)."""
    root = tmp_path_factory.mktemp("fit")
    jcfg = _jax_cfg(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", _create_state_jitted)
        jt = JaxTrainer(jcfg, dataset=JaxSynthetic(jcfg.data, style="blobs"),
                        mesh=local_mesh(1))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    pt = _port_trainer(root / "port", params)
    out = {"root": root,
           "summary": (pt.fit(max_steps=STEPS), jt.fit(max_steps=STEPS))}
    out["records"] = (_records(root / "port"), _records(root / "jax"))
    out["steps"] = (pt.state.step, int(jt.state.step))
    return out


def test_evaluate_matches_jax(runs):
    """`evaluate_aee` (eval_batch_size 6 over 16 val rows: the remainder
    tiling) against the JAX `Trainer.evaluate`, at each eval of the fit
    and in the summary."""
    got, want = ([r for r in recs if r["kind"] == "eval"]
                 for recs in runs["records"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == [2, 4]
    pairs = list(zip(got, want)) + [runs["summary"]]
    for g, w in pairs:
        assert set(EVAL_KEYS) <= set(g) & set(w)
        for k in EVAL_KEYS:
            rtol = 1e-4 if k in ("val_loss", "gt_abs_mean", "gt_abs_max") \
                else 1e-3
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
    eval_keys = [set(r) - {"time"} for r in got + want]
    assert all(k == eval_keys[0] for k in eval_keys)


def test_fit_records_match_jax(runs):
    got, want = runs["records"]
    assert [(r["kind"], r["step"]) for r in got] == \
        [(r["kind"], r["step"]) for r in want]
    assert runs["steps"] == (STEPS, STEPS)
    for g, w in zip(got, want):
        if g["kind"] != "train":
            continue
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        np.testing.assert_allclose(g["lr"], w["lr"], rtol=1e-6)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=3e-3)
        for f in ("loss_total_by_scale", "loss_photo_by_scale",
                  "loss_smooth_by_scale"):
            np.testing.assert_allclose(g[f], w[f], rtol=1e-4, atol=1e-6)
        # the loop's rates, phases and data-path counters
        for f in ("steps_per_sec", "phase_assemble_s",
                  "phase_dispatch_s", "data_batches",
                  "data_max_staged_depth", "data_quarantined",
                  "ckpt_saves"):
            assert f in g and f in w, f
    summary = runs["summary"][0]
    assert summary["step_ms_median"] > 0 and summary["ckpt_save_s_max"] > 0


def test_fit_checkpoints_match_jax(runs):
    root = runs["root"]
    port = sorted(os.listdir(root / "port" / "ckpt"))
    jax_steps = sorted(int(n[5:]) for n in os.listdir(root / "jax" / "ckpt")
                       if n.startswith("step_") and n[5:].isdigit())
    assert [n for n in port if not n.endswith(".json")] == \
        [f"step_{s:010d}" for s in jax_steps]
    got, want = runs["summary"]
    assert got["ckpt_saves"] == want["ckpt_saves"]
    assert got["data_batches"] >= STEPS


@pytest.mark.parametrize("section,value,item", [
    ("recipe", {"enabled": True, "stages": [{"name": "a", "steps": 2}]},
     "item 9"),
    # occlusion, vgg16_npz and the bf16 gather are honoured: the case
    # now builds the trainer with the setting carried
    ("loss", {"gather_dtype": "bfloat16"}, None),
    # the UCF-101 loader is ported (item 9.4): the case now builds it
    ("data", {"dataset": "ucf101"}, None)])
def test_jax_settings_the_port_cannot_honour_raise(tmp_path, section,
                                                   value, item):
    d = dataclasses.asdict(_jax_cfg(tmp_path))
    d[section].update(value)
    if section == "loss":
        with pytest.warns(UserWarning, match="ignored keys"):
            cfg = config_from_dict(d)
        assert cfg.loss.gather_dtype == "bfloat16"
        Trainer(cfg, device="cpu")
        return
    if item is None:
        import chip_smoke
        from deepof_tpu_torch.data.datasets import UCF101Data

        d["data"]["data_path"] = str(tmp_path / "ucf101")
        chip_smoke.write_ucf101(d["data"]["data_path"], classes=2,
                                hw=(16, 20))
    with pytest.warns(UserWarning, match="ignored keys"):
        cfg = config_from_dict(d)
    if item is None:
        trainer = Trainer(cfg, device="cpu")
        assert isinstance(trainer.dataset, UCF101Data)
        assert trainer.dataset.num_train == trainer.dataset.num_val == 2
        return
    with pytest.raises(NotImplementedError, match=item):
        Trainer(cfg, device="cpu")
