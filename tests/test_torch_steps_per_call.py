"""`train.steps_per_call` and `train.remat` in the PyTorch port: K steps a
call against K single calls, the loop's cadences at K = 2 against the
JAX package's `Trainer` (FlowNet-S, width 0.25, 64x64, batch 2, on the
CPU), and the rematerialized forward against the plain one.

Tolerances: none. The K-step call is a loop over the single step's
operations and remat recomputes the same forward, so both are held bit
for bit in the port. The loop is held to the JAX loop's record, eval and
checkpoint steps and its final step, which are integers.
"""

import dataclasses
import json
import os
import types

import jax
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import ObsConfig as JaxObsConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.parallel.mesh import local_mesh
from deepof_tpu.train import loop as jax_loop
from deepof_tpu.train.loop import Trainer as JaxTrainer
from deepof_tpu.train.state import create_train_state as jax_create_state
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          OptimConfig, TrainConfig,
                                          config_from_dict)
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.ops import corr as corr_ops
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import (batch_to_device, make_train_step,
                                         model_losses)

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HW = (64, 64)
MEAN = (0.0, 0.0, 0.0)
K = 2
MAX_STEPS = 5  # not a multiple of K: the last call ends at step 6


def _batches(n, bs=2):
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=HW))
    seed = np.array([0, 0], np.uint32)
    return [ds.sample_train(bs, rng=derive_batch_rng(seed, i))
            for i in range(n)]


def _state_and_step(k, grad_accum):
    cfg = ExperimentConfig(
        width_mult=0.25,
        optim=OptimConfig(learning_rate=1e-3, grad_accum=grad_accum),
        train=TrainConfig(steps_per_call=k))
    model = build_model("flownet_s", width_mult=0.25, device="cpu")
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    return state, make_train_step(model, cfg, MEAN)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_a_k_step_call_equals_k_single_calls_bit_for_bit(grad_accum):
    batches = _batches(4)
    # one NaN in the third micro-batch: each inner step keeps its own skip
    batches[2] = dict(batches[2], source=batches[2]["source"].copy())
    batches[2]["source"][0, 0, 0, 0] = np.nan
    one, one_step = _state_and_step(1, grad_accum)
    want = [one_step(one, b) for b in batches]
    two, two_step = _state_and_step(K, grad_accum)
    got = [two_step(two, {key: np.stack([a[key], b[key]]) for key in a})
           for a, b in (batches[0:2], batches[2:4])]
    for key in want[0]:
        flat = [v for call in got for v in call[key]]
        # exact, NaN equal to NaN (the skipped step's loss)
        np.testing.assert_array_equal(flat, [w[key] for w in want],
                                      err_msg=key)
    assert [w["update_skipped"] for w in want] == [0.0, 0.0, 1.0, 0.0]
    assert (two.step, two.updates, two.mini_step) == \
        (one.step, one.updates, one.mini_step) == (3, 3 // grad_accum,
                                                   3 % grad_accum)
    for name, t in two.model.state_dict().items():
        assert torch.equal(t, one.model.state_dict()[name]), name


@pytest.mark.parametrize("model,geometry", [
    ("flownet_s", {}), ("flownet_c", {"corr_max_disp": 4, "corr_stride": 1})])
def test_remat_gives_the_same_loss_and_gradients_bit_for_bit(
        monkeypatch, model, geometry):
    """The model forward under torch.utils.checkpoint: the same loss and
    the same gradient, bit for bit; FlowNet-C's correlation forward runs
    twice (the second time in backward)."""
    calls = {"n": 0}
    reference = corr_ops.correlation_reference

    def counted(*a, **kw):
        calls["n"] += 1
        return reference(*a, **kw)

    monkeypatch.setattr(corr_ops, "correlation_reference", counted)
    m = build_model(model, width_mult=0.25, device="cpu", **geometry)
    batch = batch_to_device(_batches(1)[0], "cpu")
    cfg = ExperimentConfig(model=model, **geometry)
    runs = []
    for remat in (False, True):
        calls["n"] = 0
        m.zero_grad(set_to_none=True)
        total, _ = model_losses(m, batch, MEAN, cfg.loss, remat=remat)
        forwards = calls["n"]
        total.backward()
        runs.append((total.detach(), [p.grad.clone()
                                      for p in m.parameters()],
                     forwards, calls["n"]))
    (t0, g0, f0, n0), (t1, g1, f1, n1) = runs
    assert torch.equal(t0, t1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    if model == "flownet_c":
        assert (f0, n0, f1, n1) == (1, 1, 1, 2)


def _jax_cfg(log_dir):
    return JaxConfig(
        width_mult=0.25,
        data=JaxDataConfig(dataset="synthetic", image_size=HW, gt_size=HW,
                           batch_size=2),
        train=JaxTrainConfig(log_every=3, eval_every=4, ckpt_every_steps=3,
                             eval_batch_size=16, steps_per_call=K,
                             log_dir=str(log_dir)),
        obs=JaxObsConfig(heartbeat=False, flops=False, ledger=False))


def _create_state_jitted(model, example_input, tx, seed=0, log=None):
    """The JAX `create_train_state` with the flax init under `jax.jit`
    (op by op it takes ~18 s on the CPU)."""
    return jax_create_state(types.SimpleNamespace(init=jax.jit(model.init)),
                            example_input, tx, seed=seed, log=log)


def _record_steps(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        recs = [json.loads(ln) for ln in f]
    return {kind: [r["step"] for r in recs if r["kind"] == kind]
            for kind in ("train", "eval")}


def _ckpt_steps(log_dir):
    return sorted(int(n[5:]) for n in os.listdir(os.path.join(log_dir,
                                                              "ckpt"))
                  if n.startswith("step_") and n[5:].isdigit())


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("k2")
    jcfg = _jax_cfg(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", _create_state_jitted)
        jt = JaxTrainer(jcfg, dataset=JaxSynthetic(jcfg.data, style="blobs"),
                        mesh=local_mesh(1))
    jax_summary = jt.fit(max_steps=MAX_STEPS)
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pcfg = config_from_dict(dataclasses.asdict(
            jcfg.replace(train=dataclasses.replace(
                jcfg.train, log_dir=str(root / "port")))))
    pt = Trainer(pcfg, dataset=SyntheticData(pcfg.data, style="blobs"),
                 device="cpu")
    summary = pt.fit(max_steps=MAX_STEPS)
    return {"root": root, "steps": (pt.state.step, int(jt.state.step)),
            "summary": summary, "jax_summary": jax_summary}


def test_k2_fit_takes_the_jax_loops_steps(fits):
    root = fits["root"]
    got, want = _record_steps(root / "port"), _record_steps(root / "jax")
    # log_every 3 and ckpt_every_steps 3 fire at the ends of the strides
    # that cross a multiple: 4 and 6; eval_every 4 at 4
    assert got == want == {"train": [4, 6], "eval": [4]}
    assert _ckpt_steps(root / "port") == _ckpt_steps(root / "jax") \
        == [0, 4, 6]
    assert fits["steps"] == (6, 6)
    # the JAX loop's default depth, 2, in both
    assert fits["summary"]["pipeline_depth"] == 2


def test_k2_fit_records_carry_the_last_inner_step(fits):
    with open(os.path.join(fits["root"] / "port", "metrics.jsonl")) as f:
        train = [r for r in map(json.loads, f) if r["kind"] == "train"]
    for r in train:
        assert np.isfinite(r["loss"]) and len(r["loss_total_by_scale"]) == 6
    # one fetch a call that is due for a record, eval or checkpoint (the
    # calls ending at 4 and 6), as in the JAX loop
    assert fits["summary"]["pipeline_fetches"] == \
        fits["jax_summary"]["pipeline_fetches"] == 2
