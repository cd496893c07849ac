"""The device-side skip (`train/state.py`) under `optim.grad_accum = 2`
with a NaN micro-step, through the JAX package's `make_train_step`
(optax.MultiSteps, its skip a `jnp.where`) and the port's, from the same
flax weights (FlowNet-S, width 0.25, 64x64, batch 2):

  - the metrics at rtol 1e-4 and the three counters (step, emitted
    updates, mini-step) equal;
  - the parameters within `test_torch_grad_accum.py`'s bound (1e-4 of
    each tensor's largest entry but for 0.1% of the entries, each within
    2 lr an update);
  - the accumulator and Adam's moments within 1e-4 of each tensor's
    largest entry (measured: 2.7e-5; gradients summed in another order
    by XLA's and PyTorch's convolutions), but for the accumulator of the
    micro-step after the update, 3e-3 (measured: 1.6e-3): its gradient
    is taken at parameters that differ by up to 2 lr in the entries the
    parameter bound excepts;
  - every tensor of the state unchanged bit for bit across the skipped
    micro-step.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.core.config import OptimConfig as JaxOptimConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.parallel.mesh import local_mesh
from deepof_tpu.train.schedule import step_decay_schedule as jax_schedule
from deepof_tpu.train.state import TrainState as JaxTrainState
from deepof_tpu.train.state import make_optimizer as jax_optimizer
from deepof_tpu.train.step import make_train_step as jax_make_train_step
from deepof_tpu_torch.convert import load_flax_params, state_dict_from_flax
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          LossConfig, OptimConfig)
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import make_train_step

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HW = (64, 64)
LOSS = {"alpha_c": 0.5, "alpha_s": 0.5}
OPTIM = {"learning_rate": 1e-3, "epochs_per_decay": 1, "grad_accum": 2}
MEAN = (0.0, 0.0, 0.0)


def _batches(n):
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=HW))
    seed = np.array([0, 0], np.uint32)
    out = [ds.sample_train(2, rng=derive_batch_rng(seed, i))
           for i in range(n)]
    # the second micro-batch carries a NaN: that micro-step is skipped
    bad = dict(out[0], source=out[0]["source"].copy())
    bad["source"][0, 0, 0, 0] = np.nan
    return [out[0], bad, *out[1:]]


def _jax_adam_state(opt_state):
    """(MultiStepsState, the inner ScaleByAdamState)."""
    inner = opt_state.inner_opt_state
    adam = next(s for s in jax.tree_util.tree_leaves(
        inner, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return opt_state, adam


def _close(got: torch.Tensor, want: torch.Tensor, rel: float, what: str):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= rel * scale, (what, err / scale)


def _assert_params_close(got: dict, want: dict, lr_sum: float, what: str):
    over = total = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        over += int((diff > 1e-4 * float(w.abs().max())).sum())
        total += diff.numel()
        assert float(diff.max()) <= 2 * lr_sum, f"{what} {name}"
    assert over <= 1e-3 * total, f"{what}: {over} of {total} entries"


@pytest.fixture(scope="module")
def accum():
    jm = jax_build_model("flownet_s", width_mult=0.25)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, *HW, 6)))["params"]
    jcfg = JaxConfig(width_mult=0.25, loss=JaxLossConfig(**LOSS),
                     optim=JaxOptimConfig(**OPTIM),
                     data=JaxDataConfig(dataset="synthetic", image_size=HW,
                                        batch_size=2))
    tx = jax_optimizer(jcfg.optim, jax_schedule(jcfg.optim, 1))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1), tx=tx)
    jstep = jax_make_train_step(jm, jcfg, MEAN, local_mesh(1))
    host = jax.tree_util.tree_map(np.asarray, params)
    cfg = ExperimentConfig(width_mult=0.25, loss=LossConfig(**LOSS),
                           optim=OptimConfig(**OPTIM),
                           data=DataConfig(dataset="synthetic",
                                           image_size=HW, batch_size=2))
    model = build_model("flownet_s", width_mult=0.25, device="cpu")
    load_flax_params(model, host)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    step = make_train_step(model, cfg, MEAN)
    out = []
    for b in _batches(3):
        jstate, jm_ = jstep(jstate, {k: jnp.asarray(b[k])
                                     for k in ("source", "target")})
        ms, adam = _jax_adam_state(jstate.opt_state)
        got = step(state, b)
        tree = lambda t: state_dict_from_flax(  # noqa: E731
            jax.tree_util.tree_map(np.asarray, t))
        out.append({
            "jax": {"metrics": jax.tree_util.tree_map(np.asarray, jm_),
                    "counts": (int(jstate.step), int(ms.gradient_step),
                               int(ms.mini_step)),
                    "params": tree(jstate.params),
                    "acc": tree(ms.acc_grads), "mu": tree(adam.mu),
                    "nu": tree(adam.nu)},
            "port": {"metrics": {k: v.numpy() for k, v in got.items()},
                     "counts": (state.step, state.updates, state.mini_step),
                     "params": {n: p.detach().clone()
                                for n, p in model.named_parameters()},
                     "acc": {n: a.clone() for (n, _), a in zip(
                         model.named_parameters(), state.acc)},
                     "mu": {n: state.optimizer.state[p]["exp_avg"].clone()
                            for n, p in model.named_parameters()},
                     "nu": {n: state.optimizer.state[p]["exp_avg_sq"].clone()
                            for n, p in model.named_parameters()}}})
    return out


def test_a_nan_micro_step_under_accumulation_matches_the_jax_state(accum):
    # micro-steps: b0 (folds), NaN (skipped), b1 (emits), b2 (folds)
    assert [o["port"]["counts"] for o in accum] == \
        [o["jax"]["counts"] for o in accum] == [(1, 0, 1), (1, 0, 1),
                                                (2, 1, 0), (3, 1, 1)]
    for i, o in enumerate(accum):
        g, w = o["port"], o["jax"]
        assert float(g["metrics"]["update_skipped"]) == \
            float(w["metrics"]["update_skipped"]) == float(i == 1)
        if i != 1:
            for k in ("total", "grad_norm"):
                np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                           rtol=1e-4, err_msg=f"{i} {k}")
        _assert_params_close(g["params"], w["params"],
                             OPTIM["learning_rate"] * (i >= 2),
                             f"after micro-step {i + 1}")
        # micro-step 4's gradient is taken at parameters after an update,
        # which differ by up to 2 lr in some entries (see above)
        rel = 3e-3 if i == 3 else 1e-4
        for key in ("acc", "mu", "nu"):
            for name, t in w[key].items():
                if float(t.abs().max()) > 0:
                    _close(g[key][name], t, rel, f"{i} {key} {name}")
                else:
                    assert not g[key][name].any(), (i, key, name)


def test_the_skipped_micro_step_changes_no_tensor_of_the_state(accum):
    before, after = accum[0]["port"], accum[1]["port"]
    assert after["counts"] == before["counts"]
    for key in ("params", "acc", "mu", "nu"):
        for name, t in after[key].items():
            assert torch.equal(t, before[key][name]), (key, name)
