"""`optim.grad_accum` in the PyTorch port against the JAX package's
`optax.MultiSteps` (`deepof_tpu/train/state.py`): FlowNet-S and FlowNet-C
(width 0.25, 64x64, batch 2, correlation 4 / 1) from the same flax
weights, four micro-steps at grad_accum = 2 through the JAX package's
own `make_train_step`, and the port's accumulator on its own.

Tolerances, those of `test_torch_train.py` for its well-conditioned loss
(alpha_c = alpha_s = 0.5, learning rate 1e-3 halved every step, the
global-norm clip engaged): the loss and the gradient norm of each
micro-step 1e-4 relative; the parameters after each emitted update
within 1e-4 of each tensor's largest entry (convolutions sum in another
order in XLA and in PyTorch), but for at most 0.1% of the model's
entries, which may differ by up to 2 lr an update: Adam's first update
is lr * sign(g), and a gradient entry near zero rounds to the other sign
in one package (measured: 1 of 51,200 entries of FlowNet-S's
conv3_1.conv.weight, 1.9e-3 at lr 1e-3). The port-only checks are bit
for bit.
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
                                          LossConfig, OptimConfig,
                                          TrainConfig)
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.train.checkpoint import CheckpointManager
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state, global_norm
from deepof_tpu_torch.train.step import (batch_to_device, make_train_step,
                                         model_losses)

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HW = (64, 64)
ACCUM = 2
MICRO_STEPS = 4
LOSS = {"alpha_c": 0.5, "alpha_s": 0.5}
# learning rate halved every step (one step an epoch): the schedule's
# argument at each emitted update shows in the parameters
OPTIM = {"learning_rate": 1e-3, "epochs_per_decay": 1}
CLIP = 1000.0
GEOMETRY = {"flownet_s": {},
            "flownet_c": {"corr_max_disp": 4, "corr_stride": 1}}
MEAN = (0.0, 0.0, 0.0)


def _batches(n, bs=2):
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=HW))
    seed = np.array([0, 0], np.uint32)
    return [ds.sample_train(bs, rng=derive_batch_rng(seed, i))
            for i in range(n)]


def _port_cfg(model, **optim):
    return ExperimentConfig(
        model=model, width_mult=0.25, **GEOMETRY[model],
        loss=LossConfig(**LOSS),
        optim=OptimConfig(**{"grad_accum": ACCUM, "grad_clip_norm": CLIP,
                             **OPTIM, **optim}),
        data=DataConfig(dataset="synthetic", image_size=HW, batch_size=2))


def _port(model, params, **optim):
    cfg = _port_cfg(model, **optim)
    m = build_model(model, width_mult=0.25, device="cpu", **GEOMETRY[model])
    load_flax_params(m, params)
    state = create_train_state(m, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    return state, make_train_step(m, cfg, MEAN)


@pytest.fixture(scope="module")
def params():
    """FlowNet-S's flax weights (seed 0) as numpy, for the port-only
    tests."""
    return jax.tree_util.tree_map(np.asarray, jax.jit(
        jax_build_model("flownet_s", width_mult=0.25).init)(
            jax.random.PRNGKey(0), jnp.zeros((1, *HW, 6)))["params"])


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module", params=["flownet_s", "flownet_c"])
def runs(request):
    """Four micro-steps in each package from the same weights: the
    metrics of each, and the parameters after each."""
    model = request.param
    jm = jax_build_model(model, width_mult=0.25, **GEOMETRY[model])
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, *HW, 6)))["params"]
    jcfg = JaxConfig(
        model=model, width_mult=0.25, **GEOMETRY[model],
        loss=JaxLossConfig(**LOSS),
        optim=JaxOptimConfig(grad_accum=ACCUM, grad_clip_norm=CLIP,
                             **OPTIM),
        data=JaxDataConfig(dataset="synthetic", image_size=HW,
                           batch_size=2))
    tx = jax_optimizer(jcfg.optim, jax_schedule(jcfg.optim, 1))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1), tx=tx)
    jstep = jax_make_train_step(jm, jcfg, MEAN, local_mesh(1))
    batches = _batches(MICRO_STEPS)
    host = jax.tree_util.tree_map(np.asarray, params)
    state, step = _port(model, host)
    out = {"model": model, "params0": state_dict_from_flax(host),
           "jax": [], "port": [], "batches": batches, "host": host}
    for b in batches:
        jstate, m = jstep(jstate, {k: jnp.asarray(b[k])
                                   for k in ("source", "target")})
        out["jax"].append({
            "metrics": jax.tree_util.tree_map(np.asarray, m),
            "step": int(jstate.step),
            "params": state_dict_from_flax(
                jax.tree_util.tree_map(np.asarray, jstate.params))})
        got = step(state, b)
        out["port"].append({"metrics": got, "step": state.step,
                            "updates": state.updates,
                            "mini_step": state.mini_step,
                            "params": _snapshot(state.model)})
    return out


def _assert_params_close(got: dict, want: dict, lr_sum: float, what: str):
    """Each tensor within 1e-4 of its largest entry, but for at most
    0.1% of the model's entries: those whose gradient sits near enough to
    zero to round to the other sign, which Adam moves by up to 2 lr an
    update."""
    over = total = 0
    for name, w in want.items():
        diff = (got[name] - w).abs()
        over += int((diff > 1e-4 * float(w.abs().max())).sum())
        total += diff.numel()
        assert float(diff.max()) <= 2 * lr_sum, f"{what} {name}"
    assert over <= 1e-3 * total, f"{what}: {over} of {total} entries"


def test_metrics_of_each_micro_step_match_jax(runs):
    for i, (g, w) in enumerate(zip(runs["port"], runs["jax"])):
        assert g["metrics"]["update_skipped"] == 0.0
        for k in ("total", "grad_norm"):
            np.testing.assert_allclose(g["metrics"][k], w["metrics"][k],
                                       rtol=1e-4, err_msg=f"{i} {k}")
        # both count applied micro-steps as the global step
        assert g["step"] == w["step"] == i + 1


def test_parameters_move_only_at_emission_and_match_jax(runs):
    p0 = runs["params0"]
    first = runs["port"][0]
    # micro-step 1 folds into the accumulator: not a bit moves
    for name, t in first["params"].items():
        assert torch.equal(t, p0[name].to(t.dtype)), name
    for name, t in runs["jax"][0]["params"].items():
        assert torch.equal(t, p0[name]), name
    assert (first["updates"], first["mini_step"]) == (0, 1)
    for i in (1, 3):  # after micro-steps 2 and 4: updates 1 and 2
        got, want = runs["port"][i], runs["jax"][i]
        assert (got["updates"], got["mini_step"]) == ((i + 1) // 2, 0)
        moved = [n for n, t in got["params"].items()
                 if not torch.equal(t, runs["port"][i - 1]["params"][n])]
        assert moved, f"micro-step {i + 1} emitted no update"
        lr_sum = sum(OPTIM["learning_rate"] * 0.5 ** (j * ACCUM)
                     for j in range((i + 1) // 2))
        _assert_params_close(got["params"], want["params"], lr_sum,
                             f"after micro-step {i + 1}")


def test_learning_rate_at_emission_is_the_schedule_of_j_times_accum(
        params):
    """Emitted update j takes schedule(j * grad_accum), as the JAX inner
    schedule `lambda count: schedule(count * accum)` does."""
    state, step = _port("flownet_s", params)
    want = jax_schedule(JaxOptimConfig(**OPTIM), 1)
    lrs = []
    for i, b in enumerate(_batches(6)):
        lr = float(state.learning_rate())  # the next update's rate
        step(state, b)
        if state.mini_step == 0:
            lrs.append(lr)
    assert state.updates == 3
    assert lrs == pytest.approx([float(want(j * ACCUM)) for j in range(3)],
                                rel=1e-12)
    assert lrs[1] == pytest.approx(OPTIM["learning_rate"] / 4, rel=1e-12)


def test_a_poisoned_micro_batch_leaves_the_accumulation_as_it_was(runs):
    state, step = _port(runs["model"], runs["host"])
    batches = runs["batches"]
    step(state, batches[0])
    before = ([a.clone() for a in state.acc], state.mini_step, state.step,
              state.updates, _snapshot(state.model))
    bad = dict(batches[1], source=batches[1]["source"].copy())
    bad["source"][0, 0, 0, 0] = np.nan
    m = step(state, bad)
    assert m["update_skipped"] == 1.0 and not np.isfinite(m["total"])
    acc, mini, gstep, updates, params = before
    assert (state.mini_step, state.step, state.updates) == (mini, gstep,
                                                            updates)
    for a, b in zip(state.acc, acc):
        assert torch.equal(a, b)
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, params[name]), name
    # Adam has not stepped: its moments are optax's zeros
    assert all(not t.any() for s in state.optimizer.state.values()
               for t in s.values())
    # the next finite micro-step completes the accumulation, as micro-step
    # 2 of the uninterrupted run does: the same parameters, bit for bit
    step(state, batches[1])
    ref_state, ref_step = _port(runs["model"], runs["host"])
    ref_step(ref_state, batches[0])
    ref_step(ref_state, batches[1])
    for name, t in state.model.state_dict().items():
        assert torch.equal(t, ref_state.model.state_dict()[name]), name


def test_save_mid_accumulation_resumes_to_the_same_bits(tmp_path, params):
    batches = _batches(MICRO_STEPS)
    ref, ref_step = _port("flownet_s", params)
    for b in batches:
        ref_step(ref, b)
    state, step = _port("flownet_s", params)
    for b in batches[:3]:
        step(state, b)
    assert (state.step, state.updates, state.mini_step) == (3, 1, 1)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(state)
    resumed, resumed_step = _port("flownet_s", params)
    assert CheckpointManager(str(tmp_path / "ckpt")).restore(resumed)
    assert (resumed.step, resumed.updates, resumed.mini_step) == (3, 1, 1)
    for a, b in zip(resumed.acc, state.acc):
        assert torch.equal(a, b)
    resumed_step(resumed, batches[3])
    assert (resumed.step, resumed.updates) == (ref.step, ref.updates)
    for name, t in resumed.model.state_dict().items():
        assert torch.equal(t, ref.model.state_dict()[name]), name
    for (_, a), (_, b) in zip(resumed.optimizer.state.items(),
                              ref.optimizer.state.items()):
        for key in a:
            assert torch.equal(torch.as_tensor(a[key]),
                               torch.as_tensor(b[key])), key


def test_a_checkpoint_without_an_accumulator_does_not_restore_into_one(
        tmp_path, params):
    """A grad_accum = 1 checkpoint (as every checkpoint written before the
    accumulator was carried) fails the structure check of a grad_accum = 2
    run, and restores into a grad_accum = 1 one."""
    plain, plain_step = _port("flownet_s", params, grad_accum=1)
    plain_step(plain, _batches(1)[0])
    CheckpointManager(str(tmp_path / "ckpt")).save(plain)
    accum, _ = _port("flownet_s", params)
    with pytest.warns(RuntimeWarning, match="structure"):
        assert CheckpointManager(str(tmp_path / "ckpt")).restore(
            accum) is None
    again, _ = _port("flownet_s", params, grad_accum=1)
    assert CheckpointManager(str(tmp_path / "ckpt")).restore(again)
    assert (again.step, again.updates, again.mini_step) == (1, 1, 0)


def test_the_clip_acts_on_the_mean_of_the_micro_gradients(params):
    """With a clip below every norm in play, the emitted update is Adam on
    the mean scaled to the clip; the micro-steps' own norms (the
    grad_norm metric) do not enter it."""
    clip = 1.0
    state, step = _port("flownet_s", params, grad_clip_norm=clip)
    cfg = _port_cfg("flownet_s", grad_clip_norm=clip)
    batches = _batches(2)
    norms = [step(state, b)["grad_norm"] for b in batches]
    assert state.updates == 1
    # the reference: each micro-gradient from the same weights, the mean
    # as optax's running mean forms it, its norm, the clip, and a fresh
    # Adam (optax's first update, written out in optax's order)
    ref_model = build_model("flownet_s", width_mult=0.25, device="cpu")
    load_flax_params(ref_model, params)
    grads = []
    for b in batches:
        ref_model.zero_grad(set_to_none=True)
        model_losses(ref_model, batch_to_device(b, "cpu"), MEAN,
                     cfg.loss)[0].backward()
        grads.append([p.grad.clone() for p in ref_model.parameters()])
    mean = [g1 + (g2 - g1) / 2 for g1, g2 in zip(*grads)]
    norm = global_norm(mean)
    assert norm > clip
    assert all(abs(norm - n) > 1e-3 * n for n in norms)
    o = cfg.optim
    one = torch.tensor(1.0)
    lr = torch.tensor(o.learning_rate, dtype=torch.float64).float()
    for (name, t), r, g in zip(state.model.named_parameters(),
                               ref_model.parameters(), mean):
        g = g / norm * clip
        mu = (g * (1 - o.beta1)) / (1 - torch.pow(o.beta1, one))
        nu = (g * g * (1 - o.beta2)) / (1 - torch.pow(o.beta2, one))
        want = r.detach() + mu / (nu.sqrt() + o.adam_eps) * -lr
        assert torch.equal(t, want), name
