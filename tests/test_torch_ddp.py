"""The port's data-parallel training across processes (`parallel/mesh.py`,
`train/step.py`, `train/loop.py`, `train/evaluate.py`): two gloo ranks
on the CPU, each a subprocess (`tests/_torch_ddp_worker.py`), against
one process.

Thin FlowNet-C (width 0.25, 16x32, max_disp 2, stride 1), global batch
4, two rows a rank, the L1-like loss of `tests/test_torch_train.py`
(alpha 0.5: its gradient does not amplify rounding). Tolerances:
  - the averaged gradient against the JAX package's single-process
    gradient of the same global batch from the same weights
    (`convert.py`): 1e-4 of each tensor's largest entry, the loss 1e-4
    relative, as `test_torch_train.py` holds one step (XLA and PyTorch
    sum the convolutions in other orders);
  - against the port's own single-process step: 1e-5 of the largest
    entry and 1e-5 relative on the metrics (only the order of the batch
    sum differs: two means of two rows, averaged, against one mean of
    four), and the two ranks' gradients bitwise equal (one all_reduce);
  - a 3-step `Trainer.fit` of two ranks against one process on the same
    global batches: the losses 1e-5 relative, the gradient norms 1e-4;
    the update each applied (final less initial parameters, from bitwise
    equal inits) within 1e-3 of the one-process update's norm, at most
    1e-4 of the entries more than 0.01 lr apart and none more than 6 lr
    (Adam's first updates are lr x sign(g): a rounding-level gradient
    entry may flip its step, 2 lr a step); the two ranks' parameters
    bitwise equal;
  - the gathered eval's AEE, AAE and val_loss against one process's:
    1e-5 relative;
  - the dispatch fault (one NaN) on rank 0 alone: both ranks skip the
    same step and keep equal parameters.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import LossConfig as JaxLossConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.train.step import model_losses as jax_model_losses
from deepof_tpu_torch.convert import state_dict_from_flax
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.core.config import DataConfig
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.parallel.mesh import World
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_ddp_worker as W  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE = World(np.zeros((1, 1, 1)))  # one process, no process group


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    """The flax init, the global batch, and both ranks' outputs."""
    work = str(tmp_path_factory.mktemp("ddp"))
    jm = jax_build_model("flownet_c", width_mult=0.25, **W.GEOMETRY)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, *W.HW, 6)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    torch.save(state_dict_from_flax(params),
               os.path.join(work, "weights.pt"))
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=W.HW))
    batch = ds.sample_train(W.BATCH, rng=derive_batch_rng(
        np.array([5, 0], np.uint32), 0))
    np.savez(os.path.join(work, "batch.npz"), **batch)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "_torch_ddp_worker.py"),
         work, port, str(r), "2"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
             for r in range(2)]
    return {"work": work, "params": params, "batch": batch, "ranks": ranks,
            "jm": jm}


def test_two_ranks_join_over_gloo(world_run):
    for r in world_run["ranks"]:
        assert (r["backend"], r["size"]) == ("gloo", 2)


def test_averaged_gradient_matches_the_jax_global_batch(world_run):
    batch, jm = world_run["batch"], world_run["jm"]

    def objective(p):
        return jax_model_losses(jm, p, {k: jnp.asarray(batch[k])
                                        for k in ("source", "target")},
                                (0.0, 0.0, 0.0), JaxLossConfig(**W.LOSS))

    (total, _), grads = jax.jit(jax.value_and_grad(
        objective, has_aux=True))(world_run["params"])
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    r0, r1 = (r["grad"] for r in world_run["ranks"])
    np.testing.assert_allclose(float(r0["metrics"]["total"]), float(total),
                               rtol=1e-4)
    assert set(r0["grads"]) == set(want)
    for name, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(r0["grads"][name].numpy(), w.numpy(),
                                   rtol=0, atol=1e-4 * scale, err_msg=name)
        # one all_reduce: the same bits on both ranks
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name
    for k, v in r0["metrics"].items():
        assert torch.equal(v, r1["metrics"][k]), k


def test_averaged_gradient_matches_one_process(world_run):
    cfg = W.config(os.path.join(world_run["work"], "one"))
    model = build_model("flownet_c", width_mult=0.25, device="cpu",
                        **W.GEOMETRY)
    model.load_state_dict(state_dict_from_flax(world_run["params"]))
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    m = make_train_step(model, cfg, (0.0, 0.0, 0.0), world=ONE)(
        state, world_run["batch"])
    r0 = world_run["ranks"][0]["grad"]
    for k in ("total", "grad_norm", "update_skipped", "scale_total"):
        np.testing.assert_allclose(r0["metrics"][k].numpy(),
                                   m[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for name, p in model.named_parameters():
        scale = float(p.grad.abs().max())
        np.testing.assert_allclose(r0["grads"][name].numpy(),
                                   p.grad.numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def test_gathered_eval_matches_one_process(world_run, tmp_path):
    trainer = Trainer(W.config(str(tmp_path)),
                      dataset=W.FixedStream(range(W.BATCH)), device="cpu",
                      world=ONE)
    want = trainer.evaluate()
    for r in world_run["ranks"]:
        got = r["eval"]
        assert set(got) == set(want)
        for k in ("aee", "aae", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


def _train_records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == "train"]


def test_two_rank_fit_matches_one_process(world_run, tmp_path):
    one = W.fit(ONE, str(tmp_path))
    r0, r1 = (r["fit"] for r in world_run["ranks"])
    want = _train_records(str(tmp_path))
    got = _train_records(os.path.join(world_run["work"], "fit"))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(g["loss_total_by_scale"],
                                   w["loss_total_by_scale"], rtol=1e-4)
    assert r0["step"] == r1["step"] == one["step"] == 3
    # the backend in the first record (rank 0 alone writes) and in the
    # summary
    with open(os.path.join(world_run["work"], "fit", "metrics.jsonl")) as f:
        first = json.loads(f.readline())
    assert (first["dist_backend"], first["world_size"]) == ("gloo", 2)
    assert r0["summary"]["pipeline_depth"] == 0
    assert r0["summary"]["dist_backend"] == "gloo"
    for name, p in one["params"].items():
        assert torch.equal(r0["params"][name], r1["params"][name]), name
    # the update each fit applied, from the same init: Adam moves an
    # entry by about lr a step, so the parameters alone cannot tell a
    # right update from none. Entries a step apart by a gradient sign
    # flipped at rounding level (2 lr a step) must stay rare
    lr = W.config("").optim.learning_rate
    names = list(one["params"])
    for name in names:
        assert torch.equal(r0["init"][name], one["init"][name]), name
    got_du = torch.cat([(r0["params"][n] - r0["init"][n]).reshape(-1)
                        for n in names])
    want_du = torch.cat([(one["params"][n] - one["init"][n]).reshape(-1)
                         for n in names])
    off = (got_du - want_du).abs()
    assert float(want_du.abs().max()) > 2 * lr  # three steps moved it
    assert float(off.max()) <= 2 * lr * 3
    assert int((off > 1e-2 * lr).sum()) <= 1e-4 * off.numel()
    assert float((got_du - want_du).norm()) <= 1e-3 * float(want_du.norm())


def test_a_nan_on_one_rank_skips_the_step_on_both(world_run):
    r0, r1 = (r["nan"] for r in world_run["ranks"])
    # loop step 1's call poisoned on rank 0: the averaged loss is NaN,
    # so both skip micro-step 2 and apply two of three
    assert r0["summary"]["fault_dispatch"] == 1
    assert "fault_dispatch" not in r1["summary"]
    for r in (r0, r1):
        assert r["summary"]["skipped_updates"] == 1
        assert r["step"] == 2
    for name, p in r0["params"].items():
        assert torch.equal(p, r1["params"][name]), name
        assert torch.isfinite(p).all(), name
