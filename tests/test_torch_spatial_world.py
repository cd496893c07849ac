"""The port's halo exchange, a data x spatial world, temporal pair
parallelism and `train --multihost` with `mesh.spatial=2`
(`parallel/spatial.py`, `parallel/mesh.py`, `losses/pyramid.py`,
`train/step.py`): gloo ranks on the CPU (`tests/_torch_spatial_worker.py`
and torchrun) against JAX and against one process.

  - `halo_exchange` over 4 ranks equals the JAX `halo_exchange` under
    `shard_map` on the suite's 8-device mesh (data 2 x spatial 4), on the
    array of `tests/test_parallel.py::test_halo_exchange_ring`, exactly;
    its backward equals autograd of one process's pad-and-slice,
    exactly (each halo's gradient added once at its owner);
  - a data 2 x spatial 2 world of 4 ranks (thin FlowNet-C at 256x96,
    global batch 4: two rows a data shard) against the one-process step
    of the whole batch: the loss within 1e-5 relative, each gradient
    within `test_torch_spatial.py`'s SHARDED_TOL of its largest entry
    (the float32 floor of the rows' split at this size), all four ranks
    bitwise equal;
  - a time=2 volume step (thin FlowNet-S, T = 3, 64x96, batch 2: two
    of the four folded pairs a rank) against one process: the loss
    within 1e-5 relative, each gradient within 1e-5 of its largest
    entry;
  - the same volume step in bf16 compute (`train.compute_dtype=
    bfloat16`, ROADMAP item 10.2) from the same weights and batch: its
    gradients' distance from the one-process float64 step within
    `_torch_spatial_families.BF16_SPREAD` times the one-process bf16
    step's (worst and median tensor), the loss within BF16_LOSS_RTOL of
    the one-process bf16 loss, both ranks bitwise equal;
  - `torchrun ... train --multihost --set mesh.spatial=2` for 2 steps
    on the CPU, in float32 and in bf16 compute: finite losses and rank
    0's records.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from deepof_tpu.core.config import MeshConfig as JaxMeshConfig
from deepof_tpu.parallel.mesh import build_mesh as jax_build_mesh
from deepof_tpu.parallel.spatial import halo_exchange as jax_halo_exchange

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spatial_families as F  # noqa: E402
import _torch_spatial_worker as W  # noqa: E402
from test_torch_spatial import (SHARDED_TOL,  # noqa: E402
                                assert_step_matches, one_process_step,
                                write_case)

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HALO = {"name": "halo", "kind": "halo", "halo": 2, "mesh": [1, 4, 1]}
GRID = {"name": "grid", "kind": "step", "model": "flownet_c",
        "hw": [256, 96], "batch": 4, "mesh": [2, 2, 1]}
VOLUME = {"name": "volume", "kind": "step", "model": "flownet_s",
          "hw": [64, 96], "batch": 2, "time_step": 3, "mesh": [1, 1, 2]}
VOLUME_BF16 = {**VOLUME, "name": "volume_bf16", "dtype": "bfloat16"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial_world"))
    x = np.arange(8 * 16 * 4, dtype=np.float32).reshape(8, 16, 4)
    w = np.random.RandomState(0).randn(8, 32, 4).astype(np.float32)
    np.savez(os.path.join(work, "halo.npz"), x=x, w=w)
    for case in (GRID, VOLUME, VOLUME_BF16):
        write_case(work, case)
    four = W.launch(work, [HALO, GRID], 4)
    two = W.launch(work, [VOLUME, VOLUME_BF16], 2)
    return {"work": work, "x": x, "w": w, "four": four, "two": two}


def test_halo_exchange_equals_jax_under_shard_map(runs):
    mesh = jax_build_mesh(JaxMeshConfig(spatial=4, data=2))
    fn = shard_map(
        lambda blk: jax_halo_exchange(blk, halo=2, axis_name="spatial",
                                      axis=1),
        mesh=mesh, in_specs=P(("data",), "spatial"),
        out_specs=P(("data",), "spatial"))
    want = np.asarray(fn(jnp.asarray(runs["x"])))  # (8, 32, 4)
    got = np.concatenate([r["halo"]["out"].numpy() for r in runs["four"]],
                         axis=1)
    np.testing.assert_array_equal(got, want)


def test_halo_exchange_backward_is_the_pad_and_slice_adjoint(runs):
    x = torch.tensor(runs["x"], requires_grad=True)
    padded = torch.nn.functional.pad(x, (0, 0, 2, 2))
    out = torch.cat([padded[:, 4 * s:4 * s + 8] for s in range(4)], dim=1)
    (out * torch.tensor(runs["w"])).sum().backward()
    got = torch.cat([r["halo"]["grad"] for r in runs["four"]], dim=1)
    assert torch.equal(got, x.grad)


def test_data_by_spatial_world_matches_one_process(runs):
    want_m, want_g = one_process_step(runs["work"], GRID)
    ranks = [r["grid"] for r in runs["four"]]
    assert_step_matches(ranks[0], want_m, want_g, SHARDED_TOL)
    for r in ranks[1:]:
        for n, g in ranks[0]["grads"].items():
            assert torch.equal(g, r["grads"][n]), n
        assert torch.equal(ranks[0]["metrics"]["total"],
                           r["metrics"]["total"])
    # rows sharded in each data shard's spatial group
    assert all(r["stats"]["halo_bytes"] > 0 for r in ranks)


def test_time_axis_volume_step_matches_one_process(runs):
    want_m, want_g = one_process_step(runs["work"], VOLUME)
    r0, r1 = (r["volume"] for r in runs["two"])
    assert_step_matches(r0, want_m, want_g)
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n


def test_time_axis_volume_bf16_step_within_the_spread(runs):
    want_m, want_g = F.one_process_step(runs["work"], VOLUME_BF16)
    _, exact = F.one_process_step(runs["work"], VOLUME, torch.float64)
    r0, r1 = (r["volume_bf16"] for r in runs["two"])
    np.testing.assert_allclose(float(r0["metrics"]["total"]),
                               float(want_m["total"]),
                               rtol=F.BF16_LOSS_RTOL)
    F.assert_spread(r0["grads"], want_g, exact)
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n


def test_train_multihost_spatial_on_the_cpu(tmp_path):
    train_multihost_spatial(str(tmp_path / "run"))


def test_train_multihost_spatial_bf16_on_the_cpu(tmp_path):
    train_multihost_spatial(str(tmp_path / "run"), "bfloat16")


def train_multihost_spatial(log_dir: str, dtype: str = "float32") -> None:
    """`torchrun ... train --multihost --set mesh.spatial=2` for 2 steps
    of thin FlowNet-C at 256x96 in `dtype` compute."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(W.free_port()),
         "-m", "deepof_tpu_torch", "train", "--multihost", "--synthetic",
         "--model", "flownet_c", "--device", "cpu", "--steps", "2",
         "--set", "width_mult=0.25", "--set", "corr_max_disp=2",
         "--set", "corr_stride=1", "--set", "mesh.spatial=2",
         "--set", "data.image_size=[256,96]",
         "--set", "data.gt_size=[256,96]", "--set", "data.batch_size=2",
         "--set", "train.eval_batch_size=2", "--set", "train.log_every=1",
         "--set", "train.eval_every=0",
         "--set", "train.ckpt_every_epochs=1000000",
         "--set", f"train.compute_dtype={dtype}", "--log-dir", log_dir],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert (records[0]["dist_backend"], records[0]["world_size"]) == (
        "gloo", 2)
    assert not any("spatial CP inactive" in r.get("message", "")
                   for r in records)
