"""The port's spatial context parallelism (`parallel/spatial.py`, the
row-sharded layers of `models/common.py`, `models/flownet_s.py`,
`models/flownet_c.py`, and `train/step.py`'s invariant): two gloo ranks
on the CPU (`tests/_torch_spatial_worker.py`) against one process.

Thin FlowNet-C (width 0.25, max_disp 2, stride 1) and FlowNet-S at
256x96 (H = 256: the gate's bound at downsample 64 over 2 shards, two
rows a shard at the deepest level), global batch 2, the L1-like loss
of `tests/test_torch_ddp.py` (alpha 0.5, F6). Tolerances:
  - the gate (`min_spatial_height`, `spatial_cp_active`): equal to the
    JAX package's over a grid;
  - a spatial=2 step against the port's one-process step on the same
    rows from the same weights (one CPU thread, as each rank): the loss
    within 1e-5 relative, each gradient within SHARDED_TOL = 5e-5 of its
    largest entry, both ranks' gradients bitwise equal (one all_reduce).
    The rows' split changes the order of the float32 sums over the
    image: conv1's weight gradient sums ~25k pixels, and the two orders
    differ by 1.04e-5 (FlowNet-C), 6.3e-6 (FlowNet-S) and 1.81e-5 (H =
    320) of its largest entry, the float32 floor at this size
    (`tests/test_torch_ddp.py`'s 1e-5 is at 16x32); a gradient off by a
    row's halo or a factor is off by far more;
  - H = 320 (the uneven deepest level: 5 rows, 3 + 2): the same;
  - H = 128 (the gate off: the ranks are replicas, the JAX loop's
    warning record): the one-process step's bits. A gradient counted
    once on each replica and summed would come back doubled;
  - the gathered eval's AEE, AAE and val_loss under spatial=2 within
    1e-5 relative of one process's.
Every model family passes the gate in float32 (each family's own steps:
`tests/test_torch_spatial_families*.py`); bf16 compute and the elastic
pool refuse, naming ROADMAP item 10.
"""

import itertools
import os
import sys

import numpy as np
import pytest
import torch

from deepof_tpu.parallel import spatial as JS
from deepof_tpu_torch.core.config import MeshConfig
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.parallel import spatial as TS
from deepof_tpu_torch.parallel.mesh import World
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import make_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _torch_spatial_worker as W  # noqa: E402

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ONE = World(np.zeros((1, 1, 1)))  # one process, no process group
#: the JAX tool's probes (spatial, H, depth), deepof_tpu's
#: tools/halo_grad_repro.py:96-107
TS_PROBES = ((2, 64, 5), (2, 32, 4), (2, 128, 5), (4, 64, 3), (4, 32, 3),
             (4, 32, 4), (2, 160, 5), (2, 80, 4), (4, 160, 4))
WIDTH = 96
SHARDED_TOL = 5e-5
CASES = [
    {"name": "c256", "kind": "step", "model": "flownet_c", "hw": [256, WIDTH]},
    {"name": "s256", "kind": "step", "model": "flownet_s", "hw": [256, WIDTH]},
    {"name": "c320", "kind": "step", "model": "flownet_c", "hw": [320, WIDTH]},
    {"name": "c128", "kind": "step", "model": "flownet_c", "hw": [128, WIDTH]},
    {"name": "e256", "kind": "eval", "model": "flownet_c", "hw": [256, WIDTH]},
    {"name": "g128", "kind": "gate", "model": "flownet_c", "hw": [128, WIDTH]},
]
for _c in CASES:
    _c.update(batch=2, mesh=[1, 2, 1])


def write_case(work: str, case: dict, seed: int = 0) -> None:
    """The case's weights (the port's init) and global batch (a fixed
    draw of the synthetic dataset, `seed`'s)."""
    model = W.model_for(case)
    torch.save(model.state_dict(), os.path.join(work, f"{case['name']}.pt"))
    cfg = W.config(case)
    batch = SyntheticData(cfg.data).sample_train(
        case["batch"], rng=derive_batch_rng(np.array([5, seed], np.uint32),
                                            0))
    np.savez(os.path.join(work, f"{case['name']}.npz"),
             **{k: batch[k] for k in ("source", "target", "volume",
                                      "label") if k in batch})


def one_process_step(work: str, case: dict) -> tuple[dict, dict]:
    """The port's step of the case on one process, on one CPU thread as
    each rank steps: metrics, gradients."""
    cfg = W.config({**case, "mesh": [1, 1, 1]})
    model = W.model_for(case)
    model.load_state_dict(torch.load(os.path.join(work,
                                                  f"{case['name']}.pt")))
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    with np.load(os.path.join(work, f"{case['name']}.npz")) as z:
        batch = {k: z[k] for k in z.files}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = make_train_step(model, cfg, (0.0, 0.0, 0.0), world=ONE)(state,
                                                                    batch)
    finally:
        torch.set_num_threads(threads)
    return m, {n: p.grad for n, p in model.named_parameters()}


def assert_step_matches(got: dict, want_metrics: dict, want_grads: dict,
                        tol: float = 1e-5) -> None:
    """The loss and the scale stacks within 1e-5 relative, the gradient
    norm 1e-4, each gradient within `tol` of its largest entry."""
    for k in ("total", "scale_total", "scale_smooth"):
        np.testing.assert_allclose(got["metrics"][k].numpy(),
                                   want_metrics[k].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(got["metrics"]["grad_norm"]),
                               float(want_metrics["grad_norm"]), rtol=1e-4)
    assert set(got["grads"]) == set(want_grads)
    for name, g in want_grads.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(got["grads"][name].numpy(), g.numpy(),
                                   rtol=0, atol=tol * scale, err_msg=name)


@pytest.fixture(scope="module")
def world_run(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("spatial"))
    for case in CASES:
        write_case(work, case)
    return {"work": work, "ranks": W.launch(work, CASES, 2)}


@pytest.mark.parametrize("down,spatial", itertools.product(
    (32, 64), range(1, 9)))
def test_gate_matches_jax(down, spatial):
    assert TS.MIN_ROWS_PER_SHARD == JS.MIN_ROWS_PER_SHARD
    assert (TS.min_spatial_height(down, spatial)
            == JS.min_spatial_height(down, spatial))
    for h in list(range(8, 1100, 8)) + [320, 436, 520, 1024, 255, 257]:
        assert (TS.spatial_cp_active(h, down, spatial)
                == JS.spatial_cp_active(h, down, spatial)), h


def test_pair_block_follows_jax_condition():
    # (T-1) B = 2 x 2 over data x time = 1 x 2: two pairs a rank
    assert TS.pair_block(2, 3, 1, 2, 0) == (0, 2)
    assert TS.pair_block(2, 3, 1, 2, 1) == (2, 4)
    # over data 2: each data shard's 2 pairs split in one a rank
    assert TS.pair_block(2, 3, 2, 2, 1) == (1, 2)
    # (T-1) B = 3 does not divide by 2: no split, as JAX's constraint
    assert TS.pair_block(1, 4, 1, 2, 0) is None
    assert TS.pair_block(4, 3, 1, 1, 0) is None


@pytest.mark.parametrize("name", ["c256", "s256", "c320", "c128"])
def test_spatial_step_matches_one_process(world_run, name):
    case = next(c for c in CASES if c["name"] == name)
    want_m, want_g = one_process_step(world_run["work"], case)
    r0, r1 = (r[name] for r in world_run["ranks"])
    assert_step_matches(r0, want_m, want_g, SHARDED_TOL)
    if name == "c128":
        # replicas: each rank's step is the one-process step, and the
        # invariant's 1/2 and the sum over the group give back its bits
        for n, g in want_g.items():
            assert torch.equal(r0["grads"][n], g), n
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n
    for k, v in r0["metrics"].items():
        assert torch.equal(v, r1["metrics"][k]), k
    stats = r0["stats"]
    if name == "c128":
        # the gate is off: replicas, nothing crosses the wire
        assert stats["halo_bytes"] == stats["gather_bytes"] == 0
    else:
        assert stats["halo_bytes"] > 0 and stats["gather_calls"] > 0


def test_gate_off_warns_as_jax(world_run):
    msgs = world_run["ranks"][0]["g128"]["warnings"]
    assert any(m.startswith("spatial CP inactive: H=128 fails the "
                            "gradient-safety gate for flownet_c at "
                            "spatial=2 (need H >= 256") for m in msgs), msgs
    # at the bound, no warning
    assert not any("spatial CP" in m
                   for m in world_run["ranks"][0]["e256"]["warnings"])


def test_gathered_eval_matches_one_process(world_run, tmp_path):
    case = next(c for c in CASES if c["name"] == "e256")
    cfg = W.config({**case, "mesh": [1, 1, 1]}, str(tmp_path))
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data), device="cpu",
                      world=ONE)
    trainer.model.load_state_dict(torch.load(os.path.join(
        world_run["work"], "e256.pt")))
    want = trainer.evaluate()
    for r in world_run["ranks"]:
        got = r["e256"]["eval"]
        for k in ("aee", "aae", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("model,hw,setting", [
    ("inception_v3", (256, 256), {}),
    ("vgg16", (256, 256), {}),
    ("st_single", (256, 256), {}),
    ("flownet_cs", (384, 512), {}),
    ("st_baseline", (384, 512), {}),
    ("ucf101_spatial", (256, 256), {}),
    ("flownet_c", (384, 512), {"compute_dtype": "bfloat16"}),
    ("flownet_s", (384, 512), {"compute_dtype": "bfloat16"}),
])
def test_unported_families_refuse_naming_item_10(model, hw, setting):
    """Where the gate would shard rows (mesh.spatial=2) or split a
    volume's pairs (mesh.time=2), every family trains sharded in float32
    (item 10.1) and in bf16 compute (item 10.2); the elastic pool (item
    10.3) still raises, naming item 10, in either dtype; below the gate
    the ranks are replicas and nothing raises."""
    import dataclasses

    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)

    cfg = ExperimentConfig(model=model, mesh=MeshConfig(spatial=2),
                           data=DataConfig(image_size=hw),
                           train=TrainConfig(**setting))

    def dtype(c, name):
        return c.replace(train=dataclasses.replace(c.train,
                                                   compute_dtype=name))

    f32, bf16 = dtype(cfg, "float32"), dtype(cfg, "bfloat16")
    # the volume's pairs split over time=2 ((T-1) x batch divides by 2)
    vol = cfg.replace(mesh=MeshConfig(time=2), data=dataclasses.replace(
        cfg.data, time_step=3, batch_size=2))
    assert TS.context_parallel(vol, 64)[1]
    for c in (cfg, f32, bf16, vol, dtype(vol, "bfloat16")):
        TS.check_context_parallel(c)  # sharded, in either dtype
        with pytest.raises(NotImplementedError, match="item 10.3"):
            TS.check_context_parallel(c, elastic=True)
    small = cfg.replace(data=dataclasses.replace(cfg.data,
                                                 image_size=(64, 64)))
    for c in (small, dtype(small, "bfloat16")):
        TS.check_context_parallel(c)  # the gate is off: replicas
        TS.check_context_parallel(c, elastic=True)


def test_halo_grad_repro_finds_the_exchange_exact():
    """The JAX repro's probes on the port's exchange (two and four gloo
    ranks on the CPU): every layer's kernel gradient within the JAX
    tool's 1e-3 of the one-process gradient, ratio 1, where GSPMD gave
    x4 (spatial 2, H 64 depth 5 and H 32 depth 4) and x2 (spatial 4, H
    32 depth 4); the lines in the JAX tool's format."""
    import json
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "deepof_tpu_torch.tools.halo_grad_repro",
         "--device", "cpu"], capture_output=True, text=True, env=env,
        cwd=repo, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    verdict = json.loads(lines[-1])
    assert verdict["exact"] is True
    probes = {(p["spatial"], p["H"], p["depth"]): p
              for p in verdict["probes"]}
    assert set(probes) == set(TS_PROBES)
    for key in ((2, 64, 5), (2, 32, 4), (4, 32, 4)):
        for layer in probes[key]["layers"].values():
            assert abs(layer["ratio"] - 1.0) < 1e-4
    assert lines[0] == ("spatial=2 H=64 depth=5 coarsestH=2 "
                        "(1.0 rows/shard):")
    assert "MISMATCH" not in res.stdout
