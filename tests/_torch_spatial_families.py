"""The model families under spatial context parallelism, shared by
`tests/test_torch_spatial_families_*.py`: each file runs its families'
cases in one launch of two gloo ranks on the CPU
(`tests/_torch_spatial_worker.py`) and holds them against the port's
one-process step and eval and against the JAX package's single-process
`model_losses` gradient.

For each family (a name of `FAMILIES`: the model, its rows at the gate's
bound of its depth, its frames), from the flax init of the JAX model
(through `convert.py`) and a fixed synthetic global batch of 2:
  - "<name>": the spatial=2 train step, an action model's dropout off
    (the JAX reference runs at train=False): against the one-process
    port step of the same rows and weights (one CPU thread, as each
    rank), the loss within 1e-6 relative and each gradient within 1e-5
    of its tensor's largest entry, both ranks bitwise equal, halos and
    gathers on the wire; and against the JAX `model_losses` gradient in
    float64 (`jax.enable_x64` inside the test and every flax layer's
    `dtype` float64, as `tests/test_torch_spatial_jax.py` holds
    FlowNet-C and -S), each gradient within 1e-4 of its tensor's largest
    entry and the loss 1e-4 relative;
  - "<name>_dropout" (action models): the spatial=2 train step with its
    dropout, whose masks are the global batch's on every spatial rank
    (F19), against the one-process step with the same masks, as above;
  - "<name>_bf16": the spatial=2 train step in bf16 compute
    (`train.compute_dtype=bfloat16`, ROADMAP item 10.2), half as wide
    as it is high (`bf16_hw`), from the port's init, dropout off: its gradients' distance from the
    port's one-process float64 step (every layer in float64, the
    correlation's float32 sum as in the kernel) at most BF16_SPREAD
    times the one-process bf16 step's, on the worst tensor and on the
    median one (`assert_bf16_spread`), and the loss within
    BF16_LOSS_RTOL of the one-process bf16 loss, both ranks bitwise
    equal;
  - "eval_<name>": the Trainer's eval (`evaluate_aee`, or
    `evaluate_ucf101` for an action model, through `gathered_eval_fn`)
    under spatial=2 against one process's, within 1e-5 relative, on a
    synthetic val split of 4.
`train_multihost` runs the command line over two gloo ranks on the CPU
(`torchrun ... train --multihost --set mesh.spatial=2`): 2 steps,
finite losses, gloo over 2 ranks, no "spatial CP inactive" warning.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

import _torch_spatial_worker as W
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.parallel.mesh import World
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from test_torch_spatial import write_case

ONE = World(np.zeros((1, 1, 1)))
#: name: (model, rows, frames); the width is WIDTH, the gate's bound
#: is 128 rows at downsample 32 and 256 at 64 over 2 shards
FAMILIES = {"inception": ("inception_v3", 128, 2),
            "inception_volume": ("inception_v3", 128, 3),
            "vgg16": ("vgg16", 128, 2),
            "flownet_cs": ("flownet_cs", 256, 2),
            "st_single": ("st_single", 128, 2),
            "st_baseline": ("st_baseline", 256, 2),
            "ucf101_spatial": ("ucf101_spatial", 128, 2)}
ACTION = ("st_single", "st_baseline", "ucf101_spatial")
WIDTH = 16
STEP_TOL = 1e-5
LOSS_RTOL = 1e-6
JAX_TOL = 1e-4
EVAL_VAL = 4
#: a bf16 step's distance from the float64 step (each tensor's largest
#: difference over its largest entry): the spatial ranks' at most
#: BF16_SPREAD times the one-process bf16 step's, on the worst and the
#: median tensor. Bit equality is not expected: the row-sharded
#: convolutions sum their bf16 products in another order. 4 is the
#: float32 check's FLOAT32_SPREAD (chip_smoke.py).
BF16_SPREAD = 4.0
#: the sharded bf16 loss against the one-process bf16 loss, relative
BF16_LOSS_RTOL = 5e-3
#: the bf16 cases' width: half the rows, so the deepest level keeps two
#: columns. At WIDTH every level's border mask covers the image (the
#: loss is 0), and PyTorch's CPU `conv_transpose2d` in bf16 returns an
#: input gradient of uninitialized memory for a 1-column input whose
#: column padding crops the output (torch 2.13.0+cpu: 224, NaN or 4e20
#: for a zero cotangent; PERF.md), which a decoder's deepest deconv is
#: at a 1-column level
def bf16_hw(rows: int) -> list[int]:
    return [rows, rows // 2]


def step_case(name: str) -> dict:
    model, rows, t = FAMILIES[name]
    return {"name": name, "kind": "step", "model": model,
            "hw": [rows, WIDTH], "batch": 2, "time_step": t,
            "mesh": [1, 2, 1], "dropout": False}


def cases(names) -> list[dict]:
    """Every case of the families `names`, in launch order."""
    out = []
    for name in names:
        step = step_case(name)
        out.append(step)
        out.append({**step, "name": f"{name}_bf16", "dtype": "bfloat16",
                    "hw": bf16_hw(step["hw"][0])})
        if step["model"] in ACTION:
            out.append({**step, "name": f"{name}_dropout", "dropout": True,
                        "weights": name})
        if step["time_step"] == 2:
            out.append({**step, "name": f"eval_{name}", "kind": "eval",
                        "num_val": EVAL_VAL})
    return out


def jax_model(case: dict, dtype=None):
    """The JAX model; `dtype` its layers' compute dtype (flax's `dtype`,
    default float32; the parameters are float32 whatever it is). The
    gradient reference takes float64: a flax module left at float32
    casts its inputs and kernel to float32 inside `jax.enable_x64`, and
    st_baseline's VGG stream, whose gradients are ~1e-9, then reads
    2.4e-3 of its largest entry from the exact gradient."""
    from deepof_tpu.models.registry import build_model

    kw = {} if dtype is None else {"dtype": dtype}
    return build_model(case["model"],
                       flow_channels=2 * (case["time_step"] - 1),
                       **kw, **W.knobs(case["model"]))


def jax_input(case: dict):
    """The JAX model's init input: (1, H, W, 3 x frames), frame 1 alone
    for the classifier."""
    import jax.numpy as jnp

    channels = 3 if case["model"] == "ucf101_spatial" else \
        3 * case["time_step"]
    return jnp.zeros((1, *case["hw"], channels))


def run(work: str, names) -> dict:
    """Write every case's weights (each step case's the flax init of the
    JAX model, through `convert.py`) and batch, launch the two ranks;
    {"work", "params": the flax params by family, "ranks"}."""
    import jax

    from deepof_tpu_torch.convert import state_dict_from_flax

    params = {}
    for case in cases(names):
        write_case(work, case, seed=1)
        if (case["kind"] == "step" and "weights" not in case
                and "dtype" not in case):  # a bf16 case: the port's init
            p = jax.jit(jax_model(case).init)(jax.random.PRNGKey(0),
                                             jax_input(case))["params"]
            params[case["name"]] = jax.tree_util.tree_map(np.asarray, p)
            torch.save(state_dict_from_flax(params[case["name"]]),
                       os.path.join(work, f"{case['name']}.pt"))
    return {"work": work, "params": params,
            "ranks": W.launch(work, cases(names), 2, timeout_s=600)}


def set_compute_dtype(model, dtype) -> None:
    """Every layer's compute dtype (the `dtype` each conv, deconv and
    dense layer casts its input, weight and bias to); the parameters
    stay float32."""
    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


def one_process_step(work: str, case: dict, layers=None
                     ) -> tuple[dict, dict]:
    """The port's step of the case in one process, on one CPU thread as
    each rank steps: metrics, gradients. `layers`: every layer's compute
    dtype instead of the case's (float64: the exact reference; the plain
    correlation sums in float32 whatever its operands are)."""
    cfg = W.config({**case, "mesh": [1, 1, 1]})
    model = W.model_for(case)
    model.load_state_dict(torch.load(os.path.join(
        work, f"{case.get('weights', case['name'])}.pt")))
    if layers is not None:
        set_compute_dtype(model, layers)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    with np.load(os.path.join(work, f"{case['name']}.npz")) as z:
        batch = {k: z[k] for k in z.files}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = W.train_step(model, cfg, ONE, case.get("dropout", True))(state,
                                                                   batch)
    finally:
        torch.set_num_threads(threads)
    return m, {n: p.grad for n, p in model.named_parameters()}


def assert_matches_one_process(run_: dict, name: str) -> None:
    case = next(c for c in cases([name.removesuffix("_dropout")])
                if c["name"] == name)
    want_m, want_g = one_process_step(run_["work"], case)
    r0, r1 = (r[name] for r in run_["ranks"])
    np.testing.assert_allclose(float(r0["metrics"]["total"]),
                               float(want_m["total"]), rtol=LOSS_RTOL)
    for k in ("scale_total", "action_loss"):
        if k in want_m:
            np.testing.assert_allclose(r0["metrics"][k].numpy(),
                                       want_m[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
    assert set(r0["grads"]) == set(want_g)
    for n, g in want_g.items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(r0["grads"][n].numpy(), g.numpy(),
                                   rtol=0, atol=STEP_TOL * scale, err_msg=n)
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    for k, v in r0["metrics"].items():
        assert torch.equal(v, r1["metrics"][k]), k
    # sharded: halos crossed, and the flows or the head's input gathered
    assert r0["stats"]["halo_bytes"] > 0 and r0["stats"]["gather_calls"] > 0


def rel_errs(got: dict, want: dict) -> dict:
    """{name: max |got - want| / max |want|} over two gradient dicts."""
    return {n: float((got[n].double() - w.double()).abs().max()
                     / max(float(w.abs().max()), 1e-30))
            for n, w in want.items()}


def spread(got: dict, one: dict, exact: dict) -> dict:
    """The distances of two gradient dicts from the exact one on the
    worst and the median tensor: `got` (the sharded step's) and `one`
    (the one-process step's of the same dtype)."""
    d, o = rel_errs(got, exact), rel_errs(one, exact)
    return {"worst": max(d.values()), "one_worst": max(o.values()),
            "median": float(np.median(list(d.values()))),
            "one_median": float(np.median(list(o.values())))}


def assert_spread(got: dict, one: dict, exact: dict,
                  factor: float = BF16_SPREAD) -> dict:
    """A bf16 step's distance from the exact step within `factor` times
    the one-process bf16 step's, and at least 1/`factor` of it, on the
    worst and the median tensor: a step that computed in float32 lies
    far closer."""
    s = spread(got, one, exact)
    print("bf16 spread", json.dumps(s))  # shown under pytest -s
    assert s["worst"] <= factor * s["one_worst"], s
    assert s["median"] <= factor * s["one_median"], s
    assert factor * s["worst"] >= s["one_worst"], s
    assert factor * s["median"] >= s["one_median"], s
    return s


def assert_bf16_spread(run_: dict, name: str) -> None:
    """The "<name>_bf16" case against the port's one-process bf16 and
    float64 steps (BF16_SPREAD, BF16_LOSS_RTOL); both ranks the same
    bits; every message of its exchanges bf16 (the rows cross as they
    are computed, never upcast)."""
    case = next(c for c in cases([name]) if c["name"] == f"{name}_bf16")
    want_m, want_g = one_process_step(run_["work"], case)
    _, exact = one_process_step(
        run_["work"], {k: v for k, v in case.items() if k != "dtype"},
        torch.float64)
    r0, r1 = (r[case["name"]] for r in run_["ranks"])
    np.testing.assert_allclose(float(r0["metrics"]["total"]),
                               float(want_m["total"]), rtol=BF16_LOSS_RTOL)
    assert set(r0["grads"]) == set(want_g)
    assert all(g.dtype == torch.float32 for g in r0["grads"].values())
    assert_spread(r0["grads"], want_g, exact)
    for n, g in r0["grads"].items():
        assert torch.equal(g, r1["grads"][n]), n
    assert r0["stats"]["halo_bytes"] > 0 and r0["stats"]["gather_calls"] > 0
    assert r0["wire_dtypes"] == r1["wire_dtypes"] == ["torch.bfloat16"]


def assert_matches_jax(run_: dict, name: str) -> None:
    import jax
    import jax.numpy as jnp

    from deepof_tpu.core.config import LossConfig as JaxLossConfig
    from deepof_tpu.train.step import model_losses
    from deepof_tpu_torch.convert import state_dict_from_flax

    case = step_case(name)
    jm = jax_model(case, jnp.float64)
    keys = (("volume",) if case["time_step"] > 2
            else ("source", "target", "label"))
    with jax.enable_x64(True):
        with np.load(os.path.join(run_["work"], f"{name}.npz")) as z:
            batch = {k: (jnp.asarray(z[k]) if k == "label"
                         else jnp.asarray(z[k], jnp.float64)) for k in keys}
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64), run_["params"][name])

        def objective(p):
            return model_losses(jm, p, batch, (0.0, 0.0, 0.0),
                                JaxLossConfig(**W.LOSS),
                                compute_dtype=jnp.float64)

        (total, _), grads = jax.jit(jax.value_and_grad(
            objective, has_aux=True))(params)
        total = float(total)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    want = state_dict_from_flax(grads)
    r0 = run_["ranks"][0][name]
    np.testing.assert_allclose(float(r0["metrics"]["total"]), total,
                               rtol=JAX_TOL)
    assert set(r0["grads"]) == set(want)
    for n, w in want.items():
        scale = float(w.abs().max())
        np.testing.assert_allclose(r0["grads"][n].numpy(), w.numpy(),
                                   rtol=0, atol=JAX_TOL * scale, err_msg=n)


def assert_eval_matches(run_: dict, name: str, log_dir: str) -> None:
    case = next(c for c in cases([name.removeprefix("eval_")])
                if c["name"] == name)
    cfg = W.config({**case, "mesh": [1, 1, 1]}, log_dir)
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data,
                                                 num_val=EVAL_VAL),
                      device="cpu", world=ONE)
    trainer.model.load_state_dict(torch.load(os.path.join(
        run_["work"], f"{name}.pt")))
    want = trainer.evaluate()
    keys = (("accuracy", "val_loss") if "accuracy" in want
            else ("aee", "aae", "val_loss"))
    for r in run_["ranks"]:
        got = r[name]["eval"]
        assert set(got) == set(want)
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       err_msg=k)
        assert not any("spatial CP" in m for m in r[name]["warnings"])


def train_multihost(log_dir: str, args: list[str]) -> None:
    """`torchrun --nproc_per_node 2 -m deepof_tpu_torch train --multihost
    --synthetic --device cpu --set mesh.spatial=2 ARGS` for 2 steps at
    global batch 2, and its records."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc_per_node", "2", "--master_addr", "127.0.0.1",
         "--master_port", str(W.free_port()),
         "-m", "deepof_tpu_torch", "train", "--multihost", "--synthetic",
         "--device", "cpu", "--steps", "2", "--set", "mesh.spatial=2",
         *args, "--set", "data.batch_size=2",
         "--set", "train.eval_batch_size=2", "--set", "train.log_every=1",
         "--set", "train.eval_every=0",
         "--set", "train.ckpt_every_epochs=1000000", "--log-dir", log_dir],
        capture_output=True, text=True, env=env, cwd=repo, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    # the final checkpoint (FlowNet-CS's with its Adam state: 1.8 GB)
    shutil.rmtree(os.path.join(log_dir, "ckpt"), ignore_errors=True)
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert (records[0]["dist_backend"], records[0]["world_size"]) == (
        "gloo", 2)
    assert not any("spatial CP inactive" in r.get("message", "")
                   for r in records)
