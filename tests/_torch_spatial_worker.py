"""One rank of the spatial and temporal context-parallel tests
(`tests/test_torch_spatial*.py`; the port only: torch, no JAX).

    python tests/_torch_spatial_worker.py WORKDIR PORT RANK WORLD [DEVICE]

Joins a gloo world (`parallel/mesh.py::init_distributed`) on DEVICE
(default cpu; on the card the ranks share it over gloo, the exchange
staged through host memory), cuDNN deterministic and TF32 off, and runs the cases of WORKDIR/cases.json in turn, writing what this rank
saw to WORKDIR/rank<r>.pt, a dict by case name. A case is
{"name", "kind", ...}:
  halo    `halo_exchange(x, halo, axis=1)` of this rank's block of the
          array WORKDIR/<name>.npz["x"] over a spatial axis of all
          ranks, and the gradient of sum(out * w) for w the rank's block
          of "w": {"out", "grad"};
  step    one train step of cfg (`config(case)`) over mesh (data,
          spatial, time) = case["mesh"] from WORKDIR/<weights>.pt's
          weights (case["weights"], default its name) on this rank's
          rows of the global batch WORKDIR/<name>.npz, an action model's
          dropout off where case["dropout"] is false, in
          case.get("dtype", "float32") compute:
          {"metrics", "grads", "stats", "wire_dtypes"} (the dtypes of
          every message its exchanges sent or received);
  eval    `Trainer.evaluate()` under case["mesh"] from those weights:
          the AEE protocol's numbers, and the Trainer's warn records;
  gate    a Trainer built under case["mesh"] (no step): its warn
          records (rank 0's metrics.jsonl);
  pool    a row-sharded layer (`layer_fn`: case["op"] = "max3" or
          "max2", the SAME max-pools; "avg3", the counted 3x3 average;
          "deconv1", the decoder's scale-1 deconv) on this rank's row
          block of WORKDIR/<name>.npz["x"] (B, C, n, W), over a spatial
          axis of all ranks, and the gradient of sum(out * w) for w
          this rank's block of "w" (the whole output's shape):
          {"out", "grad"}.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepof_tpu_torch.core.config import (  # noqa: E402
    DataConfig, ExperimentConfig, LossConfig, MeshConfig, TrainConfig)
from deepof_tpu_torch.data.datasets import SyntheticData  # noqa: E402
from deepof_tpu_torch.models.registry import build_model  # noqa: E402
from deepof_tpu_torch.parallel import spatial  # noqa: E402
from deepof_tpu_torch.parallel.mesh import (  # noqa: E402
    build_mesh, init_distributed, local_batch_rows, shutdown_distributed)
from deepof_tpu_torch.train.loop import Trainer  # noqa: E402
from deepof_tpu_torch.train.schedule import step_decay_schedule  # noqa: E402
from deepof_tpu_torch.train.state import create_train_state  # noqa: E402
from deepof_tpu_torch.train.step import make_train_step  # noqa: E402

# alpha 0.5: a loss whose gradient does not amplify rounding (F6)
LOSS = {"alpha_c": 0.5, "alpha_s": 0.5}
#: FlowNet-C's thin geometry (tests/test_torch_ddp.py's)
CORR = {"corr_max_disp": 2, "corr_stride": 1}
#: the dtypes of the messages the exchanges sent and received since the
#: last clear (`record_wire`, installed by `main`)
WIRE: set = set()


def record_wire() -> None:
    """Wrap `torch.distributed.batch_isend_irecv`, which every exchange
    and gather of `parallel/spatial.py` hands its point-to-point ops
    to, to add each op's tensor's dtype to WIRE: what crosses the wire,
    after any cast on the way."""
    import torch.distributed as dist

    batch = dist.batch_isend_irecv

    def recorded(ops):
        WIRE.update(str(op.tensor.dtype) for op in ops)
        return batch(ops)

    dist.batch_isend_irecv = recorded
#: the models with a width knob (the others are always full width)
THIN = ("flownet_s", "flownet_c", "inception_v3")


def knobs(model: str) -> dict:
    """The model's size knobs: width 0.25 where it has one, FlowNet-C's
    thin correlation (FlowNet-CS's base stage too)."""
    return {**({"width_mult": 0.25} if model in THIN else {}),
            **(CORR if model in ("flownet_c", "flownet_cs") else {})}


def config(case: dict, log_dir: str = "") -> ExperimentConfig:
    """The case's config: case["model"] thin (`knobs`) at case["hw"],
    global batch case["batch"], T = case.get("time_step", 2) frames,
    the mesh of case["mesh"], computing in case.get("dtype", "float32")
    (`train.compute_dtype`)."""
    hw = tuple(case["hw"])
    d, s, t = case.get("mesh", (1, 1, 1))
    return ExperimentConfig(
        model=case["model"], **knobs(case["model"]),
        loss=LossConfig(**LOSS),
        mesh=MeshConfig(data=d, spatial=s, time=t),
        data=DataConfig(dataset="synthetic", image_size=hw, gt_size=hw,
                        batch_size=case["batch"],
                        time_step=case.get("time_step", 2)),
        train=TrainConfig(log_dir=log_dir, log_every=1, eval_every=0,
                          eval_batch_size=case["batch"],
                          eval_amplifier=1.0, ckpt_every_epochs=1000,
                          seed=3, compute_dtype=case.get("dtype",
                                                         "float32")))


def model_for(case: dict, device="cpu"):
    cfg = config(case)
    return build_model(case["model"],
                       flow_channels=2 * (cfg.data.time_step - 1),
                       device=device, image_size=tuple(case["hw"]),
                       dtype=getattr(torch, cfg.train.compute_dtype),
                       **knobs(case["model"]))


def layer_fn(op: str, n: int, channels: int, device="cpu"):
    """(layer, output rows) of a pool case: fn(x, rows) -> this rank's
    block of the output level (rows None: the whole-height op). The
    scale-1 deconv's weights are fixed from seed 0; its whole-height
    op is the decoder's crop of the first n rows and W columns."""
    from deepof_tpu_torch.models.common import Deconv, avg_pool, max_pool

    if op == "deconv1":
        torch.manual_seed(0)
        d = Deconv(channels, channels, scale=1)
        torch.nn.init.normal_(d.deconv.weight)
        torch.nn.init.normal_(d.deconv.bias)
        d.to(device)
        # one row and one column past flax's SAME: `FlowDecoder` crops
        # them; row-sharded, the last block stops at row n itself
        return (lambda x, rows: (d(x)[..., :n, :] if rows is None else d(
            x, rows, rows.down(1)))[..., :x.shape[-1]]), n
    if op == "avg3":
        return avg_pool, n
    k = int(op[-1])
    return (lambda x, rows: max_pool(x, k, 2, rows)), -(-n // 2)


def run_pool(work: str, case: dict, world) -> dict:
    sg = spatial.spatial_group(world)
    with np.load(os.path.join(work, f"{case['name']}.npz")) as z:
        x, w = z["x"], z["w"]
    n = x.shape[-2]
    fn, n_out = layer_fn(case["op"], n, x.shape[1], world.device)
    lo, hi = sg.block(n)
    xb = torch.tensor(x[..., lo:hi, :], device=world.device,
                      requires_grad=True)
    out = fn(xb, spatial.Rows(sg, n))
    a, b = sg.block(n_out)
    (out * torch.tensor(w[..., a:b, :], device=world.device)).sum().backward()
    return {"out": out.detach().cpu(), "grad": xb.grad.cpu()}


def run_halo(work: str, case: dict, world) -> dict:
    sg = spatial.spatial_group(world)
    with np.load(os.path.join(work, f"{case['name']}.npz")) as z:
        x, w = z["x"], z["w"]
    c = x.shape[1] // sg.size
    xb = torch.tensor(x[:, sg.index * c:(sg.index + 1) * c],
                      device=world.device, requires_grad=True)
    out = spatial.halo_exchange(xb, case["halo"], sg, axis=1)
    n = out.shape[1]
    wb = torch.tensor(w[:, sg.index * n:(sg.index + 1) * n],
                      device=world.device)
    (out * wb).sum().backward()
    return {"out": out.detach().cpu(), "grad": xb.grad.cpu(),
            "staged": sg.staged(world.device)}


def train_step(model, cfg, world, dropout: bool = True):
    """`make_train_step` of the case; `dropout=False`: an action model's
    step without its dropout (the JAX `model_losses` at train=False)."""
    from deepof_tpu_torch.train import step as step_mod

    drops = step_mod.has_dropout
    if not dropout:
        step_mod.has_dropout = lambda m: False
    try:
        return make_train_step(model, cfg, (0.0, 0.0, 0.0), world=world)
    finally:
        step_mod.has_dropout = drops


def run_step(work: str, case: dict, world) -> dict:
    cfg = config(case)
    model = model_for(case, world.device)
    model.load_state_dict(torch.load(os.path.join(
        work, f"{case.get('weights', case['name'])}.pt")))
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    step = train_step(model, cfg, world, case.get("dropout", True))
    rows = local_batch_rows(world, case["batch"])[1]
    with np.load(os.path.join(work, f"{case['name']}.npz")) as z:
        batch = {k: z[k][rows] for k in z.files}
    spatial.reset_stats()
    WIRE.clear()
    m = step(state, batch)
    return {"metrics": {k: v.detach().cpu() for k, v in m.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
            "stats": dict(spatial.STATS), "wire_dtypes": sorted(WIRE)}


def _warnings(log_dir: str) -> list[str]:
    path = os.path.join(log_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [r["message"] for r in map(json.loads, f)
                if r.get("kind") == "warn"]


def trainer(work: str, case: dict, world) -> Trainer:
    log_dir = os.path.join(work, case["name"])
    cfg = config(case, log_dir)
    t = Trainer(cfg, dataset=SyntheticData(
        cfg.data, num_val=case.get("num_val", 16)), device="cpu",
        world=world)
    weights = os.path.join(work, f"{case['name']}.pt")
    if os.path.exists(weights):
        t.model.load_state_dict(torch.load(weights))
    return t


def main(work: str, port: str, rank: str, size: str,
         device: str = "cpu") -> None:
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    record_wire()
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    init_distributed(device, env={
        "RANK": rank, "WORLD_SIZE": size, "LOCAL_RANK": rank,
        "LOCAL_WORLD_SIZE": size, "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": port}, timeout_s=120)
    out = {}
    for case in cases:
        d, s, t = case.get("mesh", (1, int(size), 1))
        world = build_mesh(MeshConfig(data=d, spatial=s, time=t))
        if case["kind"] == "halo":
            out[case["name"]] = run_halo(work, case, world)
        elif case["kind"] == "pool":
            out[case["name"]] = run_pool(work, case, world)
        elif case["kind"] == "step":
            out[case["name"]] = run_step(work, case, world)
        elif case["kind"] == "eval":
            tr = trainer(work, case, world)
            out[case["name"]] = {"eval": tr.evaluate(),
                                 "warnings": _warnings(tr.cfg.train.log_dir)}
        elif case["kind"] == "gate":
            tr = trainer(work, case, world)
            out[case["name"]] = {"warnings":
                                 _warnings(tr.cfg.train.log_dir)}
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    shutdown_distributed()
    print(json.dumps({"rank": int(rank), "ok": True}), flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(work: str, cases: list, nproc: int, timeout_s: float = 300,
           device: str = "cpu") -> list[dict]:
    """Write `cases` to work/cases.json, run `nproc` ranks of this
    worker as subprocesses (one thread each) on `device` and return each
    rank's outputs, in rank order; fails naming a rank's stderr."""
    import subprocess

    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(cases, f)
    port = str(free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), work, port, str(r),
         str(nproc), device], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=root) for r in range(nproc)]
    try:
        outs = [p.communicate(timeout=timeout_s) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    out = []
    for r in range(nproc):
        path = os.path.join(work, f"rank{r}.pt")
        out.append(torch.load(path))
        os.remove(path)  # read once; the gradients of every case
    return out


if __name__ == "__main__":
    main(*sys.argv[1:6])
