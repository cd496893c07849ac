"""One rank of `tests/test_torch_ddp.py`'s two-rank gloo world (the port
only: torch, no JAX).

    python tests/_torch_ddp_worker.py WORKDIR PORT RANK WORLD \
        [DEVICE [PHASES]]

Joins the world (`parallel/mesh.py::init_distributed` on DEVICE, default
cpu: gloo; on the card, gloo for ranks that share it and NCCL for one),
then runs the PHASES (default grad,eval,fit,nan) in turn, each rank
writing what it saw to WORKDIR/rank<r>.pt:
  grad  one train step of thin FlowNet-C on this rank's rows of the
        global batch in WORKDIR/batch.npz, from the weights in
        WORKDIR/weights.pt: the averaged gradients and metrics;
  eval  `Trainer.evaluate()` of a fresh trainer (weights from the seed):
        the gathered AEE protocol;
  fit   a 3-step `Trainer.fit` on `FixedStream`'s rows: every step's
        record (rank 0's metrics.jsonl) and the final parameters;
  nan   the same fit with the dispatch fault armed on rank 0 only, at
        loop step 1: both ranks must skip the same step.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from deepof_tpu_torch.core.config import (  # noqa: E402
    DataConfig, ExperimentConfig, LossConfig, ResilienceConfig, TrainConfig)
from deepof_tpu_torch.data.datasets import SyntheticData  # noqa: E402
from deepof_tpu_torch.data.pipeline import derive_batch_rng  # noqa: E402
from deepof_tpu_torch.models.registry import build_model  # noqa: E402
from deepof_tpu_torch.parallel.mesh import (init_distributed,  # noqa: E402
                                            local_batch_rows,
                                            shutdown_distributed)
from deepof_tpu_torch.resilience.faults import FaultConfig  # noqa: E402
from deepof_tpu_torch.train.loop import Trainer  # noqa: E402
from deepof_tpu_torch.train.schedule import step_decay_schedule  # noqa: E402
from deepof_tpu_torch.train.state import create_train_state  # noqa: E402
from deepof_tpu_torch.train.step import make_train_step  # noqa: E402

HW = (16, 32)
BATCH = 4  # global
GEOMETRY = {"corr_max_disp": 2, "corr_stride": 1}
# alpha 0.5: a loss whose gradient does not amplify rounding
# (tests/test_torch_train.py's L1_LIKE)
LOSS = {"alpha_c": 0.5, "alpha_s": 0.5}


def config(log_dir: str, faults: FaultConfig | None = None
           ) -> ExperimentConfig:
    return ExperimentConfig(
        model="flownet_c", width_mult=0.25, **GEOMETRY,
        loss=LossConfig(**LOSS),
        data=DataConfig(dataset="synthetic", image_size=HW, gt_size=HW,
                        batch_size=BATCH),
        train=TrainConfig(log_dir=log_dir, log_every=1, eval_every=0,
                          eval_batch_size=BATCH, eval_amplifier=1.0,
                          ckpt_every_epochs=1000, seed=3),
        resilience=ResilienceConfig(faults=faults or FaultConfig()))


class FixedStream(SyntheticData):
    """Call i of `sample_train` gives this rank's `rows` of global batch
    i, drawn from a fixed stream whatever the rng: a 2-rank fit and a
    1-process fit then see the same global batches (one process reads
    them in call order: data.num_workers 0)."""

    def __init__(self, rows):
        super().__init__(DataConfig(dataset="synthetic", image_size=HW,
                                    gt_size=HW))
        self.rows = list(rows)
        self.calls = 0

    def sample_train(self, batch_size, rng=None):
        assert batch_size == len(self.rows)
        b = super().sample_train(BATCH, rng=derive_batch_rng(
            np.array([11, 0], np.uint32), self.calls))
        self.calls += 1
        return {k: v[self.rows] for k, v in b.items()}


def fit(world, log_dir: str, faults: FaultConfig | None = None) -> dict:
    rows = local_batch_rows(world, BATCH)[1]
    trainer = Trainer(config(log_dir, faults), dataset=FixedStream(rows),
                      device="cpu", world=world)
    init = {n: p.detach().clone()
            for n, p in trainer.model.named_parameters()}
    summary = trainer.fit(max_steps=3)
    return {"summary": summary, "step": trainer.state.step, "init": init,
            "params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()}}


def main(workdir: str, port: str, rank: str, size: str,
         device: str = "cpu", phases: str = "grad,eval,fit,nan") -> None:
    torch.set_num_threads(1)
    # float32 in float32, and cuDNN's deterministic algorithms: the card
    # tests hold a world of one to a plain step bit for bit
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    phases = phases.split(",")
    world = init_distributed(device, env={
        "RANK": rank, "WORLD_SIZE": size, "LOCAL_RANK": rank,
        "LOCAL_WORLD_SIZE": size, "MASTER_ADDR": "127.0.0.1",
        "MASTER_PORT": port}, timeout_s=120)
    out = {"backend": world.backend, "size": world.size,
           "device": str(world.device)}
    if "grad" in phases:
        out["grad"] = grad(workdir, world)
    rows = local_batch_rows(world, BATCH)[1]
    if "eval" in phases:
        # the gathered AEE protocol on the seed's weights
        trainer = Trainer(config(os.path.join(workdir, "eval")),
                          dataset=FixedStream(rows), device="cpu",
                          world=world)
        out["eval"] = trainer.evaluate()
    if "fit" in phases:
        out["fit"] = fit(world, os.path.join(workdir, "fit"))
    if "nan" in phases:
        out["nan"] = fit(world, os.path.join(workdir, "nan"),
                         FaultConfig(enabled=True, dispatch_at=(1,))
                         if world.rank == 0 else None)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    shutdown_distributed()
    print(json.dumps({"rank": int(rank), "ok": True}), flush=True)


def grad(workdir: str, world) -> dict:
    """One step on this rank's rows of the fixed global batch, on the
    world's device: the averaged gradients and metrics, on the CPU."""
    cfg = config(os.path.join(workdir, "grad"))
    model = build_model("flownet_c", width_mult=0.25, device=world.device,
                        **GEOMETRY)
    model.load_state_dict(torch.load(os.path.join(workdir, "weights.pt")))
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    step = make_train_step(model, cfg, (0.0, 0.0, 0.0), world=world)
    rows = local_batch_rows(world, BATCH)[1]
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        batch = {k: z[k][rows] for k in ("source", "target")}
    m = step(state, batch)
    return {"metrics": {k: v.cpu() for k, v in m.items()},
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()
                      if p.grad is not None}}


if __name__ == "__main__":
    main(*sys.argv[1:7])
