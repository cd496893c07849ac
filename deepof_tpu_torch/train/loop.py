"""Trainer (port of the single-process core of
`deepof_tpu/train/loop.py::Trainer`): builds the model, the dataset, the
learning-rate schedule and the optimizer state, and `fit(steps)` runs
that many train steps.

Batch i of a fit that starts at step s is
`dataset.sample_train(batch_size, rng=derive_batch_rng([seed, s], i))`,
the JAX loop's stream on one process, so both packages see the same
batches. Still to port (ROADMAP Queue A items 5-6): checkpoints, eval,
the metrics log, the prefetcher, the input pipeline's workers and the
CLI.

The Trainer leaves the global TF32 switches of PyTorch as it finds them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.config import ExperimentConfig, check_trainable
from ..core.device import resolve_device
from ..data.datasets import build_dataset
from ..data.pipeline import derive_batch_rng
from ..models.registry import build_model
from .schedule import step_decay_schedule
from .state import create_train_state
from .step import make_train_step


class Trainer:
    def __init__(self, cfg: ExperimentConfig, dataset=None,
                 device: str | torch.device = "cuda"):
        check_trainable(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = (dataset if dataset is not None
                        else build_dataset(cfg.data))
        self.model = build_model(
            cfg.model, flow_channels=2 * (cfg.data.time_step - 1),
            width_mult=cfg.width_mult, seed=cfg.train.seed,
            device=self.device)
        self.steps_per_epoch = max(
            self.dataset.num_train // cfg.data.batch_size, 1)
        self.schedule = step_decay_schedule(cfg.optim, self.steps_per_epoch)
        self.state = create_train_state(self.model, cfg.optim, self.schedule)
        self.train_step = make_train_step(self.model, cfg, self.dataset.mean)

    def batches(self, steps: int):
        """The host batches of the next `steps` steps of a fit from the
        current step, with the seconds each took to draw."""
        seed = np.array([self.cfg.train.seed, self.state.step], np.uint32)
        for i in range(steps):
            t0 = time.perf_counter()
            batch = self.dataset.sample_train(
                self.cfg.data.batch_size, rng=derive_batch_rng(seed, i))
            yield batch, time.perf_counter() - t0

    def fit(self, steps: int) -> list[dict]:
        """Run `steps` train steps; returns each step's metrics, with the
        host time to draw its batch (`data_ms`) and the time of the step
        itself, copy to the device and metric read-back included
        (`step_ms`), both on the host clock."""
        self.model.train()
        out = []
        for batch, data_s in self.batches(steps):
            t0 = time.perf_counter()
            metrics = self.train_step(self.state, batch)
            metrics["step_ms"] = 1e3 * (time.perf_counter() - t0)
            metrics["data_ms"] = 1e3 * data_s
            out.append(metrics)
        return out
