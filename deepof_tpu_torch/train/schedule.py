"""Learning-rate schedule (port of `deepof_tpu/train/schedule.py`)."""

from __future__ import annotations

from ..core.config import OptimConfig


def step_decay_schedule(cfg: OptimConfig, steps_per_epoch: int):
    """lr(step) = learning_rate * decay_factor ** (epoch // epochs_per_decay),
    epoch = step // steps_per_epoch."""
    spe = max(steps_per_epoch, 1)

    def schedule(step: int) -> float:
        epoch = step // spe
        return cfg.learning_rate * (cfg.decay_factor
                                    ** (epoch // cfg.epochs_per_decay))

    return schedule
