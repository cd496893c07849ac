"""Learning-rate schedule (port of `deepof_tpu/train/schedule.py`)."""

from __future__ import annotations

from ..core.config import OptimConfig


def step_decay_schedule(cfg: OptimConfig, steps_per_epoch: int):
    """lr(step) = learning_rate * decay_factor ** (epoch // epochs_per_decay),
    epoch = step // steps_per_epoch. A closed form: `step` may be an int
    or a float64 tensor (the train state's device count, so the rate of
    an update is computed on the device without a host read)."""
    spe = max(steps_per_epoch, 1)

    def schedule(step):
        epoch = step // spe
        return cfg.learning_rate * (cfg.decay_factor
                                    ** (epoch // cfg.epochs_per_decay))

    return schedule
