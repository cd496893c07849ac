"""Train state: the model, its optimizer and the count of applied updates
(port of `deepof_tpu/train/state.py`).

Adam matches optax's `adam`: torch's update is lr * m_hat / (sqrt(v_hat)
+ eps), as optax's with eps_root = 0. The learning rate of update k is
`schedule(k)`, where k counts *applied* updates, as optax's count does: a
skipped update neither advances it nor touches the moments. Gradient
clipping matches `optax.clip_by_global_norm`: g * max / |g| only when
|g| > max (`clip_grad_norm_` divides by |g| + 1e-6 and is not used).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from ..core.config import OptimConfig


def make_optimizer(cfg: OptimConfig, params) -> torch.optim.Adam:
    """Adam with the configured betas and eps; the learning rate is set
    from the schedule before every update (`TrainState.apply_gradients`)."""
    if cfg.grad_accum > 1:
        raise NotImplementedError(
            f"optim.grad_accum={cfg.grad_accum} is not ported to "
            "deepof_tpu_torch yet: ROADMAP Queue A item 6 (training loop)")
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=cfg.adam_eps)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


@dataclass
class TrainState:
    """Updated in place by `apply_gradients` (PyTorch's idiom; the JAX
    state is an immutable pytree)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_norm: float | None = None
    step: int = 0

    def apply_gradients(self, grad_norm: float) -> None:
        """One Adam update from the gradients in `.grad`, whose global
        norm is `grad_norm`."""
        if self.grad_clip_norm and grad_norm > self.grad_clip_norm:
            scale = self.grad_clip_norm / grad_norm
            for p in self.model.parameters():
                if p.grad is not None:
                    p.grad.mul_(scale)
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, cfg: OptimConfig,
                       schedule: Callable[[int], float]) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=schedule, grad_clip_norm=cfg.grad_clip_norm)
