"""Train state: the model, its optimizer, the gradient accumulator and
the counts of applied micro-steps and of emitted updates (port of
`deepof_tpu/train/state.py`).

Adam matches optax's `adam`: torch's update is lr * m_hat / (sqrt(v_hat)
+ eps), as optax's with eps_root = 0. Gradient clipping matches
`optax.clip_by_global_norm`: g / |g| * max unless |g| < max
(`clip_grad_norm_` divides by |g| + 1e-6 and is not used).

`optim.grad_accum = k > 1` has the semantics of `optax.MultiSteps`
around `chain(clip, adam)`:
  - the accumulator is optax's running mean of the micro-gradients,
    acc + (g - acc) / (mini_step + 1), in a buffer of its own: each
    micro-step's gradient comes fresh in `.grad` and folds in only when
    the step applies it (a finite one; torch's idiom of calling
    `backward()` without `zero_grad` would sum, and fold a non-finite
    micro-gradient in before the host sees it);
  - every k-th applied micro-step emits one update from the mean: the
    clip acts on the mean's global norm, and Adam steps;
  - two counters: `step` counts applied micro-steps (the global step
    of the cadences and the checkpoint names, the JAX `TrainState.step`)
    and `updates` counts emitted updates (Adam's count, MultiSteps'
    `gradient_step`). Emitted update j takes the learning rate
    `schedule(j * k)`, so the decay boundaries stay at the same number
    of data batches as without accumulation;
  - a skipped micro-step (`train/step.py`) calls nothing here, so the
    accumulator, `mini_step`, Adam's moments and count and `step` all
    stay as they were, as the JAX step keeps its whole state.
At k = 1 every applied step emits its own gradient and `updates` equals
`step`.
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
    return torch.optim.Adam(params, lr=cfg.learning_rate,
                            betas=(cfg.beta1, cfg.beta2), eps=cfg.adam_eps)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


@dataclass
class TrainState:
    """Updated in place by `apply_gradients` (PyTorch's idiom; the JAX
    state is an immutable pytree). `acc` is the accumulator, one float32
    tensor per parameter, present only when grad_accum > 1."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip_norm: float | None = None
    grad_accum: int = 1
    step: int = 0
    updates: int = 0
    mini_step: int = 0
    acc: list[torch.Tensor] | None = None

    def apply_gradients(self, grad_norm: float) -> None:
        """Apply one micro-step from the gradients in `.grad`, whose
        global norm is `grad_norm`: fold them into the accumulator and,
        on every grad_accum-th applied micro-step (every one at 1), emit
        an Adam update."""
        params = list(self.model.parameters())
        self.step += 1
        if self.grad_accum > 1:
            n = self.mini_step + 1
            for a, p in zip(self.acc, params):
                g = p.grad if p.grad is not None else torch.zeros_like(a)
                a.add_((g - a) / n)
            if n < self.grad_accum:
                self.mini_step = n
                return
            # emit the mean; MultiSteps restarts the mean from zeros
            for a, p in zip(self.acc, params):
                p.grad = a.clone()
                a.zero_()
            self.mini_step = 0
            grad_norm = global_norm([p.grad for p in params]).item()
        if self.grad_clip_norm and not grad_norm < self.grad_clip_norm:
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_norm).mul_(self.grad_clip_norm)
        lr = self.schedule(self.updates * self.grad_accum)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.updates += 1


def create_train_state(model: nn.Module, cfg: OptimConfig,
                       schedule: Callable[[int], float]) -> TrainState:
    accum = max(cfg.grad_accum, 1)
    acc = ([torch.zeros_like(p) for p in model.parameters()]
           if accum > 1 else None)
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=schedule, grad_clip_norm=cfg.grad_clip_norm,
                      grad_accum=accum, acc=acc)
