"""Train state: the model, its Adam state, the gradient accumulator and
the counts of applied micro-steps and of emitted updates (port of
`deepof_tpu/train/state.py`).

The update is decided on the device, as the JAX step decides it
(`deepof_tpu/train/step.py`: `jnp.where(finite, new, old)` over the
state). `apply_gradients` computes every piece of the next state on
every micro-step and commits it on a device flag:
  - `finite` (the loss and the gradient norm are finite; None when
    `resilience.skip_nonfinite` is off) for the accumulator and the
    counters;
  - `finite & emit` for the parameters and Adam's moments;
so nothing is read back to the host and a skipped micro-step leaves
every tensor of the state as it was. A committed micro-step computes
optax's products and sums, the same bits as without the flags.

Adam is optax's `adam` (eps_root = 0), written out with foreach ops in
optax's order: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
u = (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps), p = p + u * -lr,
with n the device count of emitted updates. The learning rate is the
schedule's closed form evaluated on the device from that count
(`train/schedule.py`). Gradient clipping is
`optax.clip_by_global_norm`: where(|g| < max, g, g / |g| * max).

`optim.grad_accum = k > 1` has the semantics of `optax.MultiSteps`
around `chain(clip, adam)`:
  - the accumulator is optax's running mean of the micro-gradients,
    acc + (g - acc) / (mini_step + 1), in a buffer of its own: each
    micro-step's gradient comes fresh in `.grad`;
  - every k-th applied micro-step emits one update from the mean (the
    clip acts on the mean's global norm) and restarts the mean from
    zeros;
  - two counters: `step` counts applied micro-steps (the global step of
    the cadences and the checkpoint names, the JAX `TrainState.step`)
    and `updates` counts emitted updates (Adam's count, MultiSteps'
    `gradient_step`). Emitted update j takes the learning rate
    `schedule(j * k)`, so the decay boundaries stay at the same number
    of data batches as without accumulation.
At k = 1 every applied step emits its own gradient and `updates` equals
`step`. The three counters live in one device tensor; the `step`,
`updates` and `mini_step` properties read it (a host sync), so the loop
reads them only where the JAX loop syncs: eval, checkpoints, rollbacks
and the end of a fit.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..core.config import OptimConfig


class Adam(torch.optim.Optimizer):
    """The container of Adam's state: one `exp_avg` (optax's mu) and one
    `exp_avg_sq` (nu) per parameter, zeros from construction as optax's
    `init` makes them, with torch's `state_dict` and `load_state_dict`.
    The arithmetic is `TrainState.apply_gradients`'s; `step()` is not
    used."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, {"betas": tuple(betas), "eps": eps})
        self._zero_missing()

    def _zero_missing(self) -> None:
        for group in self.param_groups:
            for p in group["params"]:
                st = self.state[p]
                for key in ("exp_avg", "exp_avg_sq"):
                    if key not in st:
                        st[key] = torch.zeros_like(p)

    def load_state_dict(self, state_dict) -> None:
        """torch's load; a parameter without moments in `state_dict` (a
        checkpoint of `torch.optim.Adam` before its first update) gets
        optax's zeros."""
        super().load_state_dict(state_dict)
        self._zero_missing()

    def step(self, closure=None):
        raise TypeError("Adam's update is TrainState.apply_gradients")


def make_optimizer(cfg: OptimConfig, params) -> Adam:
    return Adam(params, betas=(cfg.beta1, cfg.beta2), eps=cfg.adam_eps)


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))


#: positions of the counters in `TrainState.counts`
STEP, UPDATES, MINI_STEP = 0, 1, 2


class TrainState:
    """Updated in place by `apply_gradients` (PyTorch's idiom; the JAX
    state is an immutable pytree). `acc` is the accumulator, one float32
    tensor per parameter, present only when grad_accum > 1. `counts`
    holds (step, updates, mini_step) as one int64 tensor on the model's
    device."""

    def __init__(self, model: nn.Module, optimizer: Adam,
                 schedule: Callable, grad_clip_norm: float | None = None,
                 grad_accum: int = 1, acc: list[torch.Tensor] | None = None):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.grad_clip_norm = grad_clip_norm
        self.grad_accum = grad_accum
        self.acc = acc
        self.counts = torch.zeros(3, dtype=torch.int64,
                                  device=next(model.parameters()).device)

    def _get(self, i: int) -> int:
        return int(self.counts[i])

    def _set(self, i: int, value: int) -> None:
        self.counts[i] = int(value)

    step = property(lambda self: self._get(STEP),
                    lambda self, v: self._set(STEP, v))
    updates = property(lambda self: self._get(UPDATES),
                       lambda self, v: self._set(UPDATES, v))
    mini_step = property(lambda self: self._get(MINI_STEP),
                         lambda self, v: self._set(MINI_STEP, v))

    def learning_rate(self) -> torch.Tensor:
        """The learning rate of the next emitted update, float64 on the
        device: schedule(updates * grad_accum)."""
        lr = self.schedule(self.counts[UPDATES].double() * self.grad_accum)
        return torch.as_tensor(lr, dtype=torch.float64,
                               device=self.counts.device)

    @torch.no_grad()
    def apply_gradients(self, grad_norm, finite: torch.Tensor | None = None
                        ) -> None:
        """One micro-step from the gradients in `.grad`, whose global norm
        is `grad_norm` (a number or a device scalar): fold them into the
        accumulator and, on every grad_accum-th applied micro-step (every
        one at 1), emit an Adam update; each piece is committed only
        where `finite` (a device bool; None commits unconditionally).

        The commit is arithmetic, so the whole update is a few foreach
        launches: a skipped micro-step's gradient is zeroed first (its
        NaN would survive a multiply by 0), then every update is scaled
        by its flag (the accumulator's increment by `finite`, the moments'
        new terms and the parameters' step by `finite & emit`, the
        moments' decay replaced by 1), so a skipped or non-emitting
        micro-step adds zeros; a committed one computes optax's products
        and sums, the same bits as without flags."""
        params = list(self.model.parameters())
        dev = params[0].device
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if finite is not None:
            grads = [torch.where(finite, g, 0.0) for g in grads]
        norm = torch.as_tensor(grad_norm, dtype=torch.float32, device=dev)
        count = self.counts
        k = self.grad_accum
        keep = finite  # where the moments and the parameters move
        emit = None  # every applied micro-step emits at k = 1
        if k > 1:
            mini = count[MINI_STEP]
            # optax's running mean: acc + (g - acc) / (mini_step + 1)
            inc = torch._foreach_div(torch._foreach_sub(grads, self.acc),
                                     (mini + 1).to(torch.float32))
            if finite is not None:
                torch._foreach_mul_(inc, finite.to(torch.float32))
            torch._foreach_add_(self.acc, inc)
            emit = mini + 1 == k
            keep = emit if finite is None else finite & emit
            grads, norm = self.acc, global_norm(self.acc)
        if self.grad_clip_norm:
            clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                         float(self.grad_clip_norm))
            small = norm < self.grad_clip_norm
            grads = [torch.where(small, g, c) for g, c in zip(grads, clipped)]
        group = self.optimizer.param_groups[0]
        b1, b2 = group["betas"]

        def gated(on: float, off: float):
            return on if keep is None else torch.where(keep, on, off)

        state = [self.optimizer.state[p] for p in params]
        mu = [s["exp_avg"] for s in state]
        nu = [s["exp_avg_sq"] for s in state]
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g^2 + b2 nu
        torch._foreach_mul_(mu, gated(b1, 1.0))
        torch._foreach_add_(mu, torch._foreach_mul(grads, gated(1 - b1,
                                                                0.0)))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, gated(1 - b2, 0.0))
        torch._foreach_mul_(nu, gated(b2, 1.0))
        torch._foreach_add_(nu, sq)
        # p += (mu / (1 - b1^n)) / (sqrt(nu / (1 - b2^n)) + eps) * -lr
        n = (count[UPDATES] + 1).to(torch.float32)
        den = torch._foreach_div(nu, 1 - torch.pow(b2, n))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, group["eps"])
        step = torch._foreach_div(mu, 1 - torch.pow(b1, n))
        torch._foreach_div_(step, den)
        lr = -self.learning_rate().float()
        torch._foreach_mul_(step, lr if keep is None
                            else torch.where(keep, lr, 0.0))
        torch._foreach_add_(params, step)
        if emit is not None:
            # MultiSteps restarts the mean from zeros after an emit
            torch._foreach_mul_(self.acc, 1 - keep.to(torch.float32))
        applied = (torch.ones((), dtype=torch.int64, device=dev)
                   if finite is None else finite.long())
        emitted = applied if emit is None else applied * emit.long()
        new_mini = (torch.zeros_like(count[MINI_STEP]) if emit is None
                    else torch.where(emit, 0, count[MINI_STEP] + 1))
        if finite is not None:
            new_mini = torch.where(finite, new_mini, count[MINI_STEP])
        count.copy_(torch.stack([count[STEP] + applied,
                                 count[UPDATES] + emitted, new_mini]))


def create_train_state(model: nn.Module, cfg: OptimConfig,
                       schedule: Callable) -> TrainState:
    accum = max(cfg.grad_accum, 1)
    acc = ([torch.zeros_like(p) for p in model.parameters()]
           if accum > 1 else None)
    return TrainState(model=model,
                      optimizer=make_optimizer(cfg, model.parameters()),
                      schedule=schedule, grad_clip_norm=cfg.grad_clip_norm,
                      grad_accum=accum, acc=acc)
