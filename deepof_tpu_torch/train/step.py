"""Objective and train step (port of the flow branches of
`deepof_tpu/train/step.py`: two-frame pairs and T-frame volumes).

`model_losses` preprocesses the pair (or the volume), runs the model and
the pyramid loss (`pyramid_loss`, or `pyramid_loss_multi` for a batch
with a "volume"). `make_train_step` builds `step(state, batch) ->
metrics`: forward, backward, global gradient norm, and the micro-step
(`TrainState.apply_gradients`: the accumulator under `optim.grad_accum`,
the Adam update), which is skipped on the device when the loss or the
gradient norm is not finite (`skip_nonfinite`), as the JAX step's
`jnp.where` skips it: the metrics stay on the device. Under
`train.steps_per_call = K > 1` the step takes K stacked batches
([K, B, ...] entries) and runs K steps in sequence, each with its own
skip, returning metrics with a leading K axis as the JAX step's
`lax.scan` does; it is a loop over the same
operations, so it gives the bits of K single calls. Under `train.remat`
the model forward runs under `torch.utils.checkpoint` (non-reentrant),
where the JAX step puts `jax.checkpoint`: the loss and its warps stay
outside, and the forward runs again in backward (the correlation kernel
twice a step).
Under `loss.occlusion` the model runs a second time, on the swapped
network pair, for the backward flows of the occlusion masks; that
forward runs under `torch.no_grad()`, since the masks end in a
comparison and pass no gradient (the JAX step differentiates through it
and gets zeros).
`make_eval_fn` builds `eval_fn(model, batch)`: the same objective
without gradients, with the finest flow and reconstruction.

The model works in NCHW; the loss keeps the JAX package's NHWC, through
permuted views of the same memory. Under `train.compute_dtype=
"bfloat16"` the train step casts the network's input pair to bf16 and
the model's flows back to float32 before the loss, as the JAX step does;
the loss, the gradients, their norm and Adam stay float32.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..core.config import ExperimentConfig, LossConfig, check_trainable
from ..losses.photometric import check_loss_multi, check_loss_two_frame
from ..losses.pyramid import (lrn_normalize, preprocess, pyramid_loss,
                              pyramid_loss_multi)
from .state import TrainState, global_norm

Mean = tuple[float, float, float]

#: per-level loss components reported as `scale_<key>` stacks, finest first
SCALE_KEYS = ("total", "Charbonnier_reconstruct", "U_loss", "V_loss",
              "smooth")
#: the batch entries the step reads (what `batch_to_device` and the
#: prefetcher move to the device; other entries stay on the host)
IMAGE_KEYS = ("source", "target", "net_source", "net_target", "volume")


def compute_dtype(cfg: ExperimentConfig) -> torch.dtype:
    """The torch dtype of `cfg.train.compute_dtype` (one of
    `core.config.COMPUTE_DTYPES`, which are torch's names)."""
    return getattr(torch, cfg.train.compute_dtype)


def model_losses(model, batch: dict[str, torch.Tensor], mean: Mean,
                 loss_cfg: LossConfig, smooth_border_mask: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False
                 ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Forward + objective for a flow model. batch: NHWC float images
    "source" and "target" (and optionally the augmented "net_source"/
    "net_target" that feed the network), or a T-frame "volume"
    (B, H, W, 3T). The network's input is cast to `compute_dtype`, its
    flows back to float32. `remat` recomputes the model forward in
    backward. Returns (total, aux with the per-level loss dicts, finest
    scaled flow, finest reconstruction)."""

    def fwd(x):
        if remat:
            return checkpoint(model, x, use_reentrant=False)
        return model(x)

    if "volume" in batch:
        vol = batch["volume"]
        # the BGR mean of each of the T frames, stacked frame-major
        scaled = preprocess(vol, tuple(mean) * (vol.shape[-1] // 3))
        flows = [f.float().permute(0, 2, 3, 1) for f in fwd(
            scaled.permute(0, 3, 1, 2).to(compute_dtype).contiguous())]
        total, losses, recon = pyramid_loss_multi(
            list(zip(flows, model.flow_scales)), lrn_normalize(scaled),
            loss_cfg)
        return total, {"losses": losses, "recon": recon,
                       "flow": flows[0] * model.flow_scales[0]}
    src = preprocess(batch["source"], mean)
    tgt = preprocess(batch["target"], mean)
    net_src = (preprocess(batch["net_source"], mean)
               if "net_source" in batch else src)
    net_tgt = (preprocess(batch["net_target"], mean)
               if "net_target" in batch else tgt)
    pair = torch.cat([net_src, net_tgt], dim=-1).permute(0, 3, 1, 2)
    flows = [f.float().permute(0, 2, 3, 1)
             for f in fwd(pair.to(compute_dtype).contiguous())]
    flows_bw = None
    if loss_cfg.occlusion:
        # the backward flows, for the occlusion masks only
        swapped = torch.cat([net_tgt, net_src], dim=-1).permute(0, 3, 1, 2)
        with torch.no_grad():
            flows_bw = [f.float().permute(0, 2, 3, 1) for f in model(
                swapped.to(compute_dtype).contiguous())]
    total, losses, recon = pyramid_loss(
        list(zip(flows, model.flow_scales)), lrn_normalize(src),
        lrn_normalize(tgt), loss_cfg, smooth_border_mask,
        flow_pyramid_bw=flows_bw)
    return total, {"losses": losses, "recon": recon,
                   "flow": flows[0] * model.flow_scales[0]}


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The images of a batch (numpy arrays or tensors) as float32
    tensors on `device`. A float32 tensor already there is passed as it
    is (the prefetcher's staged batches): no second copy."""
    return {k: torch.as_tensor(batch[k], dtype=torch.float32, device=device)
            for k in IMAGE_KEYS if k in batch}


def make_train_step(model, cfg: ExperimentConfig, mean: Mean,
                    smooth_border_mask: bool = False
                    ) -> Callable[[TrainState, dict], dict]:
    """(state, batch) -> metrics: total, grad_norm, update_skipped and the
    five scale_* stacks (one value a pyramid level, finest first), as
    tensors on the model's device; under steps_per_call = K > 1 a batch
    of [K, B, ...] entries and metrics stacked over K. `state` is
    updated in place. The step reads nothing back: the skip and the
    update are decided on the device (`TrainState.apply_gradients`), and
    the loop's fetcher (`train/metrics_log.py`) takes the metrics to the
    host when a record is due. The batch may hold numpy arrays or
    tensors; it moves to the model's device."""
    check_trainable(cfg)
    # the loss's own ValueErrors on bad pairings, before the first step
    (check_loss_multi if cfg.data.time_step > 2
     else check_loss_two_frame)(cfg.loss)
    device = next(model.parameters()).device
    dtype = compute_dtype(cfg)
    skip = cfg.resilience.skip_nonfinite

    def step(state: TrainState, batch: dict) -> dict:
        state.optimizer.zero_grad(set_to_none=True)
        total, aux = model_losses(model, batch_to_device(batch, device),
                                  mean, cfg.loss, smooth_border_mask, dtype,
                                  remat=cfg.train.remat)
        total.backward()
        total = total.detach()
        grad_norm = global_norm([p.grad for p in model.parameters()
                                 if p.grad is not None])
        finite = (torch.isfinite(total) & torch.isfinite(grad_norm)
                  if skip else None)
        state.apply_gradients(grad_norm, finite)
        metrics = {"total": total, "grad_norm": grad_norm,
                   "update_skipped": (torch.zeros_like(total)
                                      if finite is None
                                      else (~finite).float())}
        metrics.update({f"scale_{k}": torch.stack(
            [d[k] for d in aux["losses"]]).detach() for k in SCALE_KEYS})
        return metrics

    k = max(cfg.train.steps_per_call, 1)
    if k == 1:
        return step

    def multi_step(state: TrainState, batches: dict) -> dict:
        rows = [step(state, {key: v[i] for key, v in batches.items()})
                for i in range(k)]
        return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}

    return multi_step


def make_eval_fn(cfg: ExperimentConfig, mean: Mean,
                 smooth_border_mask: bool = False
                 ) -> Callable[[Any, dict], dict]:
    """(model, batch) -> {"total": float, "flow": (B, h, w, 2) numpy,
    "recon": (B, h, w, 3) numpy}: the objective, the finest flow
    (already multiplied by its flow scale) and the finest
    reconstruction, under `torch.no_grad()` with the model in eval mode
    (its mode is restored after). The pair goes in float32, as in the
    JAX package's eval; a bf16 model's convolutions cast it."""

    def eval_fn(model, batch: dict) -> dict:
        device = next(model.parameters()).device
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                total, aux = model_losses(model,
                                          batch_to_device(batch, device),
                                          mean, cfg.loss, smooth_border_mask)
                return {"total": total.item(),
                        "flow": aux["flow"].cpu().numpy(),
                        "recon": aux["recon"].cpu().numpy()}
        finally:
            model.train(was_training)

    return eval_fn
