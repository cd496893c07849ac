"""Objective and train step (port of `deepof_tpu/train/step.py`:
two-frame pairs, T-frame volumes and the UCF-101 action models).

`model_losses` preprocesses the pair (or the volume), runs the model and
the pyramid loss (`pyramid_loss`, or `pyramid_loss_multi` for a batch
with a "volume"). An action model adds its class: the classifier
(`classifier_only`) is the cross-entropy of its logits on the
preprocessed source frame alone; a two-stream model (`has_action_head`)
adds `loss.weights[0]` x the cross-entropy to the pyramid loss, and
reports `action_loss` and `accuracy`. Their logits are cast to float32
before the loss, as the JAX step casts every output. Dropout applies
only in the train step, on masks drawn from (`train.seed`, the loop's
global step) before the forward (`models/two_stream.py::dropout_masks`):
the loop puts the step in the batch (`STEP_KEY`; without it the step
counts its own calls from 0), so K steps a call draw the masks of K
single calls, a resumed run those of an unbroken one, and a forward
recomputed under `train.remat` gets the masks it was given.
`make_train_step` builds `step(state, batch) -> metrics`: forward,
backward, global gradient norm, and the micro-step
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
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import ExperimentConfig, LossConfig, check_trainable
from ..losses.photometric import check_loss_multi, check_loss_two_frame
from ..losses.pyramid import (lrn_normalize, preprocess, pyramid_loss,
                              pyramid_loss_multi)
from ..models.two_stream import dropout_masks
from .state import TrainState, global_norm

Mean = tuple[float, float, float]

#: per-level loss components reported as `scale_<key>` stacks, finest first
SCALE_KEYS = ("total", "Charbonnier_reconstruct", "U_loss", "V_loss",
              "smooth")
#: the image entries the step reads, float32 on the device
IMAGE_KEYS = ("source", "target", "net_source", "net_target", "volume")
#: the action class, int64 on the device
LABEL_KEY = "label"
#: the batch entries the step reads (what `batch_to_device` and the
#: prefetcher move to the device; other entries stay on the host)
DEVICE_KEYS = IMAGE_KEYS + (LABEL_KEY,)
#: the loop's global step of a batch (a host int; the dropout masks')
STEP_KEY = "step"


def device_dtype(key: str) -> torch.dtype:
    """The dtype of a DEVICE_KEYS entry on the device."""
    return torch.int64 if key == LABEL_KEY else torch.float32


def has_dropout(model) -> bool:
    """True for the action models, whose fc head drops out in training."""
    return bool(getattr(model, "has_action_head", False)
                or getattr(model, "classifier_only", False))


def compute_dtype(cfg: ExperimentConfig) -> torch.dtype:
    """The torch dtype of `cfg.train.compute_dtype` (one of
    `core.config.COMPUTE_DTYPES`, which are torch's names)."""
    return getattr(torch, cfg.train.compute_dtype)


def model_losses(model, batch: dict[str, torch.Tensor], mean: Mean,
                 loss_cfg: LossConfig, smooth_border_mask: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, dropout=None
                 ) -> tuple[torch.Tensor, dict[str, Any]]:
    """Forward + objective. batch: NHWC float images "source" and
    "target" (and optionally the augmented "net_source"/"net_target"
    that feed the network), or a T-frame "volume" (B, H, W, 3T); an
    action model's batch also has the int64 "label" (B,). The network's
    input is cast to `compute_dtype`, its outputs back to float32.
    `remat` recomputes the model forward in backward. `dropout`: an
    action model's two keep masks (None: no dropout). Returns (total,
    aux with the per-level loss dicts, finest scaled flow, finest
    reconstruction, and an action model's logits, action_loss and, for
    a two-stream one, accuracy)."""

    def fwd(x, *extra):
        if remat:
            return checkpoint(model, x, *extra, use_reentrant=False)
        return model(x, *extra)

    def net_input(x):
        return x.permute(0, 3, 1, 2).to(compute_dtype).contiguous()

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
    if getattr(model, "classifier_only", False):
        # frame 1, preprocessed: the network pair plays no part
        logits = fwd(net_input(src), dropout).float()
        ce = F.cross_entropy(logits, batch[LABEL_KEY])
        return ce, {"logits": logits, "action_loss": ce}
    tgt = preprocess(batch["target"], mean)
    net_src = (preprocess(batch["net_source"], mean)
               if "net_source" in batch else src)
    net_tgt = (preprocess(batch["net_target"], mean)
               if "net_target" in batch else tgt)
    pair = net_input(torch.cat([net_src, net_tgt], dim=-1))
    two_stream = getattr(model, "has_action_head", False)
    if two_stream:
        out, logits = fwd(pair, dropout)
        logits = logits.float()
    else:
        out = fwd(pair)
    flows = [f.float().permute(0, 2, 3, 1) for f in out]
    flows_bw = None
    if loss_cfg.occlusion and not two_stream:  # as the JAX step skips it
        # the backward flows, for the occlusion masks only
        swapped = torch.cat([net_tgt, net_src], dim=-1).permute(0, 3, 1, 2)
        with torch.no_grad():
            flows_bw = [f.float().permute(0, 2, 3, 1) for f in model(
                swapped.to(compute_dtype).contiguous())]
    total, losses, recon = pyramid_loss(
        list(zip(flows, model.flow_scales)), lrn_normalize(src),
        lrn_normalize(tgt), loss_cfg, smooth_border_mask,
        flow_pyramid_bw=flows_bw)
    aux = {"losses": losses, "recon": recon,
           "flow": flows[0] * model.flow_scales[0]}
    if two_stream:
        label = batch[LABEL_KEY]
        ce = F.cross_entropy(logits, label)
        # the action loss enters with the finest flow weight
        total = total + loss_cfg.weights[0] * ce
        aux.update(logits=logits, action_loss=ce, accuracy=(
            logits.argmax(-1) == label).float().mean())
    return total, aux


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """The entries of a batch the step reads (numpy arrays or tensors) on
    `device`: the images float32, the label int64. A tensor already
    there in that dtype is passed as it is (the prefetcher's staged
    batches): no second copy."""
    return {k: torch.as_tensor(batch[k], dtype=device_dtype(k),
                               device=device)
            for k in DEVICE_KEYS if k in batch}


def make_train_step(model, cfg: ExperimentConfig, mean: Mean,
                    smooth_border_mask: bool = False
                    ) -> Callable[[TrainState, dict], dict]:
    """(state, batch) -> metrics: total, grad_norm, update_skipped, the
    five scale_* stacks (one value a pyramid level, finest first; not for
    the classifier) and an action model's action_loss (and accuracy), as
    tensors on the model's device; under steps_per_call = K > 1 a batch
    of [K, B, ...] entries and metrics stacked over K. `state` is
    updated in place. The step reads nothing back: the skip and the
    update are decided on the device (`TrainState.apply_gradients`), and
    the loop's fetcher (`train/metrics_log.py`) takes the metrics to the
    host when a record is due. The batch may hold numpy arrays or
    tensors; it moves to the model's device."""
    check_trainable(cfg)
    if cfg.loss.occlusion and has_dropout(model):
        raise ValueError(
            "loss.occlusion=true supports only flow-only 2-frame models; "
            f"model={cfg.model!r} would silently skip the masking")
    # the loss's own ValueErrors on bad pairings, before the first step
    (check_loss_multi if cfg.data.time_step > 2
     else check_loss_two_frame)(cfg.loss)
    device = next(model.parameters()).device
    dtype = compute_dtype(cfg)
    skip = cfg.resilience.skip_nonfinite
    drops = has_dropout(model)
    gen = torch.Generator(device) if drops else None
    # the step of a batch without STEP_KEY: the one after the last
    next_at = {"step": 0}

    def step(state: TrainState, batch: dict) -> dict:
        at = batch.get(STEP_KEY, next_at["step"])
        next_at["step"] = int(at) + 1
        dev_batch = batch_to_device(batch, device)
        masks = (dropout_masks(len(dev_batch["source"]), cfg.train.seed, at,
                               device, gen) if drops else None)
        state.optimizer.zero_grad(set_to_none=True)
        total, aux = model_losses(model, dev_batch, mean, cfg.loss,
                                  smooth_border_mask, dtype,
                                  remat=cfg.train.remat, dropout=masks)
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
        if "losses" in aux:
            metrics.update({f"scale_{k}": torch.stack(
                [d[k] for d in aux["losses"]]).detach() for k in SCALE_KEYS})
        metrics.update({k: aux[k].detach() for k in ("action_loss",
                                                     "accuracy") if k in aux})
        return metrics

    k = max(cfg.train.steps_per_call, 1)
    if k == 1:
        return step

    def multi_step(state: TrainState, batches: dict) -> dict:
        at = batches.get(STEP_KEY)
        rows = [step(state, {**{key: v[i] for key, v in batches.items()
                                if key != STEP_KEY},
                             **({} if at is None else {STEP_KEY: at + i})})
                for i in range(k)]
        return {key: torch.stack([r[key] for r in rows]) for key in rows[0]}

    return multi_step


def make_eval_fn(cfg: ExperimentConfig, mean: Mean,
                 smooth_border_mask: bool = False
                 ) -> Callable[[Any, dict], dict]:
    """(model, batch) -> {"total": float, "flow": (B, h, w, 2) numpy,
    "recon": (B, h, w, 3) numpy, and an action model's "logits": (B,
    classes) numpy; the classifier has no flow or recon}: the objective,
    the finest flow (already multiplied by its flow scale) and the
    finest reconstruction, under `torch.no_grad()` with the model in
    eval mode (its mode is restored after), without dropout. The pair
    goes in float32, as in the JAX package's eval; a bf16 model's
    convolutions cast it."""

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
                        **{k: aux[k].cpu().numpy()
                           for k in ("flow", "recon", "logits") if k in aux}}
        finally:
            model.train(was_training)

    return eval_fn
