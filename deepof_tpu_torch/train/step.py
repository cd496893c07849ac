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

Over a world of ranks (`parallel/mesh.py`, `train --multihost`) each
rank steps on its own rows of the global batch, and after the backward
the ranks average their gradients and the step's metrics (`total`, the
`scale_*` stacks, `action_loss`, `accuracy`) with one `all_reduce` of a
flat buffer, where the JAX step takes the gradient of the global mean
under pjit. So the gradient norm, the non-finite skip and the Adam
update see the global gradient, and every rank takes the same decision
and the same update. The reduction is written out rather than left to
`DistributedDataParallel`: the skip and the norm need the averaged
gradient before the update, on every micro-step (gradient accumulation
is the optimizer's, `train/state.py`, so each micro-step reduces, as in
JAX), and one flat buffer is one collective a step with no hooks on the
remat or occlusion forwards. Dropout masks are drawn for the global
batch from (seed, step) and each rank takes its rows (F19), so a step of
two ranks is the step of one process on the whole batch, up to the
order of the sums.

Over a world with a spatial or time axis > 1 (spatial and temporal
context parallelism, `parallel/spatial.py`) the ranks of one data shard
(its spatial x time ranks) load the same rows, and the step holds one
invariant: **the losses of a data shard's spatial x time ranks add up to
that shard's loss**. Where H is sharded (`spatial_cp_active`) the model
runs row-sharded and hands every rank the flows gathered to full height,
so the loss is computed whole on each spatial rank; where the volume's
pairs are split (`pair_block`) each time rank warps its block and takes
its share of the terms computed whole (`losses/photometric.py::
loss_interp_multi`). So every term that each rank of a group computes in
full (the loss on gathered flows, the smoothness on the time axis, the
whole step where the gate is off and the ranks are replicas) enters the
rank's loss divided by the group's size: the step scales the loss and
its metrics by 1 / (spatial x (time unless the pairs are split)) before
the backward. The reduction is then one flat `all_reduce` (sum) over
the world divided by the data axis: the sum over each shard's group,
averaged over shards (`parallel/mesh.py::all_reduce_mean_`). The row
gather's adjoint sums each rank's cotangent back to the owner
(`parallel/spatial.py::all_rows`), which is exact under this invariant;
a term counted whole on every rank would come back multiplied by the
group's size (the x2 and x4 of the JAX package's GSPMD repro are that
kind of error). `total`, the `scale_*` stacks and `grad_norm` are the
global ones on every rank.

The model works in NCHW; the loss keeps the JAX package's NHWC, through
permuted views of the same memory. Under `train.compute_dtype=
"bfloat16"` the train step casts the network's input pair to bf16 and
the model's flows back to float32 before the loss, as the JAX step does;
the loss, the gradients, their norm and Adam stay float32. Over a
spatial or time axis a bf16 step shards as a float32 one does: the
exchanges and row gathers carry the bf16 rows bit for bit (and their
cotangents in the dtype autograd hands them), and the flows are
gathered to full height before the cast, as the one-process step casts
them.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import ExperimentConfig, LossConfig, check_trainable
from ..losses.photometric import check_loss_multi, check_loss_two_frame
from ..losses.pyramid import (lrn_normalize, preprocess, pyramid_loss,
                              pyramid_loss_multi)
from ..models.two_stream import dropout_masks
from ..parallel.mesh import (World, all_reduce_mean_, current_world,
                             global_rows, local_batch_rows)
from ..parallel.spatial import (SpatialGroup, check_context_parallel,
                                pair_block, spatial_cp_active, spatial_group)
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
                 remat: bool = False, dropout=None,
                 spatial: SpatialGroup | None = None,
                 pairs: tuple[int, int] | None = None
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
    a two-stream one, accuracy).

    `spatial`: run the model row-sharded over that group (the caller
    checked the gate); `pairs`: this rank's block of a volume's folded
    pairs (`pyramid_loss_multi`). Both give this rank's share of the
    loss only as `make_train_step` scales it."""

    net = model if spatial is None else functools.partial(model,
                                                           spatial=spatial)

    def fwd(x, *extra):
        if remat:
            return checkpoint(net, x, *extra, use_reentrant=False)
        return net(x, *extra)

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
            loss_cfg, pairs=pairs)
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
            flows_bw = [f.float().permute(0, 2, 3, 1) for f in net(
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
                    smooth_border_mask: bool = False,
                    world: World | None = None
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
    tensors; it moves to the model's device. `world` (default the
    process group's): over several ranks the batch is this rank's rows
    (the same rows on each rank of a data shard), and the gradients and
    metrics are summed over each shard's spatial x time ranks and
    averaged over the shards (the module docstring's invariant). A
    setting that would shard rows or pairs on a path not ported yet
    raises NotImplementedError (`check_context_parallel`)."""
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
    world = world if world is not None else current_world()
    check_context_parallel(cfg, model, world.shape["data"])
    group = spatial_group(world)
    n_spatial, n_time = world.shape["spatial"], world.shape["time"]
    drops = has_dropout(model)
    gen = torch.Generator(device) if drops else None
    # the step of a batch without STEP_KEY: the one after the last
    next_at = {"step": 0}

    def _context(dev_batch: dict) -> tuple[bool, tuple[int, int] | None]:
        """(rows sharded, this rank's pair block) for this batch."""
        img = dev_batch.get("volume", dev_batch.get("source"))
        shard = group is not None and spatial_cp_active(
            img.shape[1], getattr(model, "max_downsample", 64), n_spatial)
        pairs = None
        if "volume" in dev_batch and n_time > 1:
            local = img.shape[0]
            pairs = pair_block(global_rows(world, local), img.shape[-1] // 3,
                               world.shape["data"], n_time,
                               world.coords[2], local)
        return shard, pairs

    def step(state: TrainState, batch: dict) -> dict:
        at = batch.get(STEP_KEY, next_at["step"])
        next_at["step"] = int(at) + 1
        dev_batch = batch_to_device(batch, device)
        masks = None
        if drops:
            local = len(dev_batch["source"])
            masks = dropout_masks(global_rows(world, local), cfg.train.seed,
                                  at, device, gen)
            if world.distributed:
                # the global batch's masks, this rank's rows (F19)
                rows = torch.tensor(local_batch_rows(
                    world, global_rows(world, local))[1], device=device)
                masks = tuple(m.index_select(0, rows) for m in masks)
        shard, pairs = _context(dev_batch)
        state.optimizer.zero_grad(set_to_none=True)
        total, aux = model_losses(model, dev_batch, mean, cfg.loss,
                                  smooth_border_mask, dtype,
                                  remat=cfg.train.remat, dropout=masks,
                                  spatial=group if shard else None,
                                  pairs=pairs)
        # this rank's share of its data shard's loss (the invariant):
        # what every rank of a group computes whole, divided by its size
        share = 1.0 / (n_spatial * (1 if pairs is not None else n_time))
        if share != 1.0:
            total = total * share
        total.backward()
        total = total.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        scales = ({k: torch.stack([d[k] for d in aux["losses"]]).detach()
                   for k in SCALE_KEYS} if "losses" in aux else {})
        extra = {k: aux[k].detach() for k in ("action_loss", "accuracy")
                 if k in aux}
        if share != 1.0:
            scales = {k: v * share for k, v in scales.items()}
            extra = {k: v * share for k, v in extra.items()}
        if world.backend is not None:
            # the global gradient and the global batch's metrics, on
            # every rank, before the norm and the skip
            total = total.clone()
            all_reduce_mean_([*grads, total, *scales.values(),
                              *extra.values()], world)
        grad_norm = global_norm(grads)
        finite = (torch.isfinite(total) & torch.isfinite(grad_norm)
                  if skip else None)
        state.apply_gradients(grad_norm, finite)
        metrics = {"total": total, "grad_norm": grad_norm,
                   "update_skipped": (torch.zeros_like(total)
                                      if finite is None
                                      else (~finite).float())}
        metrics.update({f"scale_{k}": v for k, v in scales.items()})
        metrics.update(extra)
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
                 smooth_border_mask: bool = False, world: World | None = None
                 ) -> Callable[[Any, dict], dict]:
    """(model, batch) -> {"total": float, "flow": (B, h, w, 2) numpy,
    "recon": (B, h, w, 3) numpy, and an action model's "logits": (B,
    classes) numpy; the classifier has no flow or recon}: the objective,
    the finest flow (already multiplied by its flow scale) and the
    finest reconstruction, under `torch.no_grad()` with the model in
    eval mode (its mode is restored after), without dropout. The pair
    goes in float32, as in the JAX package's eval; a bf16 model's
    convolutions cast it. Over a `world` with a spatial axis the forward
    is row-sharded where the train step's is (the flows come back whole
    on every spatial rank); the loss is computed whole on every rank,
    the pairs unsplit: each rank holds its data shard's objective."""
    group = spatial_group(world) if world is not None else None

    def eval_fn(model, batch: dict) -> dict:
        device = next(model.parameters()).device
        was_training = model.training
        model.eval()
        dev_batch = batch_to_device(batch, device)
        img = dev_batch.get("volume", dev_batch.get("source"))
        shard = group is not None and spatial_cp_active(
            img.shape[1], model.max_downsample, group.size)
        try:
            with torch.no_grad():
                total, aux = model_losses(model, dev_batch, mean, cfg.loss,
                                          smooth_border_mask,
                                          spatial=group if shard else None)
                return {"total": total.item(),
                        **{k: aux[k].cpu().numpy()
                           for k in ("flow", "recon", "logits") if k in aux}}
        finally:
            model.train(was_training)

    return eval_fn
