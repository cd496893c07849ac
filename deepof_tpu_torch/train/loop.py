"""The epoch-loop trainer (port of the single-process `Trainer` of
`deepof_tpu/train/loop.py`).

`Trainer(cfg)` builds the model, the dataset, the schedule and the Adam
state, the metrics log and the checkpoint manager; it then starts from
`train.init_from` (fresh starts only) or resumes from the newest
checkpoint that verifies, and refuses to start from scratch when
checkpoints exist but none restores. `fit(num_epochs, max_steps)` trains:

  - batches come through the self-healing sampler, the input pipeline
    and the prefetcher. Batch i of a fit that starts at step s is
    `dataset.sample_train(batch_size, rng=derive_batch_rng([seed, s],
    i))`, the JAX loop's stream on one process, bit-identical for any
    `data.num_workers` and `data.prefetch`;
  - a train record every `train.log_every` steps and at each epoch end;
    an eval record (`evaluate_aee`) every `train.eval_every` steps and at
    each epoch end; a checkpoint every `train.ckpt_every_epochs` epochs
    and every `train.ckpt_every_steps` steps;
  - the divergence ladder: the step skips a non-finite update in place;
    `resilience.max_consecutive_skips` skips in a row roll the state
    back to the last checkpoint (`train.nan_guard`), and the third
    rollback in a row raises FloatingPointError;
  - a final checkpoint, only of a state whose last loss was finite or
    whose non-finite update was skipped.
The summary holds the eval metrics, rates, median step and phase times,
phase totals and counters, and the checkpoint saves' seconds.

The JAX loop sees metric values only at log, eval and checkpoint
boundaries; this package's step reads them back every step, so the skip
streak counts every step. Not ported (ROADMAP): the recipe engine,
elastic training, multi-host meshes, `steps_per_call`, fault injection,
the heartbeat, trace, ledger and incident recorder, and the SIGTERM
latch.

The Trainer leaves the global TF32 switches of PyTorch as it finds them.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..core.config import ExperimentConfig, check_trainable
from ..core.device import resolve_device
from ..data.datasets import build_dataset
from ..data.pipeline import InputPipeline, derive_batch_rng
from ..data.prefetch import Prefetcher
from ..models.registry import build_model
from ..resilience.healing import HealingSampler
from ..resilience.verify import config_digest
from .checkpoint import CheckpointManager, transfer_params
from .evaluate import evaluate_aee
from .metrics_log import MetricsLogger, StepTimer
from .schedule import step_decay_schedule
from .state import create_train_state
from .step import compute_dtype, make_eval_fn, make_train_step

# A prefetch.get() wait above this counts as a `starved` step (the card
# had no staged batch); below it is queue hand-off noise.
STARVED_WAIT_S = 1e-3

#: Per-pyramid-scale loss decomposition in every train record: record
#: field -> the step metric it reads (finest first).
SCALE_RECORD_FIELDS: tuple[tuple[str, str], ...] = (
    ("loss_total_by_scale", "scale_total"),
    ("loss_photo_by_scale", "scale_Charbonnier_reconstruct"),
    ("loss_smooth_by_scale", "scale_smooth"),
)


def per_scale_last(v) -> list[float]:
    """A per-scale vector (finest first) as a JSON-ready list, to 6
    significant figures."""
    return [float(f"{float(x):.6g}") for x in np.atleast_1d(np.asarray(v))]


def data_stream_seed(seed: int, start_step: int) -> np.ndarray:
    """Base seed of the data stream of a fit that begins at start_step:
    (seed, start_step), so each resume draws a fresh stream (the data rng
    is not part of the checkpoint)."""
    return np.array([seed, start_step], dtype=np.uint32)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, dataset=None,
                 device: str | torch.device = "cuda"):
        check_trainable(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dataset = (dataset if dataset is not None
                        else build_dataset(cfg.data))
        self.model = build_model(
            cfg.model, flow_channels=2 * (cfg.data.time_step - 1),
            width_mult=cfg.width_mult, corr_max_disp=cfg.corr_max_disp,
            corr_stride=cfg.corr_stride, seed=cfg.train.seed,
            device=self.device, dtype=compute_dtype(cfg))
        self.logger = MetricsLogger(cfg.train.log_dir)
        self.steps_per_epoch = max(
            self.dataset.num_train // cfg.data.batch_size, 1)
        self.schedule = step_decay_schedule(cfg.optim, self.steps_per_epoch)
        self.state = create_train_state(self.model, cfg.optim, self.schedule)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.log("info", 0, message=f"model parameters: {n_params:,}")
        self.ckpt = CheckpointManager(
            os.path.join(cfg.train.log_dir, "ckpt"),
            keep=cfg.train.keep_ckpts,
            verify=cfg.resilience.verify_checkpoints,
            log=lambda s, m: self.logger.log("warn", s, message=m),
            info_log=lambda s, m: self.logger.log("info", s, message=m),
            config_digest=config_digest(dataclasses.asdict(cfg)))

        # cross-config transfer init; fresh starts only
        if cfg.train.init_from and self.ckpt.latest_step() is None:
            src = CheckpointManager(
                os.path.join(cfg.train.init_from, "ckpt"),
                create=False).restore_raw(subtree="model")
            if src is None:
                raise FileNotFoundError(
                    f"train.init_from: no checkpoint under "
                    f"{cfg.train.init_from}/ckpt")
            sd, n_copied, n_skipped = transfer_params(
                self.model.state_dict(), src)
            self.model.load_state_dict(sd)
            self.logger.log(
                "info", 0,
                message=f"transfer init from {cfg.train.init_from}: "
                        f"{n_copied} tensors copied, {n_skipped} re-init")

        if self.ckpt.restore(self.state) is not None:
            self.logger.log("info", self.state.step,
                            message=f"resumed from step {self.state.step}")
        elif self.ckpt.latest_step() is not None:
            # checkpoints exist but none restores: starting from step 0
            # would prune the damaged run's directory and hide it
            raise RuntimeError(
                f"auto-resume: checkpoints exist under {self.ckpt.directory} "
                "but none is restorable (all candidates failed "
                "verification/restore); refusing to silently restart from "
                "scratch — `deepof_tpu_torch.resilience.verify.verify_run"
                f"({cfg.train.log_dir!r})` gives per-checkpoint status; move "
                "the ckpt directory aside to start fresh")

        self.train_step = make_train_step(self.model, cfg, self.dataset.mean)
        self.eval_fn = make_eval_fn(cfg, self.dataset.mean)

    def _next_train_batch(self, it: int, rng: np.random.RandomState) -> dict:
        return self.dataset.sample_train(self.cfg.data.batch_size, rng=rng)

    def evaluate(self, dump: bool = False) -> dict[str, float]:
        """The AEE protocol; with `dump`, the first val batch's visuals
        go to <log_dir>/visuals."""
        dump_dir = (os.path.join(self.cfg.train.log_dir, "visuals")
                    if dump else None)
        return evaluate_aee(self.eval_fn, self.model, self.dataset, self.cfg,
                            dump_dir)

    def fit(self, num_epochs: int | None = None,
            max_steps: int | None = None) -> dict[str, float]:
        cfg = self.cfg
        self.model.train()
        start_step = self.state.step
        seed_arr = data_stream_seed(cfg.train.seed, start_step)
        # warn records from the healer (worker threads) stamp the loop's
        # current step
        cur_step = {"s": start_step}
        healer = HealingSampler(
            make_rng=lambda i, rnd: derive_batch_rng(seed_arr, i, salt=rnd),
            sample=self._next_train_batch,
            retries=cfg.resilience.data_retries,
            backoff_s=cfg.resilience.data_backoff_s,
            substitutes=cfg.resilience.data_substitutes,
            log=lambda m: self.logger.log("warn", cur_step["s"], message=m))
        timer = StepTimer(cfg.data.batch_size)
        pipeline = InputPipeline(healer, num_workers=cfg.data.num_workers,
                                 reorder_depth=cfg.data.reorder_depth,
                                 retries=cfg.resilience.pipeline_retries,
                                 backoff_s=cfg.resilience.data_backoff_s)
        try:
            prefetch = Prefetcher(pipeline.get, depth=cfg.data.prefetch,
                                  device=self.device, phase_cb=timer.phase)
        except BaseException:
            pipeline.close()  # its workers started at construction
            raise

        def resilience_stats() -> dict:
            return {**{f"data_{k}": v for k, v in pipeline.stats().items()},
                    **{f"data_{k}": v for k, v in prefetch.stats().items()},
                    **{f"data_{k}": v for k, v in healer.stats().items()},
                    **{f"ckpt_{k}": v for k, v in self.ckpt.stats().items()}}

        max_skips = max(cfg.resilience.max_consecutive_skips, 1)
        skip_streak = 0
        last_eval: dict[str, float] = {}

        def on_metrics(gs: int, ep: int, log_due: bool, m: dict) -> bool:
            """The divergence ladder and the train record for step gs.
            Returns True when the state must roll back: a non-finite loss
            whose update was not skipped, or a streak of skipped
            updates."""
            nonlocal skip_streak
            skipped = int(round(m["update_skipped"]))
            if skipped:
                timer.count("skipped_updates", skipped)
                skip_streak += skipped
                self.logger.log(
                    "warn", gs,
                    message=f"non-finite grads at step {gs}: {skipped} "
                            f"update(s) skipped in place (state unchanged; "
                            f"streak {skip_streak}/"
                            f"{cfg.resilience.max_consecutive_skips})")
            nonfinite = cfg.train.nan_guard and not np.isfinite(m["total"])
            if nonfinite and not skipped:
                return True  # never log a diverged record
            if skipped and cfg.train.nan_guard and skip_streak >= max_skips:
                return True  # escalate skip -> rollback
            if not skipped:
                skip_streak = 0
            if nonfinite or not log_due:
                return False
            cache = getattr(self.dataset, "cache_stats", None)
            self.logger.log(
                "train", gs, epoch=ep, loss=m["total"],
                lr=float(self.schedule(gs - 1)), grad_norm=m["grad_norm"],
                **{f: per_scale_last(m[src])
                   for f, src in SCALE_RECORD_FIELDS},
                **timer.rates(), **timer.phases(), **timer.counters(),
                **resilience_stats(),
                **({f"decode_cache_{k}": v for k, v in cache().items()
                    if k in ("hits", "misses", "evictions")}
                   if cache is not None else {}))
            return False

        def crossed(prev: int, new: int, every: int) -> bool:
            return every > 0 and prev // every != new // every

        try:
            total_steps = ((num_epochs or cfg.train.num_epochs)
                           * self.steps_per_epoch)
            if max_steps is not None:
                total_steps = min(total_steps, start_step + max_steps)
            if cfg.train.nan_guard and self.ckpt.latest_step() is None:
                self.ckpt.save(self.state)  # rollback target before step 1
            ckpt_mark = timer.mark()
            gstep = start_step
            consecutive_rollbacks = 0
            metrics = None
            while gstep < total_steps:
                t0 = time.perf_counter()
                batch = prefetch.get()
                wait = time.perf_counter() - t0
                timer.phase("assemble", wait)
                if wait > STARVED_WAIT_S:
                    timer.count("starved")
                t0 = time.perf_counter()
                metrics = self.train_step(self.state, batch)
                timer.phase("dispatch", time.perf_counter() - t0)
                if gstep == start_step:
                    self.logger.log(
                        "info", gstep + 1,
                        message=f"first step: "
                                f"{time.perf_counter() - t0:.1f}s")
                timer.tick()
                prev, gstep = gstep, gstep + 1
                cur_step["s"] = gstep
                epoch = gstep // self.steps_per_epoch
                end_of_epoch = crossed(prev, gstep, self.steps_per_epoch)
                log_due = (crossed(prev, gstep, cfg.train.log_every)
                           or end_of_epoch)
                eval_due = end_of_epoch or crossed(prev, gstep,
                                                   cfg.train.eval_every)
                ckpt_due = ((end_of_epoch
                             and epoch % cfg.train.ckpt_every_epochs == 0)
                            or crossed(prev, gstep,
                                       cfg.train.ckpt_every_steps))

                if on_metrics(gstep, epoch, log_due, metrics):
                    skip_streak = 0  # the rollback rewinds the run
                    timer.count("rollbacks")
                    self._rollback(gstep)
                    gstep = self.state.step
                    # discarded steps do not count toward throughput;
                    # boundaries up to the divergence re-fire as gstep
                    # crosses them again
                    timer.rewind(ckpt_mark)
                    consecutive_rollbacks += 1
                    if consecutive_rollbacks >= 3:
                        raise FloatingPointError(
                            f"loss diverged to NaN {consecutive_rollbacks} "
                            f"consecutive times around step {gstep}; "
                            "rollback is not recovering — aborting")
                    continue
                if not (cfg.train.nan_guard
                        and not np.isfinite(metrics["total"])):
                    consecutive_rollbacks = 0  # a finite step recovered

                if eval_due:
                    last_eval = self.evaluate(dump=cfg.train.dump_visuals)
                    self.logger.log("eval", gstep, epoch=epoch, **last_eval)
                    timer.pause()  # eval time is not training throughput
                if ckpt_due:
                    if self.ckpt.save(self.state) is not None:
                        # a failed save keeps the previous mark: a
                        # rollback restores the last checkpoint written
                        ckpt_mark = timer.mark()
                    timer.pause()
            if healer.quarantine_log:
                self.logger.log(
                    "info", gstep,
                    message=f"{len(healer.quarantine_log)} sample draw(s) "
                            "quarantined and substituted this run: "
                            + "; ".join(
                                f"batch {ev['index']} round {ev['round']} "
                                f"({ev['error']})"
                                for ev in healer.quarantine_log[:20]))
            # never save a state whose last steps diverged: a non-finite
            # final loss is fine only if its update was skipped in place
            if (metrics is None or not cfg.train.nan_guard
                    or np.isfinite(metrics["total"])
                    or metrics["update_skipped"]):
                self.ckpt.save(self.state)
            else:
                self._rollback(gstep)
                timer.rewind(ckpt_mark)
                self.logger.log(
                    "warn", gstep,
                    message="non-finite loss at final step; state rolled "
                            "back to the last good checkpoint instead of "
                            "saving the diverged state")
        finally:
            # pipeline BEFORE prefetch: the prefetch thread may be blocked
            # in pipeline.get(), which only closing the pipeline releases
            pipeline.close()
            prefetch.close()
        return {**last_eval, **timer.rates(), **timer.medians(),
                **timer.phases(), **timer.counters(), **resilience_stats()}

    def _rollback(self, step: int) -> None:
        if self.ckpt.restore(self.state) is None:
            raise FloatingPointError(
                f"divergence at step {step} and no restorable checkpoint "
                f"under {self.ckpt.directory} to roll back to (none written "
                "yet, or every candidate failed verification)")
        self.logger.log("warn", step,
                        message=f"divergence at step {step}; rolled back to "
                                f"step {self.state.step}")
