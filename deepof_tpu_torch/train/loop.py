"""The epoch-loop trainer (port of the single-process `Trainer` of
`deepof_tpu/train/loop.py`).

`Trainer(cfg)` builds the model, the dataset, the schedule and the Adam
state, the metrics log and the checkpoint manager; it then starts from
`train.vgg16_npz` and `train.init_from` (fresh starts only) or resumes
from the newest checkpoint that verifies, and refuses to start from scratch when
checkpoints exist but none restores. `fit(num_epochs, max_steps)` trains:

  - batches come through the self-healing sampler, the input pipeline
    and the prefetcher. Micro-batch i of a fit that starts at step s is
    `dataset.sample_train(batch_size, rng=derive_batch_rng([seed, s],
    i))`, the JAX loop's stream on one process, bit-identical for any
    `data.num_workers`, `data.prefetch` and `train.steps_per_call`;
    under `data.augment_geo`/`augment_photo` its augmentation seed is
    drawn next from the same rng, and the prefetch thread augments the
    staged batch on the device (`data/augmentation.py`), so the
    augmented stream is as bit-identical;
  - the UCF-101 action models (st_single, st_baseline, ucf101_spatial)
    train with their class (`train/step.py`): each call's batch carries
    the loop's global step (`STEP_KEY`), from which the step draws its
    dropout masks; their train records add `action_loss` and
    `accuracy`, their evals are `evaluate_ucf101`'s accuracy, and the
    two-stream ones mask the smoothness border, as in JAX;
  - one call of the train step runs K = `train.steps_per_call` steps
    over K stacked micro-batches (call c draws micro-batches cK ..
    cK+K-1, a pure function of c). The cadences are tested once per
    call: a train record when the call's stride crosses a multiple of
    `train.log_every` (and at each epoch end), an eval record
    (`evaluate_aee`) at `train.eval_every` and epoch ends, a checkpoint
    at `train.ckpt_every_steps` and every `train.ckpt_every_epochs`
    epochs, each at the stride's end step; records carry the last inner
    step's values and the skips summed over the K. A `max_steps` that is
    not a multiple of K ends at the next stride's end, as in JAX;
  - metric fetches at the JAX loop's cadence: a call's metrics are
    submitted to the fetcher only when a record, an eval or a checkpoint
    is due, and the fetcher is drained before eval, before a checkpoint,
    on a rollback event and at the end (within 120 s). At
    `train.pipeline_depth` = d > 0 (the JAX default, 2) an
    `AsyncFetcher` takes them to the host on its own thread, up to d
    fetches behind the dispatch, so the host queues the next calls while
    the card computes; at 0 a `SyncFetcher` reads inline;
  - the divergence ladder, in the fetch's callback as in JAX: the step
    skips a non-finite micro-step in place, on the device;
    `resilience.max_consecutive_skips` skips in a row (counted over the
    fetched calls) roll the state back to the last checkpoint
    (`train.nan_guard`), and the third rollback in a row raises
    FloatingPointError;
  - a final checkpoint, only of a state whose last loss was finite or
    whose non-finite update was skipped. Checkpoints are named by the
    state's step, which counts applied micro-steps (the JAX state's
    step): after a skipped step it lags the loop's;
  - the first SIGTERM ends the loop at the next call boundary and goes
    down that final path (a SIGTERM latched by
    `install_preemption_latch` before `fit` stops it before its first
    step); a second one takes the default action; the previous handler
    is restored on exit;
  - the fault injector's sites (`resilience.faults`): ``decode`` in the
    sampler, ``assemble`` per call on the pipeline, ``dispatch`` (one
    NaN in the call's first micro-batch when a step of its window is
    scheduled), ``fetch`` in the metrics fetch, and the checkpoint
    sites; its counters join the records and the summary as `fault_*`;
  - observability (`obs/`): spans `input_wait`, `dispatch`, `eval`,
    `ckpt` and `rollback` on the main thread, `put` and `augment` on
    the prefetch thread, `assemble` on the pipeline workers and `fetch` on the fetcher
    (`obs.trace` -> `<log_dir>/trace.json`); `heartbeat.json` with the
    wedge watchdog (`obs.heartbeat`); device memory, RSS, and with
    `obs.flops` the model TFLOP/s and `mfu_nominal` in train records;
    `--profile` / `--profile-steps` through `ProfilerSession`.
The summary holds the eval metrics, rates, median step and phase times,
phase totals and counters, the checkpoint saves' seconds, the telemetry,
the fetcher's `pipeline_*` counters (fetches, fetch seconds, retries,
the most in flight), `pipeline_depth`, the depth the loop ran at, and
`kernel_launches`, each CUDA kernel's launches in this process over
the fit (by counter, `ops/cuda/build.py::launch_counts`; a process of
its own, a rank or an elastic host, reports its kernels this way).
Depth 0 and depth d > 0 run the same step and give the same bits; only
the time the host waits differs. Under `obs.incidents` the loop installs
the incident recorder (`obs/incident.py`, role "trainer"): a NaN
rollback commits a `nan_rollback` bundle, the third in a row a critical
`nan_quarantine_exhausted` one before the abort, and a watchdog wedge a
critical `watchdog_wedge` one with the stack dump; the heartbeat's
samples feed its ring and alert rules. The staged recipe
(train/recipe.py) drives one Trainer a stage through the hooks below.

Over a world of ranks (`parallel/mesh.py`; `train --multihost` under
`torchrun`), as the JAX loop over processes: each rank draws only its
rows of the global batch (`local_batch_rows`) from its own stream
(`data_stream_seed` over `process_seed`: seed + the rank's data
coordinate), the step averages the gradients and metrics over the ranks
(`train/step.py`), the parameters are broadcast from rank 0 after the
build and the restore, rank 0 alone writes checkpoints, records, the
trace, the heartbeat, the ledger, incidents, the profile and the
visuals, every rank restores, and each rank evaluates its rows of the
same val batch with the outputs gathered (`train/evaluate.py`). Two
things differ from the JAX loop, where a rank that decides alone would
leave the others waiting in a collective: the ranks agree on a SIGTERM
stop at each call boundary (one host-group all_reduce), and the loop
reads metrics inline (pipeline depth 0, the summary's
`pipeline_depth`), so the divergence ladder's rollbacks fall at the same
step on every rank. `StepTimer` counts the world's devices. The backend
is named in the first record, the heartbeat and the summary
(`dist_backend`, `world_size`).

An elastic pool's trainer child (`train/elastic.py`; `elastic.host_index`
>= 0) takes its hooks from the config the coordinator wrote: the shared
checkpoint directory (`elastic.ckpt_dir`), written by the generation's
primary only; its stream from `elastic_stream_seed` (seed, host, world
size, generation, start step); the absolute `elastic.target_step`; the
step-skew limiter before each call (`pace_to_world`); the host fault
sites after each call's heartbeat beat (`maybe_host_fault`); and a
config digest without its elastic identity or log dir, one for the
whole pool.

A float32 Trainer turns TF32 off (`core.device.disable_tf32`), so its
convolutions compute in float32 on the card as the command line's do; a
bf16 one leaves PyTorch's switches as it finds them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import time

import numpy as np
import torch

from ..core.config import (ACTION_MODELS, ElasticConfig, ExperimentConfig,
                           MeshConfig, check_trainable)
from ..core.device import disable_tf32, resolve_device
from ..data.augmentation import SEED_KEY, make_augment_fn
from ..data.datasets import build_dataset
from ..data.pipeline import InputPipeline, derive_batch_rng
from ..data.prefetch import Prefetcher
from ..models.common import load_vgg16_npz
from ..models.registry import build_model
from ..obs import incident as obs_incident
from ..obs import trace as obs_trace
from ..obs.heartbeat import Heartbeat
from ..obs.ledger import ExecutableLedger
from ..obs.telemetry import (NOMINAL_BF16_TFLOPS, count_flops,
                             device_memory_summary, process_rss_bytes)
from ..ops.cuda.build import launch_counts
from ..parallel.mesh import (World, any_rank, broadcast_, build_mesh,
                             elastic_stream_seed, host_barrier,
                             local_batch_rows, process_seed)
from ..resilience.faults import build_injector
from ..resilience.healing import HealingSampler
from ..resilience.verify import config_digest
from .checkpoint import CheckpointManager, transfer_params
from .elastic import maybe_host_fault, pace_to_world
from .evaluate import evaluate_aee, evaluate_ucf101, gathered_eval_fn
from .metrics_log import (AsyncFetcher, MetricsLogger, ProfilerSession,
                          StepTimer, SyncFetcher)
from .schedule import step_decay_schedule
from .state import create_train_state
from .step import STEP_KEY, compute_dtype, make_eval_fn, make_train_step

# Early-preemption latch: building the model and the kernels can take a
# while, and a SIGTERM landing before fit() installs its own handler would
# take the default action and kill the process with no checkpoint. The
# command line installs this latch first; fit() turns a latched signal
# into a save-and-stop before its first step. A second signal restores
# the default action and re-raises, so a wedged start stays killable.
_EARLY_SIGTERM: dict = {"sig": None, "handler": None}

#: models with a VGG16 trunk -> its submodule (`train.vgg16_npz`)
VGG_TRUNKS = {"vgg16": ("encoder",), "st_single": ("encoder",),
              "ucf101_spatial": ("encoder",), "st_baseline": ("spatial",)}
#: models whose loss masks the smoothness border (`pyramid_loss`)
SMOOTH_BORDER_MODELS = ("st_single", "st_baseline")

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
    """The last inner step's per-scale vector (finest first) as a
    JSON-ready list, to 6 significant figures; `v` has a leading K axis
    under steps_per_call > 1."""
    a = np.asarray(v)
    if a.ndim == 2:
        a = a[-1]
    return [float(f"{float(x):.6g}") for x in np.atleast_1d(a)]


def _scalar_last(v) -> float:
    """The last inner step's value of a metric (a list under
    steps_per_call > 1)."""
    a = np.asarray(v)
    return float(a) if a.ndim == 0 else float(a[-1])


def _host(v) -> np.ndarray:
    """A metric (a tensor on any device, or a number) as numpy."""
    return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)


def _poison_batch(batch: dict) -> dict:
    """The dispatch fault's action: one NaN in the first float input
    (its first element: the first micro-batch of a stacked call), on a
    copy, so the draw's own arrays stay as they were."""
    out = dict(batch)
    for key in ("volume", "source", *batch):
        v = out.get(key)
        if torch.is_tensor(v) and v.is_floating_point():
            v = v.clone()
        elif isinstance(v, np.ndarray) and np.issubdtype(v.dtype,
                                                         np.floating):
            v = v.copy()
        else:
            continue
        v[(0,) * v.ndim] = float("nan")
        out[key] = v
        return out
    return out


def install_preemption_latch() -> None:
    """Latch a SIGTERM that lands before fit() (see `_EARLY_SIGTERM`)."""

    def _latch(signum, frame):
        if _EARLY_SIGTERM["sig"] is not None:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)
            return
        _EARLY_SIGTERM["sig"] = signum

    # remembered so fit() does not re-install it on exit: after training
    # a SIGTERM must kill the process, not set a flag nobody reads
    _EARLY_SIGTERM["handler"] = _latch
    try:
        signal.signal(signal.SIGTERM, _latch)
    except ValueError:  # not the main thread
        pass


def data_stream_seed(seed: int, start_step: int,
                     world: World | None = None) -> np.ndarray:
    """Base seed of the data stream of a fit that begins at start_step:
    (process_seed, start_step), as the JAX loop's. The process seed is
    seed + the rank's data coordinate (`parallel/mesh.py`; seed itself
    on a world of one), so ranks draw decorrelated rows; start_step
    gives each resume a fresh stream (the data rng is not part of the
    checkpoint)."""
    if world is not None:
        seed = process_seed(world, seed)
    return np.array([seed, start_step], dtype=np.uint32)


class Trainer:
    """cfg, dataset (default `build_dataset(cfg.data)`), device, and the
    profiler's switches; then the hooks the staged recipe
    (train/recipe.py) drives, as the JAX Trainer's:

    ckpt_dir: the checkpoint lineage (default <log_dir>/ckpt); a
        recipe's stage i uses <log_dir>/ckpt-stage<i>.
    manifest_extra: written as ``extra`` into every checkpoint manifest
        (the stage's index, name and start step), so a resume finds it.
    extra_stats: a callable whose dict is merged into the heartbeat,
        every train record and the fit's summary (`recipe_*`).
    on_eval: on_eval(step, eval metrics) -> bool, called after each eval
        record; True ends `fit` there, through its final checkpoint (the
        plateau trigger).
    exec_names: the executable ledger's names of the train step and the
        eval step (`obs/ledger.py`); a recipe's stage i writes
        train_step_stage<i> and eval_step_stage<i>.
    world: the ranks this trainer is one of (`parallel/mesh.py`; default
        `build_mesh(cfg.mesh)` over the process group, a world of one
        without one; an elastic child is a world of one). Over several
        ranks `cfg.data.batch_size` is the global batch.

    Under `obs.ledger`, `fit` appends the train step's row to
    <log_dir>/ledger.jsonl at its first call, in the same pass that
    counts its FLOPs, and the eval step's row at the first eval forward;
    the ledger's exec_* block rides the heartbeat and the train records.

    The JAX Trainer's `train_step`, `eval_fn` and `tx` hooks inject
    ahead-of-time compiled XLA executables and the optimizer they were
    lowered against; this package compiles nothing per stage (its
    kernels are libraries built once, `ops/cuda/build.py`), so it has
    no counterpart to them.
    """

    def __init__(self, cfg: ExperimentConfig, dataset=None,
                 device: str | torch.device = "cuda",
                 profile: bool = False,
                 profile_steps: tuple[int, int] | None = None,
                 ckpt_dir: str | None = None,
                 manifest_extra: dict | None = None,
                 extra_stats=None, on_eval=None,
                 exec_names: tuple[str, str] = ("train_step", "eval_step"),
                 world: World | None = None):
        check_trainable(cfg)
        el = cfg.elastic
        # an elastic pool's trainer child (train/elastic.py): a world of
        # one, its hooks from the coordinator's config
        self._elastic_child = el.host_index >= 0 and el.num_hosts > 0
        if world is None:
            world = (build_mesh(MeshConfig(), 1, 0) if self._elastic_child
                     else build_mesh(cfg.mesh))
        self.world = world
        if world.device is not None and world.backend is not None:
            device = world.device  # init_distributed placed this rank
        primary = world.primary
        self._exec_names = exec_names
        # the fit's executable ledger (None outside a fit or when off),
        # and whether the eval step's row is still to be written
        self._ledger: ExecutableLedger | None = None
        self._eval_unrecorded = False
        self._extra_stats = extra_stats
        self._on_eval = on_eval
        self.device = resolve_device(device)
        if cfg.train.compute_dtype == "float32":
            disable_tf32()
        self.cfg = cfg
        self.dataset = (dataset if dataset is not None
                        else build_dataset(cfg.data))
        self.model = build_model(
            cfg.model, flow_channels=2 * (cfg.data.time_step - 1),
            width_mult=cfg.width_mult, corr_max_disp=cfg.corr_max_disp,
            corr_stride=cfg.corr_stride, seed=cfg.train.seed,
            device=self.device, dtype=compute_dtype(cfg),
            image_size=cfg.data.crop_size or cfg.data.image_size)
        self.logger = MetricsLogger(cfg.train.log_dir, primary=primary)
        self.profiler = ProfilerSession(cfg.train.log_dir,
                                        enabled=profile and primary,
                                        steps=profile_steps,
                                        device=self.device)
        # FLOPs of one optimizer step, counted at the first call of a fit
        # (obs.flops); None until then
        self._flops_per_step: float | None = None
        self.steps_per_epoch = max(
            self.dataset.num_train // cfg.data.batch_size, 1)
        # the rows this rank draws a step (the global batch on one rank)
        self.local_batch = local_batch_rows(world, cfg.data.batch_size)[0]
        self.schedule = step_decay_schedule(cfg.optim, self.steps_per_epoch)
        self.state = create_train_state(self.model, cfg.optim, self.schedule)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.log("info", 0, message=f"model parameters: {n_params:,}",
                        **self._world_stats())
        # one injector for the data path, the metrics read and the
        # checkpoints; None when injection is off
        self._inj = build_injector(cfg.resilience.faults)
        if self._inj is not None:
            self.logger.log("warn", 0, message="fault injection ENABLED "
                                               f"({cfg.resilience.faults})")
        # an elastic pool shares one checkpoint directory, which the
        # generation's primary host writes; over ranks, rank 0 writes
        if not ckpt_dir and self._elastic_child and el.ckpt_dir:
            ckpt_dir = el.ckpt_dir
        writer = primary and (not self._elastic_child
                              or el.host_index == el.primary_host)
        # the digest is the pool's: without a host's identity or log dir,
        # or each re-form would warn of a cross-config restore
        digest_src = cfg if not self._elastic_child else cfg.replace(
            train=dataclasses.replace(cfg.train, log_dir=""),
            elastic=ElasticConfig())
        self.ckpt = CheckpointManager(
            ckpt_dir or os.path.join(cfg.train.log_dir, "ckpt"),
            keep=cfg.train.keep_ckpts,
            verify=cfg.resilience.verify_checkpoints,
            log=lambda s, m: self.logger.log("warn", s, message=m),
            info_log=lambda s, m: self.logger.log("info", s, message=m),
            config_digest=config_digest(dataclasses.asdict(digest_src)),
            injector=self._inj, manifest_extra=manifest_extra,
            writer=writer)

        # VGG16 trunk init from the public npz; fresh starts only: a
        # checkpoint to resume from takes precedence
        if (cfg.train.vgg16_npz and cfg.model in VGG_TRUNKS
                and self.ckpt.latest_step() is None):
            load_vgg16_npz(self.model, cfg.train.vgg16_npz,
                           trunk_path=VGG_TRUNKS[cfg.model])
            self.logger.log(
                "info", 0,
                message=f"VGG16 trunk init from {cfg.train.vgg16_npz}")

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
        # one set of weights on every rank: rank 0's, after the build and
        # the restore; no rank leaves before every restore is done (rank
        # 0's first save must not race a reader)
        broadcast_(list(self.model.parameters()), world)
        host_barrier(world)

        # a sharded eval takes equal rows a rank: the eval batch rounds
        # to a multiple of the data axis (at least one row a shard)
        shards = world.shape["data"]
        eval_bs = max(cfg.train.eval_batch_size // shards, 1) * shards
        if eval_bs != cfg.train.eval_batch_size:
            self.logger.log(
                "warn", 0,
                message=f"eval_batch_size {cfg.train.eval_batch_size} not "
                        f"divisible by data axis ({shards}); adjusted to "
                        f"{eval_bs}")
            cfg = cfg.replace(train=dataclasses.replace(
                cfg.train, eval_batch_size=eval_bs))
            self.cfg = cfg

        smooth_border = cfg.model in SMOOTH_BORDER_MODELS
        self.train_step = make_train_step(self.model, cfg,
                                          self.dataset.mean, smooth_border,
                                          world=world)
        self.eval_fn = gathered_eval_fn(
            make_eval_fn(cfg, self.dataset.mean, smooth_border), world)
        # the augmentation of a staged batch (prefetch thread); None
        # when neither family is on
        self.augment = make_augment_fn(cfg.data.augment_geo,
                                       cfg.data.augment_photo)

    def _next_train_batch(self, it: int, rng: np.random.RandomState) -> dict:
        """The host batch of micro-step `it` from its own rng; with
        augmentation, its seed is drawn next from that rng, where the
        JAX loop draws it, and travels with the batch (`SEED_KEY`)."""
        batch = self.dataset.sample_train(self.local_batch, rng=rng)
        if self.augment is not None:
            batch[SEED_KEY] = np.int64(rng.randint(0, 2 ** 31))
        return batch

    def _world_stats(self) -> dict:
        """`dist_backend` and `world_size` under a process group (the
        first record, the heartbeat, the summary), else nothing."""
        if self.world.backend is None:
            return {}
        return {"dist_backend": self.world.backend,
                "world_size": self.world.size}

    def evaluate(self, dump: bool = False) -> dict[str, float]:
        """The AEE protocol; with `dump`, the first val batch's visuals
        go to <log_dir>/visuals (rank 0's). An action model's accuracy
        protocol."""
        dump = dump and self.world.primary
        eval_fn = self.eval_fn
        if self._ledger is not None and self._eval_unrecorded:
            eval_fn = self._recording_eval_fn()
        if self.cfg.model in ACTION_MODELS:
            return evaluate_ucf101(eval_fn, self.model, self.dataset,
                                   self.cfg)
        dump_dir = (os.path.join(self.cfg.train.log_dir, "visuals")
                    if dump else None)
        return evaluate_aee(eval_fn, self.model, self.dataset, self.cfg,
                            dump_dir)

    def _recording_eval_fn(self):
        """`eval_fn` whose first call writes the eval step's ledger row."""
        ledger, name = self._ledger, self._exec_names[1]

        def eval_fn(model, batch):
            if not self._eval_unrecorded:
                return self.eval_fn(model, batch)
            self._eval_unrecorded = False
            out, _ = ledger.record_call(
                name, lambda: self.eval_fn(model, batch), self.device,
                inputs=(list(model.parameters()), batch))
            return out

        return eval_fn

    def fit(self, num_epochs: int | None = None,
            max_steps: int | None = None) -> dict[str, float]:
        with contextlib.ExitStack() as stack:
            return self._fit(stack, num_epochs, max_steps)

    def _fit(self, stack: contextlib.ExitStack, num_epochs: int | None,
             max_steps: int | None) -> dict[str, float]:
        """`fit`'s body; `stack` tears down what it starts, in reverse:
        the heartbeat, the input pipeline and prefetcher, the tracer, and
        last the SIGTERM handler."""
        cfg = self.cfg
        world = self.world
        primary = world.primary
        el = cfg.elastic
        launches_before = launch_counts()
        self.model.train()
        start_step = self.state.step
        if self._elastic_child:
            # the host, the generation's world size and the generation
            # folded in: each re-form re-shards every survivor onto a
            # stream no earlier generation drew
            seed_arr = elastic_stream_seed(cfg.train.seed, el.host_index,
                                           el.num_hosts, el.generation,
                                           start_step)
        else:
            seed_arr = data_stream_seed(cfg.train.seed, start_step, world)
        inj = self._inj
        k = max(cfg.train.steps_per_call, 1)

        # The first SIGTERM ends the loop at the next call boundary and
        # the normal final path writes the checkpoint; a second takes the
        # default action, so a wedged run stays killable. Installed only
        # on the main thread (signal.signal raises ValueError elsewhere).
        stop_sig: dict[str, int | None] = {"sig": None}

        def _on_sigterm(signum, frame):
            if stop_sig["sig"] is not None:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)
                return
            stop_sig["sig"] = signum

        try:
            prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass
        else:
            # restored last, after the final checkpoint. A previous
            # handler set outside Python (None) cannot be re-installed,
            # and the early latch is not: after training a SIGTERM must
            # kill the process
            restore = prev_handler
            if restore is None or restore is _EARLY_SIGTERM["handler"]:
                restore = signal.SIG_DFL
            stack.callback(signal.signal, signal.SIGTERM, restore)
        if _EARLY_SIGTERM["sig"] is not None:
            # latched before fit(): save and stop before the first step
            stop_sig["sig"] = _EARLY_SIGTERM["sig"]
            _EARLY_SIGTERM["sig"] = None

        # the tracer goes in before the pipeline: its workers start
        # assembling at construction, and those spans belong on the
        # timeline; uninstalled and flushed on the way out
        tracer = None
        if cfg.obs.trace and primary:
            # (role, index) let obs/aggregate.py merge an elastic pool's
            # per-host timelines
            tracer = obs_trace.Tracer(
                path=os.path.join(cfg.train.log_dir, "trace.json"),
                ring_size=cfg.obs.trace_ring, role="trainer",
                index=max(el.host_index, 0))
            stack.enter_context(obs_trace.installed(tracer))

        # warn records from the healer (worker threads) stamp the loop's
        # current step
        cur_step = {"s": start_step}
        healer = HealingSampler(
            make_rng=lambda i, rnd: derive_batch_rng(seed_arr, i, salt=rnd),
            sample=self._next_train_batch,
            retries=cfg.resilience.data_retries,
            backoff_s=cfg.resilience.data_backoff_s,
            substitutes=cfg.resilience.data_substitutes,
            injector=inj,
            log=lambda m: self.logger.log("warn", cur_step["s"], message=m))

        def assemble(call_idx: int) -> dict:
            """The input of call `call_idx`, a pure function of it:
            micro-batches call_idx*K .. call_idx*K+K-1 (stacked on a
            leading axis when K > 1). The ``assemble`` fault site sits
            above the sampler, so an injected fault takes the pipeline's
            retry."""
            if inj is not None:
                inj.check("assemble", call_idx)
            if k == 1:
                return healer(call_idx)
            bs = [healer(i) for i in range(call_idx * k, call_idx * k + k)]
            return {key: np.stack([np.asarray(b[key]) for b in bs])
                    for key in bs[0]}

        timer = StepTimer(cfg.data.batch_size, world.num_devices)
        pipeline = InputPipeline(assemble, num_workers=cfg.data.num_workers,
                                 reorder_depth=cfg.data.reorder_depth,
                                 retries=cfg.resilience.pipeline_retries,
                                 backoff_s=cfg.resilience.data_backoff_s)
        stack.callback(pipeline.close)  # its workers started already
        prefetch = Prefetcher(pipeline.get, depth=cfg.data.prefetch,
                              device=self.device, phase_cb=timer.phase,
                              transform=self.augment)
        # pipeline BEFORE prefetch: the prefetch thread may be blocked in
        # pipeline.get(), which only closing the pipeline releases
        # (closing it twice is harmless)
        stack.callback(prefetch.close)
        stack.callback(pipeline.close)
        # metric fetches: at depth > 0 drained on a consumer thread, up to
        # `depth` calls behind the dispatch; at 0 inline, always over
        # several ranks (the ladder's decisions at one step on each)
        depth = (0 if world.distributed
                 else max(cfg.train.pipeline_depth, 0))
        fetch_kw = dict(timer=timer, retries=cfg.resilience.fetch_retries,
                        backoff_s=cfg.resilience.data_backoff_s,
                        injector=inj)
        fetcher = (AsyncFetcher(depth=depth, **fetch_kw) if depth > 0
                   else SyncFetcher(**fetch_kw))
        stack.callback(fetcher.close)

        # the executable ledger: rows at the first train call and the
        # first eval forward; dropped at the end of the fit
        ledger = (ExecutableLedger(cfg.train.log_dir,
                                   backend=self.device.type)
                  if cfg.obs.ledger and primary else None)
        self._ledger, self._eval_unrecorded = ledger, ledger is not None
        stack.callback(setattr, self, "_ledger", None)

        def ledger_stats() -> dict:
            """The ledger's exec_* block, for the heartbeat and the train
            records (the summary's values are numbers: not there)."""
            return ledger.stats() if ledger is not None else {}

        def resilience_stats() -> dict:
            """One merge of the data-path, metrics-read, checkpoint and
            fault counters and the `extra_stats` hook's for the
            heartbeat, the train records and the summary."""
            return {**{f"data_{k}": v for k, v in pipeline.stats().items()},
                    **{f"data_{k}": v for k, v in prefetch.stats().items()},
                    **{f"data_{k}": v for k, v in healer.stats().items()},
                    **{f"pipeline_{k}": v for k, v in fetcher.stats().items()},
                    **{f"ckpt_{k}": v for k, v in self.ckpt.stats().items()},
                    **({f"fault_{k}": v for k, v in inj.stats().items()}
                       if inj is not None else {}),
                    **(self._extra_stats()
                       if self._extra_stats is not None else {})}

        # the incident recorder (None unless obs.incidents)
        incidents = (obs_incident.install(cfg, cfg.train.log_dir, "trainer")
                     if primary else None)
        heartbeat = None
        if cfg.obs.heartbeat and primary:
            def hb_sample() -> dict:
                return {**timer.rates(), **timer.counters(),
                        **resilience_stats(), **ledger_stats(),
                        **self._world_stats()}

            heartbeat = Heartbeat(
                os.path.join(cfg.train.log_dir, "heartbeat.json"),
                period_s=cfg.obs.heartbeat_period_s,
                watchdog_factor=cfg.obs.watchdog_factor,
                watchdog_min_s=cfg.obs.watchdog_min_s,
                sample=(hb_sample if incidents is None
                        else incidents.wrap_sample(hb_sample)),
                log=lambda s, m: self.logger.log("warn", s, message=m),
                tracer=tracer, device=self.device,
                on_wedge=(None if incidents is None else
                          lambda dump: incidents.record(
                              "watchdog_wedge", "critical",
                              text_files={"stacks.txt": dump})))
            stack.callback(heartbeat.close)  # writes the final state

        def touch(flush: bool = False) -> None:
            if heartbeat is not None:
                heartbeat.touch(flush=flush)

        max_skips = max(cfg.resilience.max_consecutive_skips, 1)
        # the callback's verdicts for the main loop: a rollback due at a
        # step (nan_event) and a fetched finite step (streak)
        nan_event: dict = {"m": None}
        streak = {"ok": False}
        skip_state = {"streak": 0}
        last_eval: dict[str, float] = {}

        def on_metrics(tag, m: dict) -> None:
            """The fetched metrics of the call that ended at step gs (on
            the fetcher's thread, or inline at depth 0): the divergence
            ladder and the train record. A non-finite loss whose update
            was not skipped, or a streak of skipped updates (counted over
            the fetched calls, as in JAX), sets the rollback event."""
            gs, ep, log_due = tag
            skipped = int(round(float(np.sum(m["update_skipped"]))))
            if skipped:
                timer.count("skipped_updates", skipped)
                skip_state["streak"] += skipped
                self.logger.log(
                    "warn", gs,
                    message=f"non-finite grads at step {gs}: {skipped} "
                            f"update(s) skipped in place (state unchanged; "
                            f"streak {skip_state['streak']}/"
                            f"{cfg.resilience.max_consecutive_skips})")
            nonfinite = cfg.train.nan_guard and not np.isfinite(
                m["total"]).all()
            if nonfinite and not skipped:
                nan_event["m"] = (gs, m)
                return  # never log a diverged record
            if (skipped and cfg.train.nan_guard
                    and skip_state["streak"] >= max_skips):
                nan_event["m"] = (gs, m)  # escalate skip -> rollback
                return
            if not skipped:
                skip_state["streak"] = 0
            if nonfinite:
                return
            streak["ok"] = True
            if not log_due:
                return
            cache = getattr(self.dataset, "cache_stats", None)
            self.logger.log(
                "train", gs, epoch=ep, loss=_scalar_last(m["total"]),
                lr=float(self.schedule(gs - 1)),
                grad_norm=_scalar_last(m["grad_norm"]),
                **{key: _scalar_last(m[key]) for key in ("action_loss",
                                                         "accuracy")
                   if key in m},
                **{f: per_scale_last(m[src])
                   for f, src in SCALE_RECORD_FIELDS if src in m},
                **timer.rates(), **timer.phases(), **timer.counters(),
                **resilience_stats(), **ledger_stats(),
                **({f"decode_cache_{k}": v for k, v in cache().items()
                    if k in ("hits", "misses", "evictions")}
                   if cache is not None else {}),
                **self._telemetry(timer))

        def crossed(prev: int, new: int, every: int) -> bool:
            return every > 0 and prev // every != new // every

        total_steps = ((num_epochs or cfg.train.num_epochs)
                       * self.steps_per_epoch)
        if max_steps is not None:
            total_steps = min(total_steps, start_step + max_steps)
        if self._elastic_child and el.target_step > 0:
            # an absolute step: a respawned host stops where the run ends
            total_steps = int(el.target_step)
        if cfg.train.nan_guard and self.ckpt.latest_step() is None:
            self.ckpt.save(self.state)  # rollback target before step 1
        ckpt_mark = timer.mark()
        self.profiler.maybe_start()
        stack.callback(self.profiler.maybe_stop)  # on an error too
        gstep = start_step
        consecutive_rollbacks = 0
        metrics = None
        first_call = True
        # the floor of the pool's slowest host last seen (pace_to_world):
        # it only advances within a generation, so the file is read only
        # once this host is sync_ahead steps past it
        world_floor = start_step
        while (gstep < total_steps
               and not any_rank(stop_sig["sig"] is not None, world)):
            if (self._elastic_child and el.sync_ahead > 0 and el.world_file
                    and gstep - world_floor > el.sync_ahead):
                floor = pace_to_world(
                    el.world_file, el.generation, gstep, el.sync_ahead,
                    should_stop=lambda: stop_sig["sig"] is not None,
                    touch=touch,
                    # a coordinator silent past its own verdict horizon
                    # is gone: finish as an orphan, do not block
                    stale_s=max(3 * el.poll_s, el.stale_after_s))
                world_floor = floor if floor is not None else gstep
                if stop_sig["sig"] is not None:
                    break
            self.profiler.observe(gstep, k)  # --profile-steps window
            t0 = time.perf_counter()
            with obs_trace.span("input_wait"):
                batch = prefetch.get()
            # the call's first global step: its dropout masks'
            batch[STEP_KEY] = gstep
            wait = time.perf_counter() - t0
            timer.phase("assemble", wait)
            if wait > STARVED_WAIT_S:
                timer.count("starved")
            if inj is not None:
                # the whole window [gstep, gstep + K) is checked, so a
                # scheduled step inside a stride still fires
                hits = [s for s in range(gstep, gstep + k)
                        if inj.hit("dispatch", s)]
                if hits:
                    batch = _poison_batch(batch)
                    self.logger.log(
                        "warn", gstep,
                        message=f"fault injection: dispatch batch at "
                                f"step(s) {hits} poisoned with NaN")
            t0 = time.perf_counter()
            trace_s = None
            with obs_trace.span("dispatch", step=gstep + k):
                if first_call and ledger is not None:
                    # the ledger's row and the FLOP count in one pass
                    # around this call itself: no extra step, update or
                    # random draw
                    metrics, row = ledger.record_call(
                        self._exec_names[0],
                        lambda: self.train_step(self.state, batch),
                        self.device, count_flops=cfg.obs.flops,
                        inputs=(list(self.model.parameters()),
                                [st for st in self.state.optimizer.state
                                 .values()], self.state.acc, batch))
                    trace_s = round(ledger.trace_s, 4)
                    if cfg.obs.flops:
                        self._flops_per_step = (row["flops"] or 0) / k or None
                elif first_call and cfg.obs.flops:
                    metrics, flops = count_flops(
                        lambda: self.train_step(self.state, batch))
                    self._flops_per_step = flops / k or None
                else:
                    metrics = self.train_step(self.state, batch)
            if first_call and self.device.type == "cuda":
                # the first call builds kernels: timed to its end
                torch.cuda.synchronize(self.device)
            timer.phase("dispatch", time.perf_counter() - t0)
            if first_call:
                self.logger.log(
                    "info", gstep + k,
                    message=f"first step: {time.perf_counter() - t0:.1f}s",
                    flops_per_step=self._flops_per_step,
                    ledger_trace_s=trace_s)
                first_call = False
            timer.tick(k)
            prev, gstep = gstep, gstep + k
            cur_step["s"] = gstep
            if heartbeat is not None:
                heartbeat.beat(gstep)
            if inj is not None and self._elastic_child:
                # the host sites (train/elastic.py), after the beat: a
                # killed host's last heartbeat is the step it finished
                maybe_host_fault(
                    inj, el.host_index, gstep,
                    cfg.resilience.faults.host_fault_step,
                    log=lambda m: self.logger.log("warn", gstep, message=m))
            epoch = gstep // self.steps_per_epoch
            end_of_epoch = crossed(prev, gstep, self.steps_per_epoch)
            log_due = (crossed(prev, gstep, cfg.train.log_every)
                       or end_of_epoch)
            eval_due = end_of_epoch or crossed(prev, gstep,
                                               cfg.train.eval_every)
            ckpt_due = ((end_of_epoch
                         and epoch % cfg.train.ckpt_every_epochs == 0)
                        or crossed(prev, gstep, cfg.train.ckpt_every_steps))

            # one fetch serves the ladder and the record; it drains
            # behind the next dispatch
            if log_due or eval_due or ckpt_due:
                fetcher.submit((gstep, epoch, log_due), metrics, on_metrics)
            # eval and checkpoints see every fetched metric first, so a
            # diverged state is never evaluated or saved
            if eval_due or ckpt_due or nan_event["m"] is not None:
                fetcher.drain()
            if nan_event["m"] is not None:
                # an event may land between the check above and here:
                # drain again, so every fetch in flight lands before the
                # rewind
                fetcher.drain()
                nan_step, _ = nan_event["m"]
                nan_event["m"] = None
                streak["ok"] = False
                skip_state["streak"] = 0  # the rollback rewinds the run
                timer.count("rollbacks")
                if incidents is not None:
                    incidents.record(
                        "nan_rollback",
                        trigger={"nan_step": nan_step,
                                 "consecutive": consecutive_rollbacks + 1})
                self._rollback(nan_step)
                gstep = self.state.step
                # discarded steps do not count toward throughput;
                # boundaries up to the divergence re-fire as gstep
                # crosses them again
                timer.rewind(ckpt_mark)
                touch()  # the restore took time
                consecutive_rollbacks += 1
                if consecutive_rollbacks >= 3:
                    if incidents is not None:
                        incidents.record(
                            "nan_quarantine_exhausted", "critical",
                            trigger={"step": gstep,
                                     "consecutive": consecutive_rollbacks})
                    raise FloatingPointError(
                        f"loss diverged to NaN {consecutive_rollbacks} "
                        f"consecutive times around step {gstep}; "
                        "rollback is not recovering — aborting")
                continue
            if streak["ok"]:
                streak["ok"] = False
                consecutive_rollbacks = 0  # a finite step recovered

            if eval_due:
                # written from this thread before the sweep, whose host
                # work may starve the heartbeat's own thread
                touch(flush=True)
                with obs_trace.span("eval", step=gstep):
                    last_eval = self.evaluate(dump=cfg.train.dump_visuals)
                self.logger.log("eval", gstep, epoch=epoch, **last_eval)
                timer.pause()  # eval time is not training throughput
                touch()  # a long sweep is not a wedge
                if (self._on_eval is not None
                        and self._on_eval(gstep, dict(last_eval))):
                    # the recipe's advance trigger: end this fit at the
                    # eval boundary; the final path below writes the
                    # checkpoint the next stage starts from
                    self.logger.log(
                        "info", gstep,
                        message="on_eval hook requested stop at step "
                                f"{gstep} (stage advance trigger)")
                    break
            if ckpt_due:
                with obs_trace.span("ckpt", step=gstep):
                    saved = self.ckpt.save(self.state)
                if saved is not None or not self.ckpt.writer:
                    # a failed save keeps the previous mark: a rollback
                    # restores the last checkpoint written
                    ckpt_mark = timer.mark()
                timer.pause()
                touch()
        self.profiler.maybe_stop()
        if healer.quarantine_log:
            self.logger.log(
                "info", gstep,
                message=f"{len(healer.quarantine_log)} sample draw(s) "
                        "quarantined and substituted this run: "
                        + "; ".join(
                            f"batch {ev['index']} round {ev['round']} "
                            f"({ev['error']})"
                            for ev in healer.quarantine_log[:20]))
        if stop_sig["sig"] is not None:
            self.logger.log(
                "warn", gstep,
                message=f"signal {stop_sig['sig']} received; stopping "
                        "after a clean final checkpoint (auto-resume "
                        "continues from here)")
        # every fetch in flight lands before the final save, bounded: a
        # read wedged on a hung card must not keep the run from ending
        drained = fetcher.drain(timeout=120.0)
        if not drained:
            self.logger.log(
                "warn", gstep,
                message="metrics fetch still in flight after 120s at the "
                        "end of the fit (hung device?); the final state "
                        "cannot be checked for NaN: no final save")
        # never save a state whose last steps diverged: a non-finite
        # final loss is fine only if its update was skipped in place
        final_ok = drained and nan_event["m"] is None
        if final_ok and cfg.train.nan_guard and metrics is not None:
            total = np.atleast_1d(_host(metrics["total"]))
            bad = ~np.isfinite(total)
            final_ok = bool(np.all(np.atleast_1d(
                _host(metrics["update_skipped"]))[bad] >= 0.5))
        if final_ok:
            self.ckpt.save(self.state)
        elif drained:
            self._rollback(gstep)
            timer.rewind(ckpt_mark)
            self.logger.log(
                "warn", gstep,
                message="non-finite loss at final step; state rolled "
                        "back to the last good checkpoint instead of "
                        "saving the diverged state")
        return {**last_eval, **timer.rates(), **timer.medians(),
                **timer.phases(), **timer.counters(), **resilience_stats(),
                **{k: v for k, v in self._telemetry(timer).items()
                   if v is not None},
                "pipeline_depth": depth, **self._world_stats(),
                "kernel_launches": {
                    k: n - launches_before.get(k, 0)
                    for k, n in launch_counts().items()}}

    def _telemetry(self, timer: StepTimer) -> dict:
        """Device memory, RSS and model FLOP rate for a train record
        (`obs/telemetry.py`). The keys are the same on every device:
        what the CPU cannot report is null in metrics.jsonl."""
        out = device_memory_summary(self.device)
        out["rss_bytes"] = process_rss_bytes()
        if self._flops_per_step:
            sps = timer.rates()["steps_per_sec"]
            if sps > 0:
                tfs = self._flops_per_step * sps / 1e12
                # significant figures: a CPU run's 1e-5 TFLOP/s must not
                # round to 0.0
                out["model_tflops"] = float(f"{tfs:.4g}")
                out["mfu_nominal"] = float(
                    f"{tfs / NOMINAL_BF16_TFLOPS:.4g}")
        return out

    def _rollback(self, step: int) -> None:
        with obs_trace.span("rollback", step=step):
            restored = self.ckpt.restore(self.state)
        if restored is None:
            raise FloatingPointError(
                f"divergence at step {step} and no restorable checkpoint "
                f"under {self.ckpt.directory} to roll back to (none written "
                "yet, or every candidate failed verification)")
        self.logger.log("warn", step,
                        message=f"divergence at step {step}; rolled back to "
                                f"step {self.state.step}")
