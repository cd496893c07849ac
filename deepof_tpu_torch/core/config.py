"""Experiment configuration: the subset of `deepof_tpu/core/config.py`
that the PyTorch serving and training paths read, with its presets.

Field names and defaults are those of the JAX package, so a config dict
written by `dataclasses.asdict` of a `deepof_tpu` config loads here
through `config_from_dict`. Keys this package does not read are ignored
and named in one warning, so a full JAX config JSON loads without error:
the compile cache's two keys, which drive XLA's persistent cache (the
port's kernels are libraries built once under a hash of their sources).
The mesh (`parallel/mesh.py`), the elastic pool (`train/elastic.py`) and
the metrics port are carried. Settings that change what the training
path computes are carried; `check_trainable` raises on values that no
model can honour, and `raise_unported` names the ROADMAP item of a
setting not ported yet (`mesh.spatial` or `mesh.time` > 1 where they
would shard rows or pairs in the elastic pool:
`parallel/spatial.py::check_context_parallel`).
"""

from __future__ import annotations

import dataclasses
import typing
import warnings
from dataclasses import dataclass, field
from typing import Any

from ..resilience.faults import FaultConfig


@dataclass(frozen=True)
class LossConfig:
    """Unsupervised pyramid-loss hyper-parameters (the JAX package's
    `LossConfig`, every field and default)."""

    epsilon: float = 1e-4
    alpha_c: float = 0.25
    alpha_s: float = 0.37
    lambda_smooth: float = 1.0
    # per-scale loss weights, finest (pr1) first
    weights: tuple[float, ...] = (16.0, 8.0, 4.0, 2.0, 1.0, 1.0)
    smoothness: str = "canonical"  # canonical | depthwise
    smoothness_order: int = 1  # 1: first differences, 2: second
    edge_aware: bool = False
    edge_aware_photo: bool = False
    smooth_scaled_flow: bool = True
    border_ratio: float = 0.1
    # A TPU routing switch in the JAX package ("xla" | "pallas" |
    # "auto"). Here every one of the three takes the CUDA kernel for a
    # CUDA tensor (or raises) and the plain version for a CPU tensor; for
    # a bf16 warp operand it picks the JAX route's rounding per level
    # (ops/warp.py::pallas_route; "auto" as on a TPU).
    warp_impl: str = "auto"
    gather_dtype: str = "float32"  # float32 | bfloat16 (the warped image)
    photometric: str = "charbonnier"  # charbonnier | census
    census_window: int = 7
    occlusion: bool = False
    occ_alpha: float = 0.01
    occ_beta: float = 0.5
    occ_penalty: float = 1.0


@dataclass(frozen=True)
class OptimConfig:
    """Adam + stepwise learning-rate decay (the JAX `OptimConfig`)."""

    learning_rate: float = 1.6e-5
    decay_factor: float = 0.5
    epochs_per_decay: int = 18
    beta1: float = 0.9
    beta2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float | None = None
    # micro-batches per optimizer update (optax.MultiSteps semantics:
    # the running mean of the micro-gradients, clipped and applied at
    # every grad_accum-th applied micro-step; train/state.py)
    grad_accum: int = 1


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "flyingchairs"  # flyingchairs | sintel | ucf101 | synthetic
    data_path: str = ""
    image_size: tuple[int, int] = (384, 512)  # (H, W) network input
    gt_size: tuple[int, int] = (384, 512)  # native ground-truth resolution
    batch_size: int = 4
    time_step: int = 2  # frames per sample; Sintel volumes use 10
    sintel_pass: str = "final"  # clean | final
    # Gen-1 Sintel pair-mode split: path to Sintel_train_val.txt, one
    # line per consecutive frame pair over sorted clips x sorted frames
    # ("1" = train, "2" = val). Requires time_step=2; None keeps the
    # window-membership split.
    sintel_pair_split_file: str | None = None
    # dual-stream augmentation on the device (data/augmentation.py): the
    # geometric pair feeds the loss, the photometric one the network
    augment_geo: bool = False
    augment_photo: bool = False
    crop_size: tuple[int, int] | None = None
    # batches staged on the device ahead of the step (data/prefetch.py)
    prefetch: int = 2
    # input-pipeline worker threads (data/pipeline.py); 0 = draw inline
    # on the prefetch thread, -1 = auto. The stream is bit-identical for
    # any value.
    num_workers: int = 0
    # batches the workers may run ahead of delivery; 0 = 2 x num_workers
    reorder_depth: int = 0
    # byte-bounded LRU of decoded native-resolution images
    cache_decoded: bool = True
    cache_bytes: int = 4 << 30


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh's axes (`parallel/mesh.py`): a `torch.distributed`
    world of one device a rank laid out (data, spatial, time) as the JAX
    mesh; spatial shards each level's rows of FlowNet-S and FlowNet-C
    above the gate, time a volume's folded pairs (`parallel/
    spatial.py`)."""

    data: int = -1  # -1: every rank on the data axis
    spatial: int = 1  # spatial context-parallel shards of H
    time: int = 1  # temporal pair-parallel shards (Sintel T-1 pairs)


@dataclass(frozen=True)
class TrainConfig:
    num_epochs: int = 110
    log_every: int = 500
    eval_every: int = 5000  # steps; 0 = only at epoch end
    ckpt_every_epochs: int = 18
    ckpt_every_steps: int = 0  # 0 = epoch cadence only
    keep_ckpts: int = 3
    seed: int = 0
    log_dir: str = "/tmp/deepof_tpu"
    # eval protocol: finest flow is multiplied by `eval_amplifier`,
    # clipped to `eval_clip`, and resized to the native resolution
    eval_amplifier: float = 2.0
    eval_clip: tuple[float, float] = (-300.0, 250.0)
    eval_batch_size: int = 8
    # roll back to the last checkpoint on divergence; never save a
    # non-finite state
    nan_guard: bool = True
    # write flow-colour, reconstruction and ground-truth PNGs of the
    # first val batch of each eval under <log_dir>/visuals
    dump_visuals: bool = False
    # another run's log_dir: on a fresh start, copy its parameters of
    # matching name and shape
    init_from: str = ""
    # the public vgg16_weights.npz: VGG16 trunk init on a fresh start
    vgg16_npz: str = ""
    # float32 | bfloat16: the model's convs, deconvs and cost volume
    # compute in it; parameters, gradients, Adam and checkpoints stay f32
    compute_dtype: str = "float32"
    # recompute the model forward in backward instead of keeping its
    # activations (torch.utils.checkpoint around the model only; the
    # loss and its warps stay outside). Same bits, more device work.
    remat: bool = False
    # train steps per call of the train step, over K stacked batches; the
    # log, eval and checkpoint cadences fire once per K-step stride, at
    # its end step
    steps_per_call: int = 1
    # Metric fetches in flight behind the dispatch (train/metrics_log.py
    # AsyncFetcher): the loop submits a call's metrics when a record,
    # eval or checkpoint is due and keeps dispatching; submit blocks at
    # this many fetches not yet done. 0 = fetch inline (SyncFetcher).
    pipeline_depth: int = 2


@dataclass(frozen=True)
class SessionConfig:
    """Streaming video sessions (`serve/session.py`), the JAX package's
    `SessionConfig`, every field and default: a bounded per-session cache
    of the last frame's preprocessed half-row, so `submit_next` forms the
    (prev, next) pair from one new frame."""

    # LRU bound on live sessions; the oldest past it is evicted with a
    # tombstone (its next use is a structured `session_expired`)
    max_sessions: int = 256
    # idle TTL, enforced on access and by the sweeper; <= 0 disables it
    ttl_s: float = 120.0
    # sweeper-thread cadence; <= 0: TTL only on access
    sweep_s: float = 5.0
    # a step with a prior flow goes through the refinement-only stage
    # (`models/flownet2.py::FlowNetRefine`) instead of the cold network
    warm_start: bool = False
    # width of that stage relative to the served model's (flownet_cs
    # reuses its own full-width refinement stage and ignores this)
    warm_width: float = 0.5


@dataclass(frozen=True)
class FleetConfig:
    """The serving fleet (`serve/fleet.py`, `serve/router.py`,
    `serve/autoscale.py`): N supervised replica processes behind a
    health-gated router, the JAX package's `FleetConfig` with every
    key. The supervisor evicts stale or wedged
    replicas (SIGTERM then SIGKILL), respawns with exponential backoff,
    and stops respawning a crash-looping replica (circuit breaker); the
    router keeps each (bucket, tier) on one replica, replays failed
    requests on healthy siblings, and sheds load with structured 503s
    when every replica is saturated; the autoscaler sizes the pool."""

    # replica count behind the router; 0/1 = single-process serve (the
    # `serve --replicas N` flag overrides this)
    replicas: int = 0
    # supervisor health-poll cadence
    poll_s: float = 1.0
    # a READY replica whose heartbeat.json is older than this is evicted
    # (the serve heartbeat rewrites every obs.heartbeat_period_s, so
    # size this to several periods)
    stale_after_s: float = 15.0
    # supervisor-side stall detector, independent of the replica's OWN
    # wedge watchdog (which arms only after 3 completed flushes — a
    # dispatch that hangs on flush 1 or 2 would otherwise keep a fresh,
    # never-wedged heartbeat forever): evict a replica whose heartbeat
    # shows requests in flight but no completion for this long. Safe
    # against cold-start false positives because engine.warm() runs
    # every (bucket, tier) pair BEFORE the replica announces (the
    # kernels built, cuDNN's first calls made), so a dispatch slower
    # than this is a hang, not a warm-up. Must exceed the worst-case
    # honest dispatch time; 0 disables.
    stall_after_s: float = 60.0
    # how long an announced replica may take to start listening before
    # the spawn is declared failed (covers the torch import, the CUDA
    # context, the checkpoint restore and engine.warm())
    spawn_timeout_s: float = 180.0
    # eviction: SIGTERM first (graceful drain), SIGKILL after this grace
    term_grace_s: float = 5.0
    # respawn backoff: backoff_s * 2^(consecutive fast failures), capped
    backoff_s: float = 0.5
    backoff_max_s: float = 30.0
    # circuit breaker: this many CONSECUTIVE fast failures (died within
    # healthy_after_s of becoming ready, or never became ready) stops
    # respawning the replica — a crash loop burns backoff forever and
    # masks the real defect; surviving replicas keep serving
    crash_loop_threshold: int = 3
    # alive this long after ready resets the fast-failure counter
    healthy_after_s: float = 5.0
    # failover: how many times ONE request may be replayed on a
    # different replica after a transport error / replica 5xx (requests
    # are pure, so replay is idempotent by construction)
    failover_retries: int = 2
    # router-side per-replica in-flight cap: when EVERY healthy replica
    # is at this bound the request is shed with a structured 503
    # instead of queuing unboundedly at the router
    max_in_flight: int = 32
    # per-replica in-flight level above which the router spills a
    # request past its affinity replica to the next healthy one.
    # 0 = auto (serve.max_batch): below one full batch the affinity
    # replica keeps its executables hot; above it, spreading wins.
    spill_in_flight: int = 0
    # per-attempt proxy timeout (a wedged replica's request times out
    # here and replays on a sibling; the watchdog/evictor handles the
    # replica itself)
    proxy_timeout_s: float = 30.0
    # graceful shutdown: stop admission, wait this long for in-flight
    # requests to flush before reaping replicas
    drain_timeout_s: float = 10.0
    # --- SLO-driven autoscaler (serve/autoscale.py): the fixed
    # `--replicas N` pool becomes a load-follower between min_replicas
    # and max_replicas, scaling up on sustained shed/overload, SLO
    # breach burn, or near-saturation occupancy, and down on sustained
    # idle — always via graceful drain (retire, never evict: evictions
    # stay about sickness). Hysteresis lives in the threshold gap (up_occupancy >>
    # down_occupancy) + the sustain windows; the cooldowns keep the
    # boot cost of a fresh replica from flapping the pool.
    autoscale: bool = False
    # pool bounds: the autoscaler owns the size between these
    min_replicas: int = 1
    max_replicas: int = 4
    # control-loop evaluation cadence
    autoscale_period_s: float = 1.0
    # scale up only after pressure (shed/overload delta, SLO breach
    # burn, occupancy >= up threshold) persists this long
    autoscale_up_after_s: float = 2.0
    # scale down only after idleness (occupancy <= down threshold AND
    # zero shed) persists this long — much longer than the up window:
    # adding capacity late sheds traffic, removing it late wastes a
    # replica
    autoscale_down_after_s: float = 20.0
    # pool occupancy (router in-flight / (ready * max_in_flight)) at or
    # above which a tick counts as pressure
    autoscale_up_occupancy: float = 0.75
    # occupancy at or below which a tick counts as idle; the wide gap
    # to up_occupancy is the hysteresis band where the pool holds steady
    autoscale_down_occupancy: float = 0.15
    # SLO budget-burn fraction (obs.slo_latency_ms must be set) at or
    # above which NEW latency breaches count as pressure — capacity is
    # added while the budget still has headroom, not after exhaustion
    autoscale_up_slo_burn: float = 0.5
    # Predictive pressure: requests/s GROWTH (req/s per
    # second, least-squares slope over the router's per-second
    # completion buckets) at or above this counts a tick as pressure —
    # the pool scales on the load *trend*, before occupancy saturates
    # or the first shed lands. The same up_after_s sustain window and
    # cooldowns apply, so one noisy second never spawns a replica.
    # <= 0 disables the slope signal (reactive only).
    autoscale_up_slope: float = 0.0
    # no second scale-up within this window of the previous one: a
    # burst must not spawn the whole ladder before the first new
    # replica has even booted
    autoscale_up_cooldown_s: float = 5.0
    # no scale-down within this window of ANY scale event: a fresh
    # replica's warm-up idle must not immediately retire its sibling
    autoscale_down_cooldown_s: float = 30.0
    # the artifact store's sweep at a replica's retirement and at the
    # fleet's close (`serve/artifacts.py::gc_store`): corrupt entries and
    # orphaned staging always go; entries older than this many days go
    # too unless pinned (the index's targets and every fingerprint of a
    # replica's ledger). <= 0: no age sweep
    artifacts_gc_days: float = 0.0


@dataclass(frozen=True)
class DegradeConfig:
    """The brownout controller (`serve/degrade.py`), the JAX package's
    `DegradeConfig`, every field and default: under overload the fleet
    walks L0 normal -> L1 the default tier served at the cheapest tier
    of `serve.precisions` -> L2 also one bucket down the ladder -> L3
    also low-priority requests shed at the router, and walks back when
    the load is calm. `engine.warm()` runs every (bucket, tier) pair
    before a replica announces, so no level change builds anything."""

    # master switch: off runs no controller thread (level pinned 0)
    enabled: bool = False
    # control-loop cadence — deliberately faster than
    # fleet.autoscale_period_s: degradation is the instant response,
    # capacity the slow one
    period_s: float = 0.25
    # escalate one level only after pressure (new shed/unavailable
    # rejections, occupancy >= up_occupancy, or SLO burn >=
    # up_slo_burn) persists this long
    escalate_after_s: float = 0.5
    # recover one level only after calm (zero new rejections AND
    # occupancy <= down_occupancy AND burn < up_slo_burn) persists
    # this long — much longer than the escalate window: degrading too
    # late sheds work, recovering too early flaps quality
    recover_after_s: float = 3.0
    # no second escalation within this window of the previous one (a
    # burst must not slam L0 -> L3 before L1's relief is even visible)
    escalate_cooldown_s: float = 0.5
    # no recovery within this window of ANY level transition
    recover_cooldown_s: float = 2.0
    # pool occupancy (router in-flight / (ready * fleet.max_in_flight))
    # at or above which a tick counts as pressure — the queue-depth
    # face of the verdict (router in-flight IS the fleet-wide queue)
    up_occupancy: float = 0.85
    # occupancy at or below which a tick can count as calm; the gap to
    # up_occupancy is the hysteresis band where the level holds
    down_occupancy: float = 0.5
    # SLO error-budget burn fraction (obs.slo_latency_ms must be set
    # for the signal to exist) at or above which a tick is pressure
    up_slo_burn: float = 0.7
    # highest level the controller may reach (3 = full ladder; 2 keeps
    # low-priority traffic admitted however hot the fleet runs)
    max_level: int = 3
    # the stats' degrade_l3_sustained turns true once the fleet has sat
    # at L3 continuously for at least this long — brownout as a steady
    # state means capacity never arrived
    l3_sustained_s: float = 30.0


@dataclass(frozen=True)
class ServeConfig:
    # Dynamic micro-batcher: up to max_batch pairs per forward; a partial
    # batch flushes when the oldest pending request has waited
    # batch_timeout_ms. Every dispatch is padded to exactly max_batch rows.
    max_batch: int = 8
    batch_timeout_ms: float = 10.0
    # (H, W) network-input buckets; () = one bucket at data.image_size.
    buckets: tuple[tuple[int, int], ...] = ()
    # Weight-precision tiers (`serve/quant.py`): an ordered subset of
    # ("f32", "bf16", "int8"); the first is the default tier.
    precisions: tuple[str, ...] = ("f32",)
    # submit() blocks when this many requests are pending. 0 = unbounded.
    queue_depth: int = 256
    # the HTTP server (`serve/server.py`): its address (port 0 = any free
    # port), and the longest a handler waits for a response
    host: str = "127.0.0.1"
    port: int = 8191
    request_timeout_s: float = 30.0
    # offline mode's decode workers (data/pipeline.py); 0 = inline
    workers: int = 0
    # a timed stand-in for the model (`serve/engine.py::
    # make_fake_forward`), in ms a dispatch: None serves the model
    fake_exec_ms: float | None = None
    # the artifact store (`serve/artifacts.py`): the CUDA libraries of
    # each lattice executable under its ledger fingerprint, and the
    # trace-free index. `warmup --serve` publishes into it (the single
    # writer); an engine fetches its libraries from it before building
    # and resolves its lattice through the index. "" = off (every
    # process builds and traces). The path rides a fleet replica's
    # config, made absolute by the supervisor.
    artifacts_dir: str = ""
    # resolve each lattice entry through the store's index.json, with no
    # trace (a miss or reject takes the traced path). No effect when
    # artifacts_dir is empty.
    artifacts_index: bool = True
    # after serving starts, re-trace each index-resolved entry and compare
    # its fingerprint with the index's; a mismatch is demoted
    # (exec_deep_verify_demoted, a warning and a warn record)
    artifacts_deep_verify: bool = True
    # the deep verify's pacing: one entry a tick of this many seconds,
    # run on the batcher between batches. 0 = no stagger
    deep_verify_interval_s: float = 0.05
    session: SessionConfig = field(default_factory=SessionConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    degrade: DegradeConfig = field(default_factory=DegradeConfig)


@dataclass(frozen=True)
class ResilienceConfig:
    # bounded retries per sample draw, then quarantine and a
    # deterministic substitute (resilience/healing.py)
    data_retries: int = 2
    data_backoff_s: float = 0.05
    data_substitutes: int = 3
    # re-attempts of a failed batch assembly on a pipeline worker
    pipeline_retries: int = 1
    # re-attempts of a failed read of a step's metrics to the host
    fetch_retries: int = 2
    # skip an update whose loss or gradient norm is not finite: the
    # parameters, the Adam moments and the step stay as they were
    skip_nonfinite: bool = True
    # roll back to the last checkpoint after this many skips in a row
    max_consecutive_skips: int = 5
    # check each checkpoint against its manifest on restore, and fall
    # back to the newest one that verifies
    verify_checkpoints: bool = True
    faults: FaultConfig = field(default_factory=FaultConfig)


@dataclass(frozen=True)
class ObsConfig:
    """The JAX package's `ObsConfig` (`obs/`): the span trace, the
    heartbeat with its wedge watchdog, the FLOPs telemetry, the
    executable ledger (`obs/ledger.py`), the serving SLO
    (`serve/engine.py`), label-free quality scoring (`obs/quality.py`),
    the incident plane (`obs/incident.py`) and the elastic
    coordinator's metrics port."""

    # write a Chrome trace-event timeline to <log_dir>/trace.json
    trace: bool = False
    # spans kept (the newest win)
    trace_ring: int = 16384
    # <log_dir>/heartbeat.json rewritten every heartbeat_period_s
    heartbeat: bool = True
    heartbeat_period_s: float = 5.0
    # a wedge: no step within watchdog_factor x the median recent step
    # time, and at least watchdog_min_s; thread stacks go to the log
    watchdog_factor: float = 20.0
    watchdog_min_s: float = 60.0
    # count the FLOPs of the first step (FlopCounterMode): train records
    # then carry model_tflops and mfu_nominal
    flops: bool = True
    # the executable ledger (obs/ledger.py): the first call of each
    # executable (train step, eval step, each served bucket x tier x
    # mode, the quality scorer) appends a row (op-trace fingerprint,
    # first-call seconds, libraries built or found, FLOPs, bytes, memory)
    # to <log_dir>/ledger.jsonl, and the exec_* block rides the heartbeat
    # and the stats; `tail --ledger-baseline` turns the rows into rc 8
    ledger: bool = True
    # the serving SLO (obs/export.py): requests slower than this (rounded
    # up to a histogram bucket bound) breach it, and breaches plus
    # server-side failures burn the error budget; 0 disables it
    slo_latency_ms: float = 0.0
    # the allowed bad fraction; burn = bad fraction / budget
    slo_error_budget: float = 0.01
    # a GET /metrics + /healthz endpoint (obs/export.py) on the elastic
    # coordinator (train/elastic.py): None = off, 0 = an ephemeral port
    # (announced on stdout), > 0 = that port
    metrics_port: int | None = None
    # label-free quality scoring of served requests (obs/quality.py):
    # the sampled fraction (0: off, nothing built), the sampler's seed,
    # the scorer queue's bound (full: the sample is dropped and counted)
    quality_sample_rate: float = 0.0
    quality_seed: int = 0
    quality_queue_depth: int = 128
    # the drift verdict: the first quality_ref_samples scores freeze a
    # reference median photo proxy; later, a sample above ref_p50 *
    # quality_drift_factor is a breach, and breaches over post-reference
    # samples burn quality_budget; quality_window bounds the current p50
    quality_ref_samples: int = 64
    quality_window: int = 256
    quality_drift_factor: float = 2.0
    quality_budget: float = 0.1
    # the incident plane (obs/incident.py): bundles of evidence under
    # <log_dir>/incidents/ when a verdict fires; false: no recorder
    incidents: bool = False
    # a token bucket over all kinds: burst, refilled at rate_per_min
    incident_rate_per_min: float = 6.0
    incident_burst: int = 3
    # a kind that captured within this window is counted, not captured
    incident_dedup_window_s: float = 300.0
    # a bundle's metrics lines, heartbeat samples, and the committed
    # bundles kept (the oldest pruned at capture)
    incident_metrics_tail: int = 200
    incident_heartbeats: int = 8
    incident_keep: int = 32
    # declarative alert rules on the heartbeat's cadence over registered
    # keys: "[name:] [rate(]counter[)] OP value [warn|critical]"
    alerts: tuple[str, ...] = ()


@dataclass(frozen=True)
class MixtureMemberConfig:
    """One weighted member of a stage's dataset mixture (data/mixture.py;
    the JAX package's, every field and default).

    Empty/zero fields inherit the stage-resolved DataConfig, so a member
    usually names only its dataset and weight. All members of a stage
    must agree on per-sample structure (shape, dtype, implied
    time_step), checked when the mixture is built, naming the stage."""

    dataset: str = "synthetic"  # flyingchairs | sintel | ucf101 | synthetic
    weight: float = 1.0
    data_path: str = ""  # "" = the stage's data.data_path
    sintel_pass: str = ""  # "" = the stage's data.sintel_pass
    time_step: int = 0  # 0 = the stage's data.time_step


@dataclass(frozen=True)
class StageConfig:
    """One stage of a training recipe (train/recipe.py; the JAX
    package's): a weighted dataset mixture plus per-stage overrides of
    the base config and an advance condition. Sentinel values (None / 0
    / empty) inherit the base ExperimentConfig, so a stage names only
    what it changes."""

    name: str = "stage"
    # weighted dataset mixture; () = the base config's single dataset
    mixture: tuple[MixtureMemberConfig, ...] = ()
    # --- per-stage config overrides (sentinels inherit the base) ---
    image_size: tuple[int, int] | None = None
    gt_size: tuple[int, int] | None = None
    crop_size: tuple[int, int] | None = None
    time_step: int = 0
    batch_size: int = 0
    model: str = ""  # e.g. the UCF-101 action stage swaps in st_single
    loss_weights: tuple[float, ...] = ()
    learning_rate: float = 0.0  # this stage's lr-schedule segment base
    # --- advance condition ---
    # "steps": advance after exactly `steps` optimizer steps.
    # "plateau": advance when the stage's eval-AEE trend (analyze.py
    #   eval_trend over this stage's evals) has flattened — slope >=
    #   -plateau_slope AEE per 1000 steps over plateau_window evals —
    #   with `steps` (when > 0) as a hard step budget backstop.
    advance: str = "steps"
    steps: int = 0  # 0 = unbounded (terminal stage / plateau-only)
    plateau_window: int = 8
    plateau_slope: float = 0.01  # flat when slope >= -this (AEE/kstep)
    min_evals: int = 3  # plateau needs at least this many stage evals


@dataclass(frozen=True)
class RecipeConfig:
    """Staged training recipe (train/recipe.py; the JAX package's): an
    ordered list of stages, each with a deterministic weighted dataset
    mixture, per-stage shape/time_step/loss/lr overrides, and a
    fixed-step or EPE-plateau advance condition. The active stage index
    rides the checkpoint manifest, so a resume lands in the right stage.
    `warmup` builds every remaining stage's dataset and every CUDA
    library before step 1, so a stage switch builds nothing
    (`train/recipe.py::prebuild_stages`)."""

    enabled: bool = False
    stages: tuple[StageConfig, ...] = ()
    # build every stage's dataset and the kernels at recipe start;
    # False = each stage builds its own as it starts
    warmup: bool = True
    # eval cadence driving the plateau trigger rides the per-stage
    # train.eval_every; this caps how many stage evals the trigger
    # retains (bounded memory on very long stages)
    max_trigger_evals: int = 512


@dataclass(frozen=True)
class ElasticConfig:
    """The elastic trainer pool (`train/elastic.py`), the JAX package's
    fields and defaults: a stdlib coordinator supervises N single-host
    trainer processes and survives the loss or preemption of a host. On
    a lost or wedged host it bumps the generation: the survivors stop at
    a barrier (SIGTERM: a verified checkpoint and exit 0), the world
    re-forms on them (each host's data stream re-seeded with the world
    size and the generation), and each resumes from the newest valid
    checkpoint of the shared directory.

    Two roles share it: the coordinator (`train --elastic N`, or
    ``hosts`` > 1 with ``host_index`` < 0) and the trainer children it
    spawns (``host_index`` >= 0), whose config the coordinator writes to
    <log_dir>/host-<i>/config.json."""

    # coordinator world size; 0/1 = plain single-process training (the
    # `train --elastic N` flag overrides it)
    hosts: int = 0
    # abort instead of re-forming below this many surviving hosts
    min_hosts: int = 1
    # --- a child's identity (written by the coordinator) ---
    host_index: int = -1
    num_hosts: int = 0  # the generation's world size
    generation: int = 0
    # the host that writes the shared checkpoints this generation (the
    # lowest survivor); every host restores from them
    primary_host: int = 0
    # the absolute global step the run trains to (`--max-steps` of
    # `train --elastic N`): a respawned trainer stops where the run ends
    target_step: int = 0
    # the shared checkpoint directory ("" = <log_dir>/ckpt)
    ckpt_dir: str = ""
    # step-skew limiter: a host waits (touching its heartbeat) while it
    # is more than this many steps ahead of the slowest live host, the
    # floor the coordinator publishes to `world_file`; 0 disables
    sync_ahead: int = 4
    world_file: str = ""
    # JAX's count of virtual CPU devices a CPU child shards its batch
    # over (which changes no result): carried, read nowhere. The
    # children train on the coordinator's `--device`
    virtual_devices: int = 1
    # --- the coordinator's supervision ---
    poll_s: float = 0.5
    # a heartbeat.json older than this is a lost host
    stale_after_s: float = 15.0
    # a fresh heartbeat with >= 1 step and no progress for this long is
    # a wedged host (0 disables)
    wedge_after_s: float = 45.0
    # seconds a spawned trainer may take to its first heartbeat
    spawn_timeout_s: float = 300.0
    # seconds the survivors get to save and exit after the barrier's
    # SIGTERM before SIGKILL
    barrier_timeout_s: float = 120.0
    term_grace_s: float = 10.0
    # give up after this many re-forms
    max_reforms: int = 16


@dataclass(frozen=True)
class ExperimentConfig:
    name: str = "flyingchairs_flownet_s"
    model: str = "flownet_s"  # flownet_s | flownet_c | flownet_cs here
    width_mult: float = 1.0
    # FlowNet-C correlation geometry (FlowNet paper: 441 displacements)
    corr_max_disp: int = 20
    corr_stride: int = 2
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    resilience: ResilienceConfig = field(default_factory=ResilienceConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    recipe: RecipeConfig = field(default_factory=RecipeConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)

    def replace(self, **kw: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# --- Presets: the JAX package's reference baselines, as they are ---

FLYINGCHAIRS = ExperimentConfig(
    name="flyingchairs_inception",
    model="inception_v3",
    loss=LossConfig(epsilon=1e-4, alpha_c=0.25, alpha_s=0.37,
                    lambda_smooth=1.0, weights=(16, 8, 4, 2, 1, 1)),
    optim=OptimConfig(learning_rate=1.6e-5, epochs_per_decay=18),
    data=DataConfig(dataset="flyingchairs", image_size=(320, 448),
                    gt_size=(384, 512), batch_size=4),
    train=TrainConfig(num_epochs=110, ckpt_every_epochs=18,
                      eval_amplifier=2.0, eval_clip=(-300.0, 250.0)),
)

FLYINGCHAIRS_VGG = ExperimentConfig(
    name="flyingchairs_vgg",
    model="vgg16",
    loss=LossConfig(epsilon=1e-4, alpha_c=0.25, alpha_s=0.37,
                    lambda_smooth=1.0, weights=(16, 8, 4, 2, 1),
                    smoothness="depthwise"),
    optim=OptimConfig(learning_rate=1.6e-5, epochs_per_decay=18),
    data=DataConfig(dataset="flyingchairs", image_size=(320, 448),
                    gt_size=(384, 512), batch_size=8,
                    augment_geo=True, augment_photo=True),
    train=TrainConfig(num_epochs=110, eval_amplifier=2.0,
                      eval_clip=(-204.4790, 201.3478)),
)

SINTEL = ExperimentConfig(
    name="sintel_inception_multiframe",
    model="inception_v3",
    loss=LossConfig(epsilon=1e-4, alpha_c=0.3, alpha_s=0.3,
                    lambda_smooth=0.0, weights=(16, 8, 4, 4, 2, 1)),
    optim=OptimConfig(learning_rate=1.6e-5, epochs_per_decay=60),
    data=DataConfig(dataset="sintel", image_size=(256, 512),
                    gt_size=(436, 1024), crop_size=(224, 480), batch_size=4,
                    time_step=10),
    train=TrainConfig(num_epochs=400, ckpt_every_epochs=30,
                      eval_amplifier=3.0, eval_clip=(-420.621, 426.311)),
)

UCF101 = ExperimentConfig(
    name="ucf101_st_single",
    model="st_single",
    loss=LossConfig(epsilon=1e-4, alpha_c=0.25, alpha_s=0.37,
                    lambda_smooth=0.8, weights=(16, 8, 4, 2, 1)),
    optim=OptimConfig(learning_rate=1.6e-4, epochs_per_decay=50),
    data=DataConfig(dataset="ucf101", image_size=(320, 384),
                    gt_size=(320, 384), batch_size=8),
    train=TrainConfig(num_epochs=1000, eval_amplifier=1.0,
                      eval_clip=(-1e9, 1e9)),
)

# gen-1 per-model loss-weight alternates, selectable through
# LossConfig.weights overrides
GEN1_LOSS_WEIGHTS = {
    "vgg16": (7.0, 5.0, 3.0, 3.0, 1.0),
    "flownet_s": (9.0, 7.0, 5.0, 3.0, 3.0, 1.0),
    "inception_v3": (9.0, 7.0, 5.0, 3.0, 3.0, 1.0),
}

PRESETS: dict[str, ExperimentConfig] = {
    "flyingchairs": FLYINGCHAIRS,
    "flyingchairs_vgg": FLYINGCHAIRS_VGG,
    "sintel": SINTEL,
    "ucf101": UCF101,
}


def get_config(name: str, **overrides: Any) -> ExperimentConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg


def _tupleize(value: Any) -> Any:
    if isinstance(value, list):
        return tuple(_tupleize(v) for v in value)
    return value


def _from_dict(cls: type, d: dict, path: str,
               ignored: list[str] | None) -> Any:
    """dict -> `cls`. Unknown keys are appended to `ignored`, or raise
    ValueError naming their path when `ignored` is None (strict)."""
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - names)
    if unknown and ignored is None:
        raise ValueError(f"config_from_dict: unknown field(s) {unknown} in "
                         f"{path.rstrip('.') or cls.__name__}")
    if unknown:
        ignored.extend(f"{path}{k}" for k in unknown)
    kwargs: dict[str, Any] = {}
    for name in names & set(d):
        value = d[name]
        hint = hints[name]
        if dataclasses.is_dataclass(hint) and isinstance(value, dict):
            value = _from_dict(hint, value, f"{path}{name}.", ignored)
        elif (typing.get_origin(hint) is tuple and typing.get_args(hint)
              and dataclasses.is_dataclass(typing.get_args(hint)[0])
              and isinstance(value, (list, tuple))):
            # tuple-of-dataclass fields (recipe.stages, stage.mixture):
            # each element recurses with an indexed path, so an unknown
            # key names the exact offending entry
            elem = typing.get_args(hint)[0]
            value = tuple(
                _from_dict(elem, v, f"{path}{name}[{i}].", ignored)
                if isinstance(v, dict) else _tupleize(v)
                for i, v in enumerate(value))
        else:
            value = _tupleize(value)
        kwargs[name] = value
    return cls(**kwargs)


def config_from_dict(d: dict) -> ExperimentConfig:
    """Nested dict (e.g. a `deepof_tpu` config JSON) -> ExperimentConfig.

    Missing keys keep their defaults; keys this package does not read are
    dropped and listed in one UserWarning."""
    ignored: list[str] = []
    cfg = _from_dict(ExperimentConfig, d, "", ignored)
    if ignored:
        warnings.warn(f"config_from_dict: ignored keys not read by "
                      f"deepof_tpu_torch: {ignored}", stacklevel=2)
    return cfg


def recipe_from_dict(d: dict) -> RecipeConfig:
    """Strict dict -> RecipeConfig for the `train --recipe FILE` payload
    (train/recipe.py), as the JAX package's: an unknown key at any level
    raises ValueError with its indexed path (`recipe.stages[1]`,
    `recipe.stages[0].mixture[1]`), never a silently defaulted field."""
    return _from_dict(RecipeConfig, d, "recipe.", None)


#: the UCF-101 action models: trained with their class, evaluated by
#: accuracy (`train/evaluate.py::evaluate_ucf101`), not served
ACTION_MODELS = ("st_single", "st_baseline", "ucf101_spatial")
#: values of `LossConfig.warp_impl` (see the field's comment)
WARP_IMPLS = ("auto", "xla", "pallas")
#: values of `TrainConfig.compute_dtype`
COMPUTE_DTYPES = ("float32", "bfloat16")


def raise_unported(todo: list[tuple[str, str]]) -> None:
    """todo: (setting, ROADMAP Queue A item that ports it)."""
    if todo:
        raise NotImplementedError(
            "not ported to deepof_tpu_torch yet: " + "; ".join(
                f"{what}: ROADMAP Queue A item {item}" for what, item in todo))


def check_servable(cfg: ExperimentConfig) -> None:
    """Raise ValueError on an action model (the engine serves flow, and
    the JAX engine fails on their (flows, logits) output with a
    TypeError; `predict --action` classifies). Every serving setting is
    ported."""
    if cfg.model in ACTION_MODELS:
        raise ValueError(
            f"model {cfg.model!r} has an action head: the serving engine "
            "serves flow models only; classify frame pairs with "
            "`predict --action`")


def check_loss(cfg: LossConfig) -> None:
    """Raise ValueError on a loss setting of no known value."""
    if cfg.gather_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown loss.gather_dtype {cfg.gather_dtype!r}; "
                         "use 'float32' or 'bfloat16'")
    if cfg.warp_impl not in WARP_IMPLS:
        raise ValueError(f"unknown loss.warp_impl {cfg.warp_impl!r}; "
                         f"one of {WARP_IMPLS}")
    if cfg.smoothness_order not in (1, 2):
        raise ValueError(
            f"unknown loss.smoothness_order {cfg.smoothness_order!r}")


def check_trainable(cfg: ExperimentConfig) -> None:
    """Raise ValueError on a setting that the training path cannot
    honour (a two-frame model on a volume, an unknown dtype or loss
    option)."""
    if cfg.data.time_step != 2 and cfg.model in ("flownet_c", "flownet_cs"):
        # the JAX package breaks there too: FlowNetC's siamese conv1 is
        # built for one 3-channel frame (flax ScopeParamShapeError at
        # init), FlowNetCS raises ValueError
        raise ValueError(
            f"model {cfg.model!r} is a two-frame model (one 3-channel frame "
            f"a branch); data.time_step={cfg.data.time_step} gives a "
            f"{3 * cfg.data.time_step}-channel volume. Multi-frame volumes "
            "train flownet_s or inception_v3")
    if cfg.train.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"unknown train.compute_dtype "
                         f"{cfg.train.compute_dtype!r}; one of "
                         f"{COMPUTE_DTYPES}")
    check_loss(cfg.loss)
