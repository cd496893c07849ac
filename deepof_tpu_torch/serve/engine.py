"""InferenceEngine: a dynamic micro-batching flow-inference engine (port
of `deepof_tpu/serve/engine.py`: precision tiers, streaming sessions and
temporal warm start).

  submit() threads enqueue preprocessed requests -> a single batcher
  thread coalesces the queue into one batched forward per flush (up to
  `serve.max_batch` pairs, or whatever arrived within
  `serve.batch_timeout_ms` of the oldest pending request) -> per-request
  futures resolve with postprocessed native-resolution flow.

Design decisions kept from the JAX engine:

  - Every dispatch is padded to exactly max_batch rows (zeros beyond the
    live occupancy, outputs sliced), so one bucket runs one input shape
    and a response does not depend on which batch it rode in.
  - Decode/preprocess runs on the submitting thread: a bad input fails
    that one future with a structured ServeError before it reaches the
    batcher.
  - A failure inside the batched forward fails that flush's requests
    (`dispatch_failed`) and the batcher keeps serving; a per-request
    postprocess failure fails only that request.
  - Precision tiers (`serve/quant.py`): one module per tier of
    `serve.precisions`, built once at construction; a request names its
    tier (`precision=`) or gets the first. A tier the engine does not
    serve fails that request with `bad_request`.
  - A request's key is (bucket, tier, mode), mode "cold" (the served
    model) or "warm" (the refinement stage); a flush never mixes keys.
  - Streaming sessions (`serve/session.py`, `submit_next`): the first
    frame primes, each later frame pairs with the cached previous one.
    With `serve.session.warm_start`, a step whose session holds a prior
    flow (the previous step's raw output) runs `FlowNetRefine` on
    (pair, prior) instead of the cold model; on the card that is the
    warp kernel once a dispatch and no correlation.
  - Deadlines: a request may carry the caller's remaining budget
    (`deadline_s`, the server's `X-Deadline-Ms`). It is checked while the
    request waits for a queue slot and again at the flush; an expired
    request fails with `deadline_exceeded` (HTTP 504) and takes no batch
    slot. The server's own wait is capped at the budget
    (`note_wait_expired`).
  - The brownout fold (`degrade_level`, the server's `X-Degrade-Level`):
    at level 1 and above a request that names no precision serves at the
    last configured tier; at 2 and above a pair serves one bucket down
    (not a stream step: a bucket change would re-prime its session).
  - `serve_server_errors` counts the failures that are the server's
    (dispatch, postprocess, shutdown), not a caller's bad input, expired
    session or lapsed deadline: the SLO's error budget burns on those.
  - Latency lives in fixed-bucket histograms (`obs/export.py`), one for
    every response and one for session steps; their p50/p99 are read off
    the buckets. With `obs.slo_latency_ms` > 0, `stats()` carries the SLO
    state (`serve_slo`).
  - `serve.fake_exec_ms` (or a `forward_fn`) replaces the model with a
    timed stand-in (`make_fake_forward`) and builds none: the batcher,
    the server and their tests run without a model.

The models run under `torch.inference_mode()` on the engine's device
(CUDA unless the caller passes another). Every tier computes in float32
(the bf16 tier upcasts its weights), so the engine turns TF32 off
(`core.device.disable_tf32`) whatever the config, as the command line
does. Spans `serve_enqueue`,
`serve_batch`, `serve_dispatch` and `serve_postprocess` (and
`session_prime` / `session_step` / `session_warm`) go to the installed
tracer (`obs/trace.py`). The brownout controller that sets the level
is `serve/degrade.py`, in the fleet. Still to port (ROADMAP): quality
scoring, the executable ledger and artifacts.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch
from torch import nn

from .. import native
from ..core.config import ExperimentConfig, check_servable
from ..core.device import disable_tf32, resolve_device
from ..data.datasets import DATASET_MEANS, _imread_bgr
from ..obs import trace as obs_trace
from ..obs.export import (LatencyHistogram, percentile_ms, slo_state,
                          validate_slo)
from .buckets import (flow_to_native, next_smaller_bucket, pick_bucket,
                      prepare_frame, prepare_pair, resolve_buckets)
from .quant import quantize_model, resolve_precisions
from .session import SessionExpired, SessionStore

_STOP = object()

#: Seconds of completion history behind the requests/s figure.
_RATE_WINDOW_S = 10.0

#: Serving is pair-based: every dispatch takes 6 input channels.
PAIR_CHANNELS = 6


class ServeError(RuntimeError):
    """Structured per-request failure: machine-readable `code` +
    message. Codes: bad_input (decode/preprocess), bad_request (a
    precision the engine does not serve), session_expired (the session
    was evicted or idled past its TTL; resend the frame to re-prime),
    dispatch_failed (the batched forward raised; the whole flush fails),
    postprocess_failed (one request's resize/rescale raised),
    engine_closed, deadline_exceeded (the caller's budget lapsed before
    dispatch)."""

    def __init__(self, code: str, message: str,
                 request_id: int | str | None = None):
        super().__init__(message)
        self.code = code
        self.request_id = request_id

    def payload(self) -> dict:
        out = {"error": self.code, "message": str(self)}
        if self.request_id is not None:
            out["request_id"] = self.request_id
        return out


#: codes that are the caller's, not the server's: they do not burn the
#: SLO's error budget (`serve_server_errors`)
CLIENT_CODES = ("bad_input", "bad_request", "session_expired",
                "deadline_exceeded")


class _Request:
    __slots__ = ("x", "bucket", "tier", "native_hw", "future", "t_enq",
                 "rid", "mode", "prior", "session", "frame_index", "epoch",
                 "deadline")

    def __init__(self, x, bucket, tier, native_hw, future, t_enq, rid,
                 mode="cold", prior=None, session=None, frame_index=None,
                 epoch=None, deadline=None):
        self.x = x
        self.bucket = bucket
        self.tier = tier
        self.native_hw = native_hw
        self.future = future
        self.t_enq = t_enq
        self.rid = rid
        self.mode = mode                # "cold" | "warm"
        self.prior = prior              # the session's flow (warm only)
        self.session = session          # session id, None off-session
        self.frame_index = frame_index
        self.epoch = epoch              # the session's prime generation
        self.deadline = deadline        # absolute monotonic expiry, or None

    @property
    def key(self) -> tuple[tuple[int, int], str, str]:
        """Requests batch together iff they share (bucket, tier, mode)."""
        return (self.bucket, self.tier, self.mode)


def build_serve_model(cfg: ExperimentConfig,
                      device: str | torch.device = "cuda") -> nn.Module:
    """The inference model for a config, initialised from
    `cfg.train.seed`, on `device`."""
    from ..models.registry import build_model

    t = cfg.data.time_step
    return build_model(cfg.model, flow_channels=2 * (t - 1),
                       width_mult=cfg.width_mult,
                       corr_max_disp=cfg.corr_max_disp,
                       corr_stride=cfg.corr_stride, seed=cfg.train.seed,
                       device=device)


def _nchw(a: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(device).permute(0, 3, 1, 2).contiguous()


def _device(model: nn.Module) -> torch.device:
    return next(iter((*model.parameters(), *model.buffers()))).device


def make_raw_forward(model: nn.Module) -> Callable[..., np.ndarray]:
    """pairs (B, H, W, 6) float32 numpy -> finest scaled flow (B, h, w, 2)
    float32 numpy, run on the model's device under inference_mode. Extra
    NHWC arrays go to the model after the pairs: the refinement stage's
    prior (B, h, w, 2) (`make_refine_forward`)."""
    device = _device(model)
    scale = model.flow_scales[0]

    def fwd(*arrays: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            flow = model(*(_nchw(a, device) for a in arrays))[0] * scale
            return flow.permute(0, 2, 3, 1).float().cpu().numpy()

    return fwd


#: (pairs, prior) -> the refinement stage's finest scaled flow: the warm
#: twin of `make_raw_forward`, the same function.
make_refine_forward = make_raw_forward


def make_fake_forward(exec_ms: float) -> Callable:
    """A timed stand-in for the model: (bucket, x) -> flow, sleeping
    `exec_ms` a dispatch whatever the batch, with the flow the channel
    differences of the pair (content-dependent, so equal outputs across
    runs are a real check). A copy of the JAX package's: numpy only, no
    model, no device."""

    def forward(bucket, x):
        time.sleep(max(exec_ms, 0.0) / 1e3)
        return np.stack([x[..., 0] - x[..., 3], x[..., 1] - x[..., 4]],
                        axis=-1).astype(np.float32)

    return forward


def build_refine_model(cfg: ExperimentConfig, model: nn.Module,
                       device: str | torch.device = "cuda") -> nn.Module:
    """The warm start's refinement stage for a config, on `device`:
    flownet_cs reuses the served model's own refinement stage
    (`FlowNetRefine(residual=False)` with `model.refine`'s weights); every
    other model gets a gated residual stage at `width_mult *
    serve.session.warm_width`, initialised by `refine_init_params` (the
    gate at 0: the identity on its prior, up to rounding)."""
    from ..models.flownet2 import FlowNetRefine

    if cfg.model == "flownet_cs":
        refine = FlowNetRefine(width_mult=1.0, residual=False)
        refine.refine.load_state_dict(model.refine.state_dict())
    else:
        refine = refine_init_params(cfg, FlowNetRefine(
            width_mult=cfg.width_mult * float(cfg.serve.session.warm_width),
            residual=True))
    return refine.to(resolve_device(device)).eval()


def refine_init_params(cfg: ExperimentConfig,
                       refine: nn.Module) -> nn.Module:
    """Initialise a CPU refinement stage in place from `cfg.train.seed`
    (a CPU `torch.Generator`, so every engine of a config gets the same
    bits on any device); returns it."""
    from ..models.common import init_weights

    return init_weights(refine, cfg.train.seed)


class InferenceEngine:
    """See module docstring.

    cfg: experiment config (serve.* drives the batcher; data/eval fields
        drive the preprocess/postprocess protocol).
    model: optional nn.Module with its weights (tests load converted
        flax weights); None builds `cfg.model` from `cfg.train.seed`.
    mean: optional BGR dataset mean override (DATASET_MEANS default).
    device: where the model runs; "cuda" by default, which raises on a
        host without a card.
    refine: optional warm-start refinement stage with its weights (tests
        load the JAX stage's); None builds `build_refine_model`. Read only
        under `serve.session.warm_start`.
    forward_fn: optional (bucket, x[max_batch, H, W, 6]) ->
        [max_batch, h, w, 2] executor in place of the model (none is
        built); `serve.fake_exec_ms` gives `make_fake_forward`'s. It is
        blind to the tier and the mode: every key batches apart but runs
        this one function.
    """

    def __init__(self, cfg: ExperimentConfig, model: nn.Module | None = None,
                 mean=None, device: str | torch.device = "cuda",
                 refine: nn.Module | None = None,
                 forward_fn: Callable | None = None):
        check_servable(cfg)
        self.device = resolve_device(device)
        disable_tf32()
        self.cfg = cfg
        self.max_batch = max(int(cfg.serve.max_batch), 1)
        self.timeout_s = max(float(cfg.serve.batch_timeout_ms), 0.0) / 1e3
        self.buckets = resolve_buckets(cfg)
        if float(cfg.obs.slo_latency_ms) > 0:
            validate_slo(cfg.obs)  # a target the buckets cannot measure
        self.tiers = resolve_precisions(cfg)
        self.default_tier = self.tiers[0]
        self.warm_start = bool(cfg.serve.session.warm_start)
        if mean is None:
            mean = DATASET_MEANS.get(cfg.data.dataset,
                                     DATASET_MEANS["flyingchairs"])
        self.mean = mean
        if (forward_fn is None and model is None
                and cfg.serve.fake_exec_ms is not None):
            forward_fn = make_fake_forward(float(cfg.serve.fake_exec_ms))
        self._forward_custom = forward_fn is not None
        self.tier_models: dict[str, nn.Module] = {}
        self.model = None
        self._cold: dict[str, Callable] = {}
        self.refine_models: dict[str, nn.Module] = {}
        self._warm: dict[str, Callable] = {}
        # the cold output grid of each bucket: the prior's grid
        self._head_hw: dict[tuple[int, int], tuple[int, int]] = {}
        if self._forward_custom:
            self._forward = (lambda key, x, prior=None, _fn=forward_fn:
                             _fn(key[0], x))
        else:
            self._build_models(model, refine)
        del model, refine

        depth = max(int(cfg.serve.queue_depth), 0)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = False
        self._rid = itertools.count(1)
        # after each flush: (total responses) -> None; the server's
        # heartbeat beat
        self.flush_hook: Callable[[int], None] | None = None

        # counters (guarded by _stats_lock: stats() returns multi-field
        # snapshots)
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._responses = 0
        self._errors = 0
        self._server_errors = 0  # the SLO budget's failures
        self._batches = 0
        self._dispatch_failures = 0
        self._bucket_splits = 0
        self._tier_splits = 0
        self._warm_splits = 0   # same (bucket, tier), cold | warm edge
        self._warm_steps = 0
        self._cold_fallbacks = 0  # warm_start steps with no prior yet
        self._requests_by_tier = dict.fromkeys(self.tiers, 0)
        self._responses_by_tier = dict.fromkeys(self.tiers, 0)
        self._timeout_flushes = 0
        self._occupancy_sum = 0
        self._last_occupancy = 0
        self._max_queue_depth = 0
        self._submitting = 0  # submit() threads currently inside put()
        # requests with a budget, and where the expired ones failed
        self._deadline_requests = 0
        self._deadline_enqueue_expired = 0
        self._deadline_flush_expired = 0
        self._deadline_wait_expired = 0
        # requests served cheaper than their level-0 operating point
        self._degrade_tier_downgrades = 0
        self._degrade_bucket_downgrades = 0
        self._hist = LatencyHistogram()
        self._session_hist = LatencyHistogram()
        self._done_per_s: dict[int, int] = {}  # completions a second
        sc = cfg.serve.session
        self.sessions = SessionStore(max_sessions=sc.max_sessions,
                                     ttl_s=sc.ttl_s, sweep_s=sc.sweep_s)

        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    def _build_models(self, model: nn.Module | None,
                      refine: nn.Module | None) -> None:
        """One module per tier (and one refinement stage per tier under
        warm start), built now: a tier that cannot be built fails the
        engine, not a request."""
        cfg = self.cfg
        if model is None:
            model = build_serve_model(cfg, self.device)
        model = model.to(self.device).eval()
        self.tier_models = {t: quantize_model(model, t) for t in self.tiers}
        self.model = self.tier_models[self.default_tier]
        self._cold = {t: make_raw_forward(m)
                      for t, m in self.tier_models.items()}
        self._forward = self._model_forward
        if self.warm_start:
            if refine is None:
                refine = build_refine_model(cfg, model, self.device)
            refine = refine.to(self.device).eval()
            self.refine_models = {t: quantize_model(refine, t)
                                  for t in self.tiers}
            self._warm = {t: make_refine_forward(m)
                          for t, m in self.refine_models.items()}
            self._check_warm_grids()

    def _check_warm_grids(self) -> None:
        """The refinement stage's finest output must land on the cold
        output's grid, or a session's prior would change shape after its
        first warm step: checked for each bucket with a one-row forward
        of each, default tier."""
        for bucket in self.buckets:
            x = np.zeros((1, *bucket, PAIR_CHANNELS), np.float32)
            cold_hw = self._cold[self.default_tier](x).shape[1:3]
            prior = np.zeros((1, *cold_hw, 2), np.float32)
            warm_hw = self._warm[self.default_tier](x, prior).shape[1:3]
            if warm_hw != cold_hw:
                raise ValueError(
                    f"warm_start unsupported for model {self.cfg.model!r} at "
                    f"bucket {bucket}: the refinement head grid {warm_hw} "
                    f"differs from the cold head grid {cold_hw}")
            self._head_hw[bucket] = tuple(cold_hw)

    def _model_forward(self, key: tuple[tuple[int, int], str, str],
                       x: np.ndarray, prior: np.ndarray | None = None
                       ) -> np.ndarray:
        _, tier, mode = key
        if mode == "warm":
            return self._warm[tier](x, prior)
        return self._cold[tier](x)

    # ------------------------------------------------------------ submit
    def _resolve_tier(self, precision, rid, degrade_level: int = 0) -> str:
        """The request's tier: `precision`, or the default for None; a
        tier this engine does not serve is a structured bad_request. At
        brownout level 1 and above a request that names no precision
        serves at the last configured tier (the cheapest in config
        order); an explicit precision is always honoured."""
        if precision is None:
            if degrade_level >= 1 and len(self.tiers) > 1:
                tier = self.tiers[-1]
                if tier != self.default_tier:
                    with self._stats_lock:
                        self._degrade_tier_downgrades += 1
                return tier
            return self.default_tier
        tier = str(precision)
        if tier not in self.tiers:
            raise ServeError("bad_request",
                             f"precision {tier!r} not served; this engine "
                             f"offers {list(self.tiers)}", rid)
        return tier

    def _deadline_abs(self, deadline_s) -> float | None:
        """The caller's budget (seconds left) -> absolute monotonic
        expiry; counts the request in deadline_requests."""
        if deadline_s is None:
            return None
        with self._stats_lock:
            self._deadline_requests += 1
        return time.monotonic() + max(float(deadline_s), 0.0)

    def _decode(self, img) -> np.ndarray:
        """Decoded BGR array (validated), or a `.npy` path holding one, or
        a PNG, JPEG or PPM path (the native decoder; a PNG without its
        PNG codec through `io/png.py`). A file this build cannot decode
        is a bad_input naming the decoder's codecs."""
        if isinstance(img, (str, os.PathLike)):
            if str(img).endswith(".npy"):
                img = np.load(img, allow_pickle=False)
            else:
                try:
                    img = _imread_bgr(str(img))
                except (OSError, ValueError) as e:
                    raise ServeError("bad_input", str(e)) from e
        if not isinstance(img, np.ndarray) or img.ndim != 3 \
                or img.shape[-1] != 3:
            raise ServeError("bad_input", "image must be an (H, W, 3) BGR "
                             f"array, got {getattr(img, 'shape', type(img))}")
        return img

    def submit(self, prev, nxt, precision: str | None = None,
               request_id: int | str | None = None,
               deadline_s: float | None = None,
               degrade_level: int = 0) -> Future:
        """Enqueue one (prev, next) pair: decoded BGR arrays, .npy paths,
        or PNG, JPEG or PPM paths. precision: a tier of
        `serve.precisions`; None gives the first. deadline_s: the
        caller's remaining budget (None: no deadline); an expired request
        fails with `deadline_exceeded` at the enqueue or the flush.
        degrade_level: the brownout level (1+: the last tier for a
        request that names none; 2+: one bucket down).

        Returns a Future resolving to {"flow": (H_native, W_native, 2)
        float32 in native pixel units, "bucket", "precision", "native_hw",
        "latency_s", "request_id"}; failures raise ServeError from
        .result(). Decode/preprocess errors fail here."""
        rid = request_id if request_id is not None else next(self._rid)
        fut: Future = Future()
        with self._stats_lock:
            self._requests += 1
        try:
            tier = self._resolve_tier(precision, rid, degrade_level)
            deadline = self._deadline_abs(deadline_s)
            with obs_trace.span("serve_enqueue", request_id=rid):
                src = self._decode(prev)
                tgt = self._decode(nxt)
                native_hw = (int(src.shape[0]), int(src.shape[1]))
                bucket = pick_bucket(native_hw, self.buckets)
                if degrade_level >= 2:
                    down = next_smaller_bucket(bucket, self.buckets)
                    if down != bucket:
                        bucket = down
                        with self._stats_lock:
                            self._degrade_bucket_downgrades += 1
                x = prepare_pair(src, tgt, bucket, self.mean)
            with self._stats_lock:
                self._requests_by_tier[tier] += 1
            self._enqueue(_Request(x, bucket, tier, native_hw, fut,
                                   time.monotonic(), rid, deadline=deadline))
        except ServeError as e:
            e.request_id = e.request_id or rid
            self._fail(fut, e)
        except Exception as e:  # noqa: BLE001 - decode errors are per-request
            self._fail(fut, ServeError(
                "bad_input", f"{type(e).__name__}: {e}", rid))
        return fut

    def submit_prepared(self, x: np.ndarray, bucket: tuple[int, int],
                        native_hw: tuple[int, int],
                        precision: str | None = None,
                        request_id: int | str | None = None,
                        deadline_s: float | None = None) -> Future:
        """Enqueue an already-preprocessed row (H, W, 6) at `bucket`
        (offline mode). No brownout fold: the row is prepared at its
        bucket."""
        rid = request_id if request_id is not None else next(self._rid)
        fut: Future = Future()
        with self._stats_lock:
            self._requests += 1
        try:
            tier = self._resolve_tier(precision, rid)
            deadline = self._deadline_abs(deadline_s)
            with self._stats_lock:
                self._requests_by_tier[tier] += 1
            self._enqueue(_Request(np.asarray(x, np.float32), tuple(bucket),
                                   tier, tuple(native_hw), fut,
                                   time.monotonic(), rid, deadline=deadline))
        except ServeError as e:
            e.request_id = e.request_id or rid
            self._fail(fut, e)
        return fut

    def submit_next(self, session: str, frame,
                    precision: str | None = None,
                    request_id: int | str | None = None,
                    deadline_s: float | None = None,
                    degrade_level: int = 0) -> Future:
        """Advance a streaming session by one frame (`serve/session.py`).

        The session's first frame primes it: the future resolves at once
        with {"primed": True, "session", "bucket", "native_hw", "frames",
        "request_id"}, and nothing dispatches. Each later frame pairs with
        the cached previous one and resolves as `submit` does, plus
        {"session", "frame_index"}, and "warm" (whether the refinement
        stage served it) when `serve.session.warm_start` is on.

        A frame for an expired or evicted session fails with a structured
        `session_expired` (resend it to re-prime, counted as resumed); a
        frame of another bucket re-primes in place (rebucketed); a frame
        that fails to decode fails alone and does not advance the
        session. `deadline_s` as in `submit`; the brownout fold is the
        tier's only (a bucket change would re-prime the session)."""
        rid = request_id if request_id is not None else next(self._rid)
        fut: Future = Future()
        counted = False  # one serve_requests tick for a step or a failure
        kind = ("session_step" if self.sessions.contains(str(session))
                else "session_prime")  # the span's name; advance decides
        try:
            tier = self._resolve_tier(precision, rid, degrade_level)
            deadline = self._deadline_abs(deadline_s)
            with obs_trace.span(kind, session=str(session),
                                request_id=rid) as span:
                img = self._decode(frame)
                native_hw = (int(img.shape[0]), int(img.shape[1]))
                bucket = pick_bucket(native_hw, self.buckets)
                row = prepare_frame(img, bucket, self.mean)
                try:
                    out = self.sessions.advance(str(session), row, bucket,
                                                native_hw, tier)
                except SessionExpired as e:
                    raise ServeError("session_expired",
                                     f"session {e.sid!r} {e.reason}: resend "
                                     "the frame to re-prime", rid) from None
                if out[0] == "primed":
                    s = out[1]
                    span.set(kind="session_prime")
                    fut.set_result({"primed": True, "session": s.sid,
                                    "bucket": bucket,
                                    "native_hw": native_hw,
                                    "frames": s.frames, "request_id": rid})
                    return fut
                _, prev_row, prior, epoch, s = out
                # a step with a prior takes the refinement stage; without
                # one (the first step, or after a re-prime) the cold model
                mode = ("warm" if self.warm_start and prior is not None
                        else "cold")
                span.set(kind=("session_warm" if mode == "warm"
                               else "session_step"),
                         frame_index=s.frames - 1)
                x = np.concatenate([prev_row, row], axis=-1)
            with self._stats_lock:
                self._requests += 1
                self._requests_by_tier[tier] += 1
                if mode == "warm":
                    self._warm_steps += 1
                elif self.warm_start:
                    self._cold_fallbacks += 1
            counted = True
            self._enqueue(_Request(
                x, bucket, tier, native_hw, fut, time.monotonic(), rid,
                mode=mode, prior=prior if mode == "warm" else None,
                session=s.sid, frame_index=s.frames - 1, epoch=epoch,
                deadline=deadline))
            return fut
        except ServeError as e:
            e.request_id = e.request_id or rid
            err = e
        except Exception as e:  # noqa: BLE001 - decode errors are per-request
            err = ServeError("bad_input", f"{type(e).__name__}: {e}", rid)
        if not counted:
            with self._stats_lock:
                self._requests += 1
        self._fail(fut, err)
        return fut

    def _enqueue(self, req: _Request) -> None:
        with self._stats_lock:
            if self._closed:
                raise ServeError("engine_closed", "engine is shut down",
                                 req.rid)
            self._submitting += 1
        try:
            # bounded put = backpressure, polled so that a submitter
            # blocked on a full queue observes close() and its own
            # deadline
            while True:
                if self._closed:
                    raise ServeError("engine_closed", "engine is shut down",
                                     req.rid)
                rem = 0.1
                if req.deadline is not None:
                    rem = req.deadline - time.monotonic()
                    if rem <= 0:
                        with self._stats_lock:
                            self._deadline_enqueue_expired += 1
                        raise ServeError("deadline_exceeded",
                                         "deadline expired while queueing",
                                         req.rid)
                try:
                    self._q.put(req, timeout=min(0.1, max(rem, 0.001)))
                    break
                except queue.Full:
                    continue
        finally:
            with self._stats_lock:
                self._submitting -= 1
        with self._stats_lock:
            self._max_queue_depth = max(self._max_queue_depth,
                                        self._q.qsize())

    def _fail(self, fut: Future, err: ServeError) -> None:
        with self._stats_lock:
            self._errors += 1
            if err.code not in CLIENT_CODES:
                self._server_errors += 1  # burns the SLO's error budget
        fut.set_exception(err)

    def note_wait_expired(self) -> None:
        """The server's wait for a response reached the caller's budget
        before the engine resolved it (a 504 from the server)."""
        with self._stats_lock:
            self._deadline_wait_expired += 1

    # ----------------------------------------------------------- batcher
    def _run(self) -> None:
        pending: _Request | None = None  # carried over a bucket split
        stop = False
        while not stop:
            if pending is not None:
                req, pending = pending, None
            else:
                req = self._q.get()
            if req is _STOP:
                break
            batch = [req]
            timed_out = False
            with obs_trace.span("serve_batch") as batch_span:
                while len(batch) < self.max_batch:
                    rem = (batch[0].t_enq + self.timeout_s) - time.monotonic()
                    try:
                        nxt = (self._q.get(timeout=rem) if rem > 0
                               else self._q.get_nowait())
                    except queue.Empty:
                        timed_out = True  # the oldest waited out the window
                        break
                    if nxt is _STOP:
                        stop = True
                        break
                    if nxt.key != batch[0].key:
                        pending = nxt  # flush now; it opens the next batch
                        with self._stats_lock:
                            if nxt.bucket != batch[0].bucket:
                                self._bucket_splits += 1
                            elif nxt.tier != batch[0].tier:
                                self._tier_splits += 1
                            else:
                                self._warm_splits += 1
                        break
                    batch.append(nxt)
                batch_span.set(request_ids=[r.rid for r in batch],
                               occupancy=len(batch))
            if timed_out and len(batch) < self.max_batch:
                with self._stats_lock:
                    self._timeout_flushes += 1
            self._flush(batch)
        # anything still queued after _STOP was submitted post-close
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _STOP:
                self._fail(req.future, ServeError(
                    "engine_closed", "engine shut down before dispatch",
                    req.rid))

    def _flush(self, batch: list[_Request]) -> None:
        # the last deadline gate: an expired request takes no batch slot
        now = time.monotonic()
        expired = [r for r in batch
                   if r.deadline is not None and r.deadline <= now]
        if expired:
            with self._stats_lock:
                self._deadline_flush_expired += len(expired)
            for r in expired:
                self._fail(r.future, ServeError(
                    "deadline_exceeded", "deadline expired before dispatch",
                    r.rid))
            batch = [r for r in batch if r not in expired]
            if not batch:
                return
        key = batch[0].key
        bucket, tier, mode = key
        n = len(batch)
        tag = f"{bucket[0]}x{bucket[1]}/{tier}/{mode}"
        rids = [r.rid for r in batch]
        with obs_trace.span("serve_dispatch", occupancy=n, bucket=tag,
                            request_ids=rids):
            x = np.zeros((self.max_batch, bucket[0], bucket[1],
                          batch[0].x.shape[-1]), np.float32)
            for i, r in enumerate(batch):
                x[i] = r.x
            prior = None
            if mode == "warm":
                # the priors beside the rows, zero past the occupancy as x
                prior = np.zeros((self.max_batch, *batch[0].prior.shape),
                                 np.float32)
                for i, r in enumerate(batch):
                    prior[i] = r.prior
            try:
                out = np.asarray(self._forward(key, x, prior))
            except Exception as e:  # noqa: BLE001 - the flush fails, not the engine
                with self._stats_lock:
                    self._dispatch_failures += 1
                for r in batch:
                    self._fail(r.future, ServeError(
                        "dispatch_failed", f"{type(e).__name__}: {e}", r.rid))
                return
        with obs_trace.span("serve_postprocess", occupancy=n, bucket=tag,
                            request_ids=rids):
            for i, r in enumerate(batch):
                try:
                    flow = flow_to_native(out[i], self.cfg, bucket,
                                          r.native_hw)
                except Exception as e:  # noqa: BLE001 - one request's failure
                    self._fail(r.future, ServeError(
                        "postprocess_failed", f"{type(e).__name__}: {e}",
                        r.rid))
                    continue
                if r.session is not None and self.warm_start:
                    # this step's raw output becomes the session's prior,
                    # before the result: a closed-loop client's next
                    # frame sees it. The copy detaches it from the batch.
                    self.sessions.set_flow(r.session,
                                           np.ascontiguousarray(out[i]),
                                           bucket, r.epoch)
                done = time.monotonic()
                self._hist.observe(done - r.t_enq)
                if r.session is not None:
                    self._session_hist.observe(done - r.t_enq)
                with self._stats_lock:
                    self._responses += 1
                    self._responses_by_tier[tier] += 1
                    sec = int(done)
                    self._done_per_s[sec] = self._done_per_s.get(sec, 0) + 1
                    if len(self._done_per_s) > _RATE_WINDOW_S + 5:
                        for old in [t for t in self._done_per_s
                                    if t < sec - _RATE_WINDOW_S - 1]:
                            del self._done_per_s[old]
                result = {"flow": flow, "bucket": bucket, "precision": tier,
                          "native_hw": r.native_hw,
                          "latency_s": done - r.t_enq, "request_id": r.rid}
                if r.session is not None:
                    result["session"] = r.session
                    result["frame_index"] = r.frame_index
                    if self.warm_start:
                        result["warm"] = mode == "warm"
                r.future.set_result(result)
        with self._stats_lock:
            self._batches += 1
            self._occupancy_sum += n
            self._last_occupancy = n
            total = self._responses
        hook = self.flush_hook
        if hook is not None:
            try:
                hook(total)
            except Exception:  # noqa: BLE001 - never stops serving
                pass

    # ------------------------------------------------------------ warm
    def warm(self) -> dict:
        """The postprocess path once on a dummy flow, then one padded
        dispatch of zeros for each (bucket, tier, mode) of the engine, so
        the kernels are built and cuDNN has chosen its algorithms before
        the first request (no dispatch for a stand-in executor). Returns
        {"buckets": [{"bucket", "tier", "mode", "seconds"}]}."""
        # the first request would otherwise pay the postprocess path's
        # first call (the resize's kernels, its imports) in the batcher,
        # and the native decoder's build (at its first use) in a handler
        flow_to_native(np.zeros((2, 2, 2), np.float32), self.cfg, (2, 2),
                       (2, 2))
        native.codecs()
        out = []
        if self._forward_custom:
            return {"buckets": out}
        modes = ("cold", "warm") if self.warm_start else ("cold",)
        for bucket in self.buckets:
            x = np.zeros((self.max_batch, *bucket, PAIR_CHANNELS), np.float32)
            for tier in self.tiers:
                for mode in modes:
                    prior = (np.zeros((self.max_batch,
                                       *self._head_hw[bucket], 2),
                                      np.float32) if mode == "warm" else None)
                    t0 = time.perf_counter()
                    self._forward((bucket, tier, mode), x, prior)
                    out.append({"bucket": list(bucket), "tier": tier,
                                "mode": mode,
                                "seconds": time.perf_counter() - t0})
        return {"buckets": out}

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The serve_* counter block (the JAX engine's keys, less those of
        its quality, ledger and incident planes), with the session
        store's serve_sessions_* block, the latency histograms, their
        p50/p99, and `serve_slo` when `obs.slo_latency_ms` > 0."""
        now = time.monotonic()
        with self._stats_lock:
            recent = sum(c for t, c in self._done_per_s.items()
                         if now - t <= _RATE_WINDOW_S)
            out = {
                "serve_requests": self._requests,
                "serve_responses": self._responses,
                "serve_errors": self._errors,
                "serve_server_errors": self._server_errors,
                "serve_batches": self._batches,
                "serve_dispatch_failures": self._dispatch_failures,
                "serve_bucket_splits": self._bucket_splits,
                "serve_tier_splits": self._tier_splits,
                "serve_warm_splits": self._warm_splits,
                "serve_requests_by_tier": dict(self._requests_by_tier),
                "serve_responses_by_tier": dict(self._responses_by_tier),
                "serve_timeout_flushes": self._timeout_flushes,
                "serve_queue_depth": self._q.qsize(),
                "serve_max_queue_depth": self._max_queue_depth,
                "serve_last_occupancy": self._last_occupancy,
                "serve_occupancy_mean": (
                    round(self._occupancy_sum / self._batches, 3)
                    if self._batches else None),
                "serve_max_batch": self.max_batch,
                "serve_buckets": len(self.buckets),
                "serve_tiers": len(self.tiers),
                "deadline_requests": self._deadline_requests,
                "deadline_enqueue_expired": self._deadline_enqueue_expired,
                "deadline_flush_expired": self._deadline_flush_expired,
                "deadline_wait_expired": self._deadline_wait_expired,
                "degrade_tier_downgrades": self._degrade_tier_downgrades,
                "degrade_bucket_downgrades": self._degrade_bucket_downgrades,
                "serve_sessions_warm_steps": self._warm_steps,
                "serve_sessions_cold_fallbacks": self._cold_fallbacks,
            }
            requests, failures = self._requests, self._server_errors
        out["serve_requests_per_s"] = round(recent / _RATE_WINDOW_S, 3)
        out.update(self.sessions.stats())
        out["serve_sessions_warm_start"] = self.warm_start
        for name, hist in (("serve_latency", self._hist),
                           ("serve_session_latency", self._session_hist)):
            snap = hist.snapshot()
            out[f"{name}_hist"] = snap
            out[f"{name}_p50_ms"] = percentile_ms(snap, 0.50)
            out[f"{name}_p99_ms"] = percentile_ms(snap, 0.99)
        if float(self.cfg.obs.slo_latency_ms) > 0:
            out["serve_slo"] = slo_state(
                out["serve_latency_hist"], requests, failures,
                self.cfg.obs.slo_latency_ms, self.cfg.obs.slo_error_budget)
        return out

    def heartbeat_sample(self) -> dict:
        """The serve heartbeat's `sample` callback: stats()."""
        return self.stats()

    # ------------------------------------------------------------- close
    def close(self) -> None:
        """Flush everything already queued, then stop the batcher.
        Idempotent; submissions after close fail with engine_closed."""
        with self._stats_lock:
            if self._closed:
                return
            self._closed = True
        self.sessions.close()  # stop the TTL sweeper
        self._q.put(_STOP)
        self._thread.join(timeout=60.0)
        # submitters that passed the closed check before it flipped may
        # still complete a put; wait them out, then fail what is left
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with self._stats_lock:
                if self._submitting == 0:
                    break
            time.sleep(0.01)
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not _STOP:
                self._fail(req.future, ServeError(
                    "engine_closed", "engine shut down before dispatch",
                    req.rid))

    def __enter__(self) -> "InferenceEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
