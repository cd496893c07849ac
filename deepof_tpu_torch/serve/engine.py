"""InferenceEngine: a dynamic micro-batching flow-inference engine (port
of the cold float32 path of `deepof_tpu/serve/engine.py`).

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

The model runs under `torch.inference_mode()` on the engine's device
(CUDA unless the caller passes another). Still to port (ROADMAP): the
bf16/int8 tiers, streaming sessions and warm start, quality scoring,
the executable ledger and artifacts, deadlines and degradation, and the
HTTP server.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch
from torch import nn

from ..core.config import ExperimentConfig
from ..core.device import resolve_device
from ..data.datasets import DATASET_MEANS
from ..io.ppm import read_ppm_bgr
from .buckets import flow_to_native, pick_bucket, prepare_pair, resolve_buckets

_STOP = object()

#: Latency samples retained for the p50/p99 estimate (newest window).
_LATENCY_WINDOW = 2048

#: Precision tiers this package serves so far.
SERVED_TIERS = ("f32",)


class ServeError(RuntimeError):
    """Structured per-request failure: machine-readable `code` +
    message. Codes: bad_input (decode/preprocess), dispatch_failed (the
    batched forward raised; the whole flush fails), postprocess_failed
    (one request's resize/rescale raised), engine_closed."""

    def __init__(self, code: str, message: str,
                 request_id: int | str | None = None):
        super().__init__(message)
        self.code = code
        self.request_id = request_id


class _Request:
    __slots__ = ("x", "bucket", "native_hw", "future", "t_enq", "rid")

    def __init__(self, x, bucket, native_hw, future, t_enq, rid):
        self.x = x
        self.bucket = bucket
        self.native_hw = native_hw
        self.future = future
        self.t_enq = t_enq
        self.rid = rid


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


def make_raw_forward(model: nn.Module) -> Callable[[np.ndarray], np.ndarray]:
    """pairs (B, H, W, 6) float32 numpy -> finest scaled flow (B, h, w, 2)
    float32 numpy, run on the model's device under inference_mode."""
    device = next(model.parameters()).device
    scale = model.flow_scales[0]

    def fwd(x: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            t = t.to(device).permute(0, 3, 1, 2).contiguous()
            flow = model(t)[0] * scale
            return flow.permute(0, 2, 3, 1).float().cpu().numpy()

    return fwd


class InferenceEngine:
    """See module docstring.

    cfg: experiment config (serve.* drives the batcher; data/eval fields
        drive the preprocess/postprocess protocol).
    model: optional nn.Module with its weights (tests load converted
        flax weights); None builds `cfg.model` from `cfg.train.seed`.
    mean: optional BGR dataset mean override (DATASET_MEANS default).
    device: where the model runs; "cuda" by default, which raises on a
        host without a card.
    """

    def __init__(self, cfg: ExperimentConfig, model: nn.Module | None = None,
                 mean=None, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = max(int(cfg.serve.max_batch), 1)
        self.timeout_s = max(float(cfg.serve.batch_timeout_ms), 0.0) / 1e3
        self.buckets = resolve_buckets(cfg)
        unserved = [t for t in cfg.serve.precisions if t not in SERVED_TIERS]
        if unserved:
            raise NotImplementedError(
                f"serve.precisions {unserved} are not ported yet (ROADMAP "
                f"Queue A item 8, serving tiers); this package serves "
                f"{list(SERVED_TIERS)}")
        if mean is None:
            mean = DATASET_MEANS.get(cfg.data.dataset,
                                     DATASET_MEANS["flyingchairs"])
        self.mean = mean
        if model is None:
            model = build_serve_model(cfg, self.device)
        self.model = model.to(self.device).eval()
        self._forward = make_raw_forward(self.model)

        depth = max(int(cfg.serve.queue_depth), 0)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = False
        self._rid = itertools.count(1)

        # counters (guarded by _stats_lock: stats() returns multi-field
        # snapshots)
        self._stats_lock = threading.Lock()
        self._requests = 0
        self._responses = 0
        self._errors = 0
        self._batches = 0
        self._dispatch_failures = 0
        self._occupancy_sum = 0
        self._submitting = 0  # submit() threads currently inside put()
        self._latency_s: deque = deque(maxlen=_LATENCY_WINDOW)

        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-batcher")
        self._thread.start()

    # ------------------------------------------------------------ submit
    def _decode(self, img) -> np.ndarray:
        """Decoded BGR array (validated), or a `.npy` path holding one, or
        a binary `.ppm` path. This package has no PNG/JPEG decoder."""
        if isinstance(img, (str, os.PathLike)):
            if str(img).endswith(".npy"):
                img = np.load(img, allow_pickle=False)
            elif str(img).endswith(".ppm"):
                img = read_ppm_bgr(img)
            else:
                raise ServeError("bad_input",
                                 f"{img!r}: only decoded BGR arrays, .npy "
                                 "and .ppm paths are accepted")
        if not isinstance(img, np.ndarray) or img.ndim != 3 \
                or img.shape[-1] != 3:
            raise ServeError("bad_input", "image must be an (H, W, 3) BGR "
                             f"array, got {getattr(img, 'shape', type(img))}")
        return img

    def submit(self, prev, nxt,
               request_id: int | str | None = None) -> Future:
        """Enqueue one (prev, next) pair: decoded BGR arrays, .npy or .ppm
        paths.

        Returns a Future resolving to {"flow": (H_native, W_native, 2)
        float32 in native pixel units, "bucket", "native_hw", "latency_s", "request_id"}; failures raise ServeError
        from .result(). Decode/preprocess errors fail here."""
        rid = request_id if request_id is not None else next(self._rid)
        fut: Future = Future()
        with self._stats_lock:
            self._requests += 1
        try:
            src = self._decode(prev)
            tgt = self._decode(nxt)
            native_hw = (int(src.shape[0]), int(src.shape[1]))
            bucket = pick_bucket(native_hw, self.buckets)
            x = prepare_pair(src, tgt, bucket, self.mean)
            self._enqueue(_Request(x, bucket, native_hw, fut,
                                   time.monotonic(), rid))
        except ServeError as e:
            e.request_id = e.request_id or rid
            self._fail(fut, e)
        except Exception as e:  # noqa: BLE001 - decode errors are per-request
            self._fail(fut, ServeError(
                "bad_input", f"{type(e).__name__}: {e}", rid))
        return fut

    def submit_prepared(self, x: np.ndarray, bucket: tuple[int, int],
                        native_hw: tuple[int, int],
                        request_id: int | str | None = None) -> Future:
        """Enqueue an already-preprocessed row (H, W, 6) at `bucket`."""
        rid = request_id if request_id is not None else next(self._rid)
        fut: Future = Future()
        with self._stats_lock:
            self._requests += 1
        try:
            self._enqueue(_Request(np.asarray(x, np.float32), tuple(bucket),
                                   tuple(native_hw), fut, time.monotonic(),
                                   rid))
        except ServeError as e:
            e.request_id = e.request_id or rid
            self._fail(fut, e)
        return fut

    def _enqueue(self, req: _Request) -> None:
        with self._stats_lock:
            if self._closed:
                raise ServeError("engine_closed", "engine is shut down",
                                 req.rid)
            self._submitting += 1
        try:
            # bounded put = backpressure, polled so that a submitter
            # blocked on a full queue observes close()
            while True:
                if self._closed:
                    raise ServeError("engine_closed", "engine is shut down",
                                     req.rid)
                try:
                    self._q.put(req, timeout=0.1)
                    break
                except queue.Full:
                    continue
        finally:
            with self._stats_lock:
                self._submitting -= 1

    def _fail(self, fut: Future, err: ServeError) -> None:
        with self._stats_lock:
            self._errors += 1
        fut.set_exception(err)

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
            while len(batch) < self.max_batch:
                rem = (batch[0].t_enq + self.timeout_s) - time.monotonic()
                try:
                    nxt = (self._q.get(timeout=rem) if rem > 0
                           else self._q.get_nowait())
                except queue.Empty:
                    break  # the oldest waited out the deadline
                if nxt is _STOP:
                    stop = True
                    break
                if nxt.bucket != batch[0].bucket:
                    pending = nxt  # flush now; it opens the next batch
                    break
                batch.append(nxt)
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
        bucket = batch[0].bucket
        n = len(batch)
        x = np.zeros((self.max_batch, bucket[0], bucket[1],
                      batch[0].x.shape[-1]), np.float32)
        for i, r in enumerate(batch):
            x[i] = r.x
        try:
            out = self._forward(x)
        except Exception as e:  # noqa: BLE001 - the flush fails, not the engine
            with self._stats_lock:
                self._dispatch_failures += 1
            for r in batch:
                self._fail(r.future, ServeError(
                    "dispatch_failed", f"{type(e).__name__}: {e}", r.rid))
            return
        for i, r in enumerate(batch):
            try:
                flow = flow_to_native(out[i], self.cfg, bucket, r.native_hw)
            except Exception as e:  # noqa: BLE001 - one request's failure
                self._fail(r.future, ServeError(
                    "postprocess_failed", f"{type(e).__name__}: {e}", r.rid))
                continue
            done = time.monotonic()
            with self._stats_lock:
                self._responses += 1
                self._latency_s.append(done - r.t_enq)
            r.future.set_result({"flow": flow, "bucket": bucket,
                                 "native_hw": r.native_hw,
                                 "latency_s": done - r.t_enq,
                                 "request_id": r.rid})
        with self._stats_lock:
            self._batches += 1
            self._occupancy_sum += n

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The serve_* counter block."""
        with self._stats_lock:
            lat = sorted(self._latency_s)
            out = {
                "serve_requests": self._requests,
                "serve_responses": self._responses,
                "serve_errors": self._errors,
                "serve_batches": self._batches,
                "serve_dispatch_failures": self._dispatch_failures,
                "serve_occupancy_mean": (
                    round(self._occupancy_sum / self._batches, 3)
                    if self._batches else None),
            }
        if lat:
            out["serve_latency_p50_ms"] = round(
                1e3 * lat[int(0.50 * (len(lat) - 1))], 3)
            out["serve_latency_p99_ms"] = round(
                1e3 * lat[int(0.99 * (len(lat) - 1))], 3)
        else:
            out["serve_latency_p50_ms"] = None
            out["serve_latency_p99_ms"] = None
        return out

    # ------------------------------------------------------------- close
    def close(self) -> None:
        """Flush everything already queued, then stop the batcher.
        Idempotent; submissions after close fail with engine_closed."""
        with self._stats_lock:
            if self._closed:
                return
            self._closed = True
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
