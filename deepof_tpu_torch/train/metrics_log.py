"""Structured metrics log, step timing, the metrics read and the
profiler window (port of `deepof_tpu/train/metrics_log.py`).

Every record is one JSON line in `<log_dir>/metrics.jsonl`, mirrored to
stdout. `StepTimer` reports steps/s and pairs/s over training time only,
per-phase host seconds and event counters.

`AsyncFetcher` and `SyncFetcher` are the JAX package's: the loop submits
a call's metrics when a record, an eval or a checkpoint is due, and the
fetcher takes them to the host (at `train.pipeline_depth` > 0 on a
consumer thread, up to that many fetches behind the dispatch; at 0
inline) and runs the loop's callback on them, on the bounded retry
ladder with the ``fetch`` fault site. `HostStager` is the card's side
of a fetch: a pinned ring and a CUDA event, so a fetch waits for its own
step only.

`ProfilerSession` is the JAX package's `jax.profiler` window on
`torch.profiler`: a Chrome trace under `<log_dir>/profile/`.
"""

from __future__ import annotations

import collections
import json
import math
import os
import queue
import statistics
import threading
import time

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..resilience.healing import retry_bounded


def _scalarize(v):
    if v is None or isinstance(v, (str, bool, int)):
        return v
    if isinstance(v, dict):
        return {k: _scalarize(x) for k, x in v.items()}
    a = np.asarray(v)
    return a.tolist() if a.ndim else float(a)


def _json_safe(v):
    """Non-finite floats -> None, so metrics.jsonl stays strict JSON (a
    NaN loss keeps its key, as null)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    if isinstance(v, list):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    return v


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.path = os.path.join(log_dir, "metrics.jsonl")
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)
        # records come from the main loop and from pipeline workers
        # (healer warnings): one line at a time
        self._lock = threading.Lock()

    def log(self, kind: str, step: int, **metrics) -> None:
        rec = {"kind": kind, "step": int(step), "time": time.time()}
        rec.update({k: _json_safe(_scalarize(v)) for k, v in metrics.items()})
        with self._lock:
            self._f.write(json.dumps(rec, allow_nan=False) + "\n")
            print({k: (round(v, 6) if isinstance(v, float) else v)
                   for k, v in rec.items() if k != "time"}, flush=True)

    def close(self) -> None:
        self._f.close()


class StepTimer:
    """Cumulative steps/s and items/s over *training* time only, on one
    device (the JAX record's `items_per_sec_per_chip`).

    The first tick after construction or `pause()` only arms the timer,
    so the first step and paused-over work (eval, checkpoint saves) are
    left out of the rates.

    `phase(name, dt)` accumulates host seconds per loop phase:
    `assemble` (waiting on the prefetcher), `put` (staging a batch on
    the device, on the prefetch thread), `dispatch` (the main thread's
    call of the step), `fetch` (the metrics' host read, on the
    fetcher). `count(name)` accumulates event counters
    (`starved`: steps whose input wait exceeded 1 ms; `skipped_updates`,
    `rollbacks`).

    `medians()` gives the median host-clock time of a timed step (tick
    to tick, over the steps of a call) and of each phase, over the
    latest RECENT of each; steps a rollback discards still count there,
    since they took that time.
    """

    #: samples per median (the latest ones)
    RECENT = 1000

    def __init__(self, items_per_step: int):
        self.items_per_step = items_per_step
        self._last: float | None = None
        self._elapsed = 0.0
        self._steps = 0
        self._phases: dict[str, float] = {}
        self._phase_counts: dict[str, int] = {}
        self._recent: dict[str, collections.deque] = {}
        self._counters: dict[str, int] = {}

    def _sample(self, name: str, seconds: float) -> None:
        if name not in self._recent:
            self._recent[name] = collections.deque(maxlen=self.RECENT)
        self._recent[name].append(seconds)

    def phase(self, name: str, seconds: float) -> None:
        """Called from the main loop and the prefetch thread, with
        distinct names, so the GIL-atomic dict ops suffice."""
        self._phases[name] = self._phases.get(name, 0.0) + seconds
        self._phase_counts[name] = self._phase_counts.get(name, 0) + 1
        self._sample(f"phase_{name}", seconds)

    def count(self, name: str, n: int = 1) -> None:
        self._counters[name] = self._counters.get(name, 0) + n

    def counters(self) -> dict[str, int]:
        return dict(self._counters)

    def phases(self) -> dict[str, float]:
        """Per-phase totals, keyed `phase_<name>_s`. Snapshot first: the
        prefetch thread may be inserting a key."""
        return {f"phase_{k}_s": round(v, 4)
                for k, v in sorted(dict(self._phases).items())}

    def tick(self, n: int = 1) -> None:
        """Record n completed steps (a call of steps_per_call = n); the
        median samples the interval per step."""
        now = time.perf_counter()
        if self._last is not None:
            self._elapsed += now - self._last
            self._steps += n
            self._sample("step", (now - self._last) / n)
        self._last = now

    def medians(self) -> dict[str, float]:
        """`step_ms_median` and `phase_<name>_ms_median`, over the latest
        RECENT samples of each (snapshot first, as in `phases`)."""
        return {f"{k}_ms_median": 1e3 * statistics.median(v)
                for k, v in sorted(dict(self._recent).items()) if v}

    def pause(self) -> None:
        """Leave wall time out until the next tick (eval, checkpoint)."""
        self._last = None

    def rates(self) -> dict[str, float]:
        if not self._steps or self._elapsed <= 0.0:
            return {"steps_per_sec": 0.0, "items_per_sec_per_chip": 0.0}
        sps = self._steps / self._elapsed
        return {
            "steps_per_sec": sps,
            "items_per_sec_per_chip": sps * self.items_per_step,
        }

    def mark(self) -> tuple[float, int]:
        """Snapshot for `rewind`, taken when a checkpoint is saved."""
        return (self._elapsed, self._steps)

    def rewind(self, mark: tuple[float, int]) -> None:
        """Drop the time and steps since `mark` (a rollback discards
        those steps)."""
        self._elapsed, self._steps = mark
        self._last = None


def _fetch_with_retry(fetch, tree, seq: int, retries: int, backoff_s: float,
                      injector, count_retry):
    """The host read of a fetch on the bounded retry ladder
    (`resilience/healing.py`): a failed read, or an injected ``fetch``
    fault, is tried again up to `retries` times. `seq` is the fault
    site's index: the fetch's place in submit order."""

    def once():
        if injector is not None:
            injector.check("fetch", seq)
        return fetch(tree)

    return retry_bounded(once, retries=retries, backoff_s=backoff_s,
                         on_retry=count_retry)


class HostStager:
    """Takes a dict of metric tensors (or numbers) to the host as a dict
    of numpy arrays, in two halves: `stage` on the thread that launched
    the step, `read` on any thread.

    `stage` concatenates the values into one float32 vector; on the card
    it copies that vector (`non_blocking`) into a pinned host buffer on
    the current stream and records a CUDA event behind the copy, so the
    copy waits for the step that made the values and for nothing
    launched after it. `read` waits on that event alone and splits the
    buffer. The pinned buffers are a ring of `slots` (pinned allocation
    costs milliseconds): a buffer is reused `slots` stagings later, so a
    caller keeps at most `slots - 1` stagings unread."""

    def __init__(self, slots: int = 1):
        self._slots = max(int(slots), 1)
        self._bufs: list[torch.Tensor | None] = [None] * self._slots
        self._next = 0

    def stage(self, tree: dict):
        keys = list(tree)
        vals = [torch.as_tensor(tree[k]).detach() for k in keys]
        shapes = [tuple(v.shape) for v in vals]
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in vals])
        if flat.device.type != "cuda":
            return keys, shapes, flat, None
        i, self._next = self._next, (self._next + 1) % self._slots
        buf = self._bufs[i]
        if buf is None or buf.numel() < flat.numel():
            buf = self._bufs[i] = torch.empty(flat.numel(),
                                              dtype=torch.float32,
                                              pin_memory=True)
        host = buf[:flat.numel()]
        host.copy_(flat, non_blocking=True)
        # a blocking event: the reader sleeps in its wait, and spins no
        # core the launching thread and the prefetcher need
        event = torch.cuda.Event(blocking=True)
        event.record()
        return keys, shapes, host, event

    @staticmethod
    def read(staged) -> dict:
        keys, shapes, host, event = staged
        if event is not None:
            event.synchronize()
        arr = host.numpy().copy()  # the pinned buffer is reused
        out, pos = {}, 0
        for key, shape in zip(keys, shapes):
            n = int(np.prod(shape, dtype=np.int64))
            out[key] = arr[pos:pos + n].reshape(shape)
            pos += n
        return out


class AsyncFetcher:
    """Bounded-depth background drain of a step's metrics (the JAX
    package's `AsyncFetcher`).

    The main loop `submit()`s (tag, metrics, callback) and keeps
    dispatching; a consumer thread takes the values to the host and runs
    the callback with them. `submit()` blocks while `depth` submitted
    fetches are not yet done (counted under a condition variable, so
    admission and the `max_in_flight` witness are race-free): the host
    runs at most `depth` fetches ahead of the card. The default fetch is
    `HostStager`'s: staged on the submitting thread right after
    admission, read on the consumer thread, which waits for that step
    only. A `fetch_fn` replaces it (applied to the tree on the consumer
    thread). The queue itself is unbounded, so `close()` can always
    enqueue its stop sentinel, even past a consumer wedged in a read.

    A fetch or callback error is raised again on the next submit() or
    drain(). `stats()`: completed fetches, their seconds, retries and the
    largest number in flight."""

    _STOP = object()

    def __init__(self, depth: int = 2, fetch_fn=None,
                 timer: StepTimer | None = None, retries: int = 0,
                 backoff_s: float = 0.05, injector=None):
        self._depth = max(int(depth), 1)
        self._stager = (HostStager(self._depth + 1) if fetch_fn is None
                        else None)
        self._fetch = (fetch_fn if fetch_fn is not None
                       else HostStager.read)
        self._timer = timer
        self._retries = max(int(retries), 0)
        self._backoff = max(float(backoff_s), 0.0)
        self._inj = injector
        self._retry_count = 0
        self._seq = 0  # fetches consumed, = submit order (FIFO queue)
        self._q: queue.Queue = queue.Queue()  # unbounded; _cv is the bound
        self._exc: BaseException | None = None
        self._cv = threading.Condition()
        self._in_flight = 0
        self._max_in_flight = 0
        self._fetches = 0
        self._fetch_s = 0.0
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-fetcher")
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                self._q.task_done()
                return
            tag, tree, callback = item
            try:
                seq, self._seq = self._seq, self._seq + 1
                t0 = time.perf_counter()
                with obs_trace.span("fetch"):
                    host = _fetch_with_retry(self._fetch, tree, seq,
                                             self._retries, self._backoff,
                                             self._inj, self._count_retry)
                dt = time.perf_counter() - t0
                with self._cv:
                    self._fetches += 1
                    self._fetch_s += dt
                if self._timer is not None:
                    self._timer.phase("fetch", dt)
                callback(tag, host)
            except BaseException as e:  # noqa: BLE001 - raised on submit/drain
                self._exc = e
            finally:
                with self._cv:
                    self._in_flight -= 1
                    self._cv.notify()
                self._q.task_done()

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def submit(self, tag, tree, callback) -> None:
        """Enqueue a fetch; blocks while `depth` fetches are in flight."""
        self._raise_pending()
        with self._cv:
            while self._in_flight >= self._depth:
                self._cv.wait()
            self._in_flight += 1
            self._max_in_flight = max(self._max_in_flight, self._in_flight)
        if self._stager is not None:
            # after admission: the ring slot this takes is free
            tree = self._stager.stage(tree)
        self._q.put((tag, tree, callback))

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every submitted fetch has completed and its
        callback has run (before eval, a checkpoint and a rollback). With
        a timeout (the end of a fit), give up after `timeout` seconds and
        return False."""
        if timeout is None:
            self._q.join()
        else:
            deadline = time.monotonic() + timeout
            with self._q.all_tasks_done:
                while self._q.unfinished_tasks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                    self._q.all_tasks_done.wait(remaining)
        self._raise_pending()
        return True

    def _count_retry(self) -> None:
        self._retry_count += 1  # GIL-atomic; read by stats()

    def stats(self) -> dict[str, float]:
        with self._cv:
            return {"fetches": self._fetches,
                    "fetch_s": round(self._fetch_s, 4),
                    "fetch_retries": self._retry_count,
                    "max_in_flight": self._max_in_flight}

    def close(self) -> None:
        """Never blocks on a wedged consumer: the daemon thread is left
        after the join's timeout."""
        self._q.put(self._STOP)
        self._thread.join(timeout=5.0)


class SyncFetcher:
    """Depth 0 (`train.pipeline_depth = 0`): the fetch and the callback
    inline on the caller's thread, with `AsyncFetcher`'s interface, so
    the loop has one code path."""

    def __init__(self, fetch_fn=None, timer: StepTimer | None = None,
                 retries: int = 0, backoff_s: float = 0.05, injector=None):
        stager = HostStager()
        self._fetch = (fetch_fn if fetch_fn is not None
                       else lambda tree: stager.read(stager.stage(tree)))
        self._timer = timer
        self._retries = max(int(retries), 0)
        self._backoff = max(float(backoff_s), 0.0)
        self._inj = injector
        self._retry_count = 0
        self._fetches = 0
        self._fetch_s = 0.0

    def _count_retry(self) -> None:
        self._retry_count += 1

    def submit(self, tag, tree, callback) -> None:
        t0 = time.perf_counter()
        with obs_trace.span("fetch"):
            host = _fetch_with_retry(self._fetch, tree, self._fetches,
                                     self._retries, self._backoff,
                                     self._inj, self._count_retry)
        dt = time.perf_counter() - t0
        self._fetches += 1
        self._fetch_s += dt
        if self._timer is not None:
            self._timer.phase("fetch", dt)
        callback(tag, host)

    def drain(self, timeout: float | None = None) -> bool:
        return True

    def stats(self) -> dict[str, float]:
        return {"fetches": self._fetches, "fetch_s": round(self._fetch_s, 4),
                "fetch_retries": self._retry_count,
                "max_in_flight": 1 if self._fetches else 0}

    def close(self) -> None:
        pass


class ProfilerSession:
    """Optional `torch.profiler` capture (the JAX package's
    `ProfilerSession` on `jax.profiler`), written as a Chrome trace to
    `<log_dir>/profile/trace.json` (CPU and, on a CUDA device, CUDA
    activity).

    Two modes:
      - whole run (`enabled=True`, `steps=None`): from loop entry to
        teardown, the first step (kernel builds, cuDNN's search) included;
      - a step window (`steps=(a, b)`, `--profile-steps a:b`): the loop
        reports progress through `observe(gstep, k)`; the capture starts
        at the first call whose steps [gstep, gstep + k) reach into
        [a, b), and stops once gstep >= b. One window a session.
    """

    def __init__(self, log_dir: str, enabled: bool = False,
                 steps: tuple[int, int] | None = None,
                 device: torch.device | str = "cpu"):
        self.log_dir = os.path.join(log_dir, "profile")
        if steps is not None:
            start, stop = int(steps[0]), int(steps[1])
            if not 0 <= start < stop:
                raise ValueError(
                    f"profile step window must be 0 <= start < stop, "
                    f"got {steps}")
            steps = (start, stop)
        self.steps = steps
        self.enabled = enabled or steps is not None
        self._cuda = torch.device(device).type == "cuda"
        self._prof = None
        self._done = False

    def maybe_start(self) -> None:
        """Loop entry: the whole-run mode starts here."""
        if self.enabled and self.steps is None and self._prof is None:
            self._start()

    def observe(self, gstep: int, steps_per_call: int = 1) -> None:
        """Once per loop iteration, before the call that runs steps
        [gstep, gstep + steps_per_call)."""
        if not self.enabled or self.steps is None or self._done:
            return
        start, stop = self.steps
        if self._prof is not None:
            if gstep >= stop:
                self._stop()
                self._done = True
        elif gstep < stop and gstep + max(steps_per_call, 1) > start:
            self._start()

    def maybe_stop(self) -> None:
        if self._prof is not None:
            self._stop()

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
