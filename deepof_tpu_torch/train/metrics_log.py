"""Structured metrics log and step timing (port of `MetricsLogger` and
`StepTimer` from `deepof_tpu/train/metrics_log.py`).

Every record is one JSON line in `<log_dir>/metrics.jsonl`, mirrored to
stdout. `StepTimer` reports steps/s and pairs/s over training time only,
per-phase host seconds and event counters.

The JAX loop drains metric values on a background `AsyncFetcher` (or
inline through `SyncFetcher`), because its steps return device arrays.
This package's step reads its metrics back as host floats, so `fit`
runs its metrics callback inline and neither fetcher is ported.
"""

from __future__ import annotations

import collections
import json
import math
import os
import statistics
import threading
import time

import numpy as np


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
    the device, on the prefetch thread), `dispatch` (the step, metric
    read-back included). `count(name)` accumulates event counters
    (`starved`: steps whose input wait exceeded 1 ms; `skipped_updates`,
    `rollbacks`).

    `medians()` gives the median host-clock time of a timed step (tick
    to tick) and of each phase, over the latest RECENT of each; steps a
    rollback discards still count there, since they took that time.
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

    def tick(self) -> None:
        """Record a completed step."""
        now = time.perf_counter()
        if self._last is not None:
            self._elapsed += now - self._last
            self._steps += 1
            self._sample("step", now - self._last)
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
