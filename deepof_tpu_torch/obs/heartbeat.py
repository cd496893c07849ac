"""Liveness heartbeat + wedge watchdog (a copy of
`deepof_tpu/obs/heartbeat.py`, with the device memory of the loop's CUDA
device from `obs/telemetry.py`).

The failure mode this instrument exists for: a host thread of the loop
wedges (a hung device call, a stuck read) and the run goes silent — no
log line, no crash, nothing to diagnose. Two halves:

  Heartbeat file: a background thread atomically rewrites
  `heartbeat.json` every `period_s` with the last completed step, rates,
  queue/staged depths (caller-provided sample callback), device memory,
  process RSS, and the age of the last step. "Is it making progress?"
  becomes one `cat`, even from outside the process, and the atomic
  tmp+rename rewrite means a reader never sees a torn file.

  Wedge watchdog: the loop calls `beat(step)` at each completed
  dispatch; the watchdog keeps a robust (median) estimate of recent
  step times and declares a wedge when no step completes within
  `watchdog_factor x` that estimate (floored by `watchdog_min_s` so
  normal jitter and short stalls never fire). On a wedge it dumps EVERY
  thread's stack to the metrics log — naming which thread is stuck
  where — flushes the trace ring (the timeline leading into the stall
  survives), and marks `wedged: true` in the heartbeat file. One firing
  per stall: the state re-arms when steps resume.

The watchdog only observes and reports — it never kills the process
(policy belongs to the operator / the SIGTERM paths in train/loop.py);
`on_wedge` is the hook for anything stronger. Long legitimate pauses
(eval sweeps, checkpoint saves, compiles) are handled by `touch()`,
which resets the activity clock without polluting the step-time
estimate, plus the arm threshold of `MIN_BEATS_TO_ARM` completed steps.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable

import torch

from . import trace as obs_trace
from .telemetry import device_memory_summary, process_rss_bytes

#: Completed steps before the watchdog arms: the first dispatches include
#: the kernels' build and cuDNN's algorithm search, whose duration must
#: neither trip the watchdog nor enter the step-time estimate as a
#: "recent step".
MIN_BEATS_TO_ARM = 3


def dump_all_stacks() -> str:
    """Every live thread's stack, name first — the wedge diagnosis.
    `sys._current_frames` is CPython-specific but this repo already
    depends on CPython threading semantics throughout."""
    names = {t.ident: t.name for t in threading.enumerate()}
    parts = []
    for tid, frame in sorted(sys._current_frames().items()):
        header = f"--- thread {names.get(tid, '<unknown>')} (tid={tid}) ---"
        parts.append(header + "\n" + "".join(traceback.format_stack(frame)))
    return "\n".join(parts)


def _median(xs) -> float:
    return statistics.median(xs) if xs else 0.0


class Heartbeat:
    """See module docstring.

    path: heartbeat.json destination (atomically rewritten).
    period_s: rewrite cadence; also the watchdog poll cadence.
    watchdog_factor: k in "wedged when no step for k x median step time".
    watchdog_min_s: wedge-age floor — below this, never declare (keeps
        sub-second-step runs from flagging scheduler hiccups).
    sample: optional () -> dict merged into each heartbeat record
        (rates, queue depths, ...); exceptions are contained.
    log: optional (step, message) sink for the wedge report
        (MetricsLogger-shaped: lands in metrics.jsonl as a warn record).
    tracer: optional obs.trace.Tracer flushed when a wedge fires.
    on_wedge: optional (stack_dump_str) hook after the dump is logged.
    device: the loop's device. A CUDA device's memory is sampled on a
        background thread; for the CPU (or None) the dev_mem_* keys stay
        present as nulls, so the schema is stable.
    """

    def __init__(self, path: str, period_s: float = 5.0,
                 watchdog_factor: float = 20.0, watchdog_min_s: float = 60.0,
                 sample: Callable[[], dict] | None = None,
                 log: Callable[[int, str], None] | None = None,
                 tracer=None, on_wedge: Callable[[str], None] | None = None,
                 window: int = 64, device=None):
        self.path = path
        self._period = max(float(period_s), 0.05)
        self._factor = max(float(watchdog_factor), 1.0)
        self._min_s = max(float(watchdog_min_s), 0.0)
        self._sample = sample
        self._log = log
        self._tracer = tracer
        self._on_wedge = on_wedge
        self._lock = threading.Lock()
        # serializes file writes: touch(flush=True) writes from the
        # CALLING thread, racing the background writer — both use the
        # same pid-derived tmp path, and an interleaved truncate/write
        # could promote torn JSON into heartbeat.json via os.replace
        self._write_lock = threading.Lock()
        self._durs: deque = deque(maxlen=max(int(window), 4))
        self._last_activity = time.monotonic()
        self._beats = 0
        self._last_step = 0
        self._wedge_active = False
        self._wedges = 0
        self._stop = threading.Event()
        # Device-memory sampling runs on its OWN thread, feeding a cached
        # snapshot: memory_stats() crosses into the CUDA runtime, and a
        # hung device would otherwise wedge the heartbeat/watchdog thread
        # itself — the instrument must outlive the failure it diagnoses.
        # A hang there only stales the cached values; the watchdog keeps
        # polling.
        self._devmem: dict = {"dev_mem_bytes_in_use": None,
                              "dev_mem_peak_bytes": None}
        self._device = device
        self._sampler = None
        if device is not None and torch.device(device).type == "cuda":
            self._sampler = threading.Thread(target=self._sample_devices,
                                             daemon=True, name="obs-devmem")
            self._sampler.start()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="obs-heartbeat")
        self._thread.start()

    # ------------------------------------------------------------ inputs
    def beat(self, step: int) -> None:
        """A step completed: record its duration, re-arm the watchdog."""
        now = time.monotonic()
        with self._lock:
            self._durs.append(now - self._last_activity)
            self._last_activity = now
            self._beats += 1
            self._last_step = int(step)
            self._wedge_active = False

    def touch(self, flush: bool = False) -> None:
        """Activity that is not a step (eval, checkpoint, rollback):
        resets the wedge clock without entering the step-time estimate.

        flush=True additionally rewrites heartbeat.json NOW, from the
        calling thread. Use it when entering a long GIL-bound phase (an
        eval sweep's host-side resizes and AEE): on a contended host the
        background writer thread can starve for the whole phase, so a
        supervisor reading the file would see a stale timestamp. A
        synchronous write on entry re-bases that reader's staleness
        clock to the phase start."""
        with self._lock:
            self._last_activity = time.monotonic()
            self._wedge_active = False
        if flush:
            self._write()

    # ----------------------------------------------------------- sampling
    def _snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            durs = list(self._durs)
            rec = {
                "time": time.time(),
                "pid": os.getpid(),
                "step": self._last_step,
                "beats": self._beats,
                "last_step_age_s": round(now - self._last_activity, 3),
                "step_time_median_s": round(_median(durs), 4) if durs else None,
                "heartbeat_period_s": self._period,
                "wedged": self._wedge_active,
                "wedges": self._wedges,
            }
        rec["rss_bytes"] = process_rss_bytes()
        rec.update(self._devmem)  # cached by the obs-devmem thread
        if self._sample is not None:
            try:
                rec.update(self._sample() or {})
            except Exception as e:  # noqa: BLE001 - sampling is best-effort
                rec["sample_error"] = f"{type(e).__name__}: {e}"
        return rec

    def _write(self) -> None:
        with self._write_lock:  # flush-from-caller vs writer thread
            rec = self._snapshot()
            try:
                d = os.path.dirname(os.path.abspath(self.path))
                os.makedirs(d, exist_ok=True)
                tmp = os.path.join(
                    d, f".{os.path.basename(self.path)}.tmp.{os.getpid()}")
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                os.replace(tmp, self.path)  # readers never see a torn file
            except OSError:
                pass  # read-only tree must not crash the heartbeat thread

    # ----------------------------------------------------------- watchdog
    def _check_wedge(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._beats < MIN_BEATS_TO_ARM or self._wedge_active:
                return
            est = _median(self._durs)
            age = now - self._last_activity
            threshold = max(self._factor * est, self._min_s)
            if age <= threshold:
                return
            # declare INSIDE the lock so a concurrent beat() can't race a
            # half-fired wedge; the heavy reporting happens outside it
            self._wedge_active = True
            self._wedges += 1
            step = self._last_step
        dump = dump_all_stacks()
        msg = (f"WATCHDOG: no step completed for {age:.1f}s "
               f"(> max({self._factor:g} x median {est:.3f}s, "
               f"{self._min_s:g}s)) — wedged? All thread stacks:\n{dump}")
        if self._log is not None:
            try:
                self._log(step, msg)
            except Exception:  # noqa: BLE001 - reporting must not raise here
                pass
        tracer = self._tracer if self._tracer is not None \
            else obs_trace.current()
        try:
            tracer.instant("watchdog_wedge", age_s=round(age, 1))
            tracer.flush()  # the timeline leading into the stall survives
        except Exception:  # noqa: BLE001
            pass
        if self._on_wedge is not None:
            try:
                self._on_wedge(dump)
            except Exception:  # noqa: BLE001
                pass

    # ------------------------------------------------------------- threads
    def _sample_devices(self) -> None:
        while True:
            try:
                # atomic rebind
                self._devmem = device_memory_summary(self._device)
            except Exception:  # noqa: BLE001 - sampling must never raise
                pass
            if self._stop.wait(self._period):
                return

    def _run(self) -> None:
        while not self._stop.wait(self._period):
            self._check_wedge()
            self._write()
        self._write()  # final state on close: fresh file at exit

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self._period + 5.0)
        if self._sampler is not None:
            # a sampler wedged inside a hung device call is abandoned
            # (daemon)
            self._sampler.join(timeout=1.0)
