"""Lock-cheap, ring-buffered span tracer -> Chrome trace-event JSON (a
copy of `deepof_tpu/obs/trace.py`, which is stdlib-only).

Every instrumented site (`train/loop.py` input_wait/dispatch/eval/ckpt/
rollback, `train/metrics_log.py` fetch, `data/prefetch.py` put,
`data/pipeline.py` worker assemble) calls the module-level
`span(name, **args)`; with no tracer installed that is one global read +
a shared no-op context manager, so instrumentation costs nothing when
tracing is off and the instrumented modules never need a tracer
threaded through their constructors.

Design constraints, in order:

  - The hot path takes NO lock: completed spans are appended to a
    `collections.deque(maxlen=ring_size)` — append and the implicit
    oldest-eviction are single C-level ops, atomic under the GIL, so
    pipeline workers / prefetch / fetcher / main all record concurrently
    without contending. Memory is bounded by construction: the ring
    keeps the newest `ring_size` spans (the window that matters when a
    watchdog fires).
  - Timestamps come from `time.perf_counter()` (CLOCK_MONOTONIC —
    comparable across threads of one process), rebased to the tracer's
    construction so `ts` starts near zero.
  - `flush()` writes the Chrome trace-event format (JSON object with a
    `traceEvents` list of "X" complete events + "M" thread-name
    metadata) atomically (tmp + rename), so a viewer — or the watchdog,
    which flushes mid-run — never reads a torn file. Perfetto and
    chrome://tracing both load it directly.

Stdlib-only.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import deque

#: CPython's auto-generated thread names ("Thread-12 (handler_func)"):
#: ThreadingHTTPServer spawns one uniquely-auto-named thread per HTTP
#: request, and keying tracks by (tid, emit-time name) would otherwise
#: mint one single-span track per REQUEST once idents recycle. The
#: serial number carries no identity — collapse it so every
#: auto-named thread running the same function shares one track name,
#: while explicitly-named threads (prefetch, serve-batcher,
#: pipeline-worker-N, ...) keep the full recycle-split fix.
_AUTO_THREAD_NAME = re.compile(r"^Thread-\d+( \(.*\))?$")


class _NullSpan:
    """Shared, stateless no-op context manager (safe to re-enter from
    any number of threads at once)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        """No-op counterpart of _Span.set."""


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The uninstalled state: every operation is a no-op."""

    path: str | None = None

    def span(self, name: str, **args) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args) -> None:
        pass

    def flush(self, path: str | None = None) -> str | None:
        return None


class _Span:
    """One live span: created by Tracer.span, records on __exit__."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def set(self, **args) -> None:
        """Attach args discovered DURING the span (e.g. the batcher
        learns its request ids only while accumulating the batch)."""
        if self._args is None:
            self._args = {}
        self._args.update(args)

    def __exit__(self, *exc) -> bool:
        self._tracer._record(self._name, self._t0, time.perf_counter(),
                             self._args)
        return False


class Tracer:
    """Ring-buffered span recorder; see module docstring.

    path: default flush destination (conventionally
        `<log_dir>/trace.json`).
    ring_size: max retained events — spans beyond it evict the oldest
        (bounded memory; a full training run keeps its newest window).
    role / index: process identity stamped into the trace (process_name
        metadata + otherData) so obs/aggregate.py can merge many
        processes' traces into one fleet timeline — "trainer-1",
        "replica-0", "router", "coordinator".
    """

    def __init__(self, path: str | None = None, ring_size: int = 16384,
                 role: str | None = None, index: int | None = None):
        self.path = path
        self.ring_size = max(int(ring_size), 16)
        self.role = role
        self.index = index
        self._events: deque = deque(maxlen=self.ring_size)
        self._epoch = time.perf_counter()
        self._epoch_unix = time.time()
        # tid -> thread name registry (historical record: a thread whose
        # every event was evicted from the ring is still named in the
        # metadata). NOT the source of truth for event->name binding —
        # each event records its thread's name at EMIT time, so a tid
        # the OS recycled onto a later, differently-named thread cannot
        # retroactively rename earlier spans (a last-writer-wins
        # hazard); events() splits such a tid into per-name tracks.
        self._threads: dict[int, str] = {}
        self._dropped = 0  # informational; deque eviction is implicit

    # ------------------------------------------------------------ record
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args or None)

    def instant(self, name: str, **args) -> None:
        """A zero-duration marker (ph='i') — e.g. the watchdog's wedge."""
        now = time.perf_counter()
        tname = self._note_thread()
        self._events.append(("i", name, threading.get_ident(), tname,
                             (now - self._epoch) * 1e6, 0.0, args or None))

    def _note_thread(self) -> str:
        # the registry write is one GIL-atomic dict op; the RETURNED
        # name is what binds the event (emit-time capture — see __init__)
        name = threading.current_thread().name
        m = _AUTO_THREAD_NAME.match(name)
        if m:  # auto-named ephemeral: drop the per-thread serial
            name = "Thread" + (m.group(1) or "")
        self._threads[threading.get_ident()] = name
        return name

    def _record(self, name: str, t0: float, t1: float,
                args: dict | None) -> None:
        tname = self._note_thread()
        if len(self._events) == self.ring_size:
            self._dropped += 1  # append below evicts the oldest
        self._events.append(("X", name, threading.get_ident(), tname,
                             (t0 - self._epoch) * 1e6, (t1 - t0) * 1e6,
                             args))

    # ------------------------------------------------------------- flush
    def process_name(self) -> str:
        """The track label for this process in a merged fleet trace."""
        if self.role is None:
            return "deepof_tpu_torch"
        return (self.role if self.index is None
                else f"{self.role}-{self.index}")

    def events(self) -> list[dict]:
        """Chrome trace-event dicts for the current ring contents.

        Thread tracks are keyed by (tid, emit-time name): a tid the OS
        recycled across differently-named threads splits into one track
        per name (the first name keeps the real tid; later names get
        synthetic tids), so every span renders under the thread that
        actually emitted it."""
        pid = os.getpid()
        out: list[dict] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": self.process_name()},
        }]
        # snapshot first (C-level copies are GIL-atomic; iterating the
        # live deque while writers append is not)
        threads = dict(self._threads)
        events = list(self._events)
        track: dict[tuple[int, str], int] = {}
        used: set[int] = set()
        next_synthetic = max([e[2] for e in events] + list(threads)
                             + [0]) + 1

        def tid_for(tid: int, tname: str) -> int:
            nonlocal next_synthetic
            key = (tid, tname)
            mapped = track.get(key)
            if mapped is None:
                if tid not in used:
                    mapped = tid
                else:  # recycled ident: a fresh synthetic track
                    mapped = next_synthetic
                    next_synthetic += 1
                used.add(mapped)
                track[key] = mapped
            return mapped

        body: list[dict] = []
        for ph, name, tid, tname, ts, dur, args in events:
            ev: dict = {"ph": ph, "name": name, "cat": "obs", "pid": pid,
                        "tid": tid_for(tid, tname), "ts": round(ts, 1)}
            if ph == "X":
                ev["dur"] = round(dur, 1)
            else:
                ev["s"] = "g"  # instants render process-wide
            if args:
                ev["args"] = args
            body.append(ev)
        # registry-only threads (all their events evicted) still get a
        # track name; an entry contradicting an emit-time binding maps
        # to its own synthetic track instead of renaming the real one
        for tid in sorted(threads):
            tid_for(tid, threads[tid])
        for (tid, tname), mapped in sorted(track.items(),
                                           key=lambda kv: kv[1]):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": mapped, "args": {"name": tname}})
        out.extend(body)
        return out

    def flush(self, path: str | None = None) -> str | None:
        """Atomically write the trace file; safe to call repeatedly and
        from any thread (the watchdog flushes mid-run, fit() at close —
        later flushes simply rewrite with more events)."""
        path = path or self.path
        if path is None:
            return None
        payload = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {
                "trace_epoch_unix": self._epoch_unix,
                "ring_size": self.ring_size,
                "dropped_spans": self._dropped,
                # process identity for obs/aggregate.py's fleet merge
                "role": self.role,
                "index": self.index,
                "pid": os.getpid(),
            },
        }
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".{os.path.basename(path)}.tmp.{os.getpid()}")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        return path


# --------------------------------------------------------------- current
# Module-level current tracer: instrumented code calls obs.trace.span()
# unconditionally; fit() installs a real Tracer for its lifetime when
# ObsConfig.trace is on and uninstalls (back to the no-op) in its finally.
_NULL = NullTracer()
_current: Tracer | NullTracer = _NULL
_install_lock = threading.Lock()


def install(tracer: Tracer) -> Tracer:
    """Make `tracer` the process-current tracer (returns it)."""
    global _current
    with _install_lock:
        _current = tracer
    return tracer


class _Installed:
    """Scope guard returned by installed(); see its docstring."""

    def __init__(self, tracer: Tracer | None):
        self.tracer = tracer

    def __enter__(self) -> Tracer | None:
        return self.tracer

    def __exit__(self, *exc) -> bool:
        if self.tracer is not None:
            uninstall()
            try:
                self.tracer.flush()
            except OSError:
                pass
        return False


def installed(tracer: Tracer | None) -> _Installed:
    """Install `tracer` for the duration of a with-block and make the
    teardown STRUCTURAL: uninstall + best-effort flush on ANY exit —
    clean return, SIGTERM-driven drain, or a failure anywhere in the
    body (a bind error, a failed restore/compile). The spans leading
    into a startup failure are exactly what an early-installed tracer
    exists to capture, and the process-global current tracer must never
    outlive its run (a later run would silently record into the dead
    ring). `tracer=None` (tracing off) makes the whole block a no-op,
    so call sites need no conditional."""
    if tracer is not None:
        install(tracer)
    return _Installed(tracer)


def uninstall() -> None:
    """Back to the no-op tracer."""
    global _current
    with _install_lock:
        _current = _NULL


def current() -> Tracer | NullTracer:
    return _current


def span(name: str, **args):
    """Record a span on the current tracer (no-op when none installed)."""
    return _current.span(name, **args)


def instant(name: str, **args) -> None:
    _current.instant(name, **args)


def flush_current(path: str | None = None) -> str | None:
    """Flush the installed tracer (the watchdog's entry point)."""
    return _current.flush(path)
