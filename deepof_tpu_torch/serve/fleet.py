"""Self-healing serving fleet: N supervised replica processes (port of
`deepof_tpu/serve/fleet.py`).

One supervisor (`Fleet`) spawns each replica as a `python -m
deepof_tpu_torch serve --config-json <replica-dir>/config.json --device
<dev>` subprocess on an ephemeral port (`serve.port=0`; the replica
announces its bound port on the first line of its stdout), and a
monitor thread runs every replica through a small state machine:

    starting -> ready -> terminating -> backoff -> starting ...
                                  \\-> broken (circuit breaker)

Health gating reuses the serve heartbeat: each replica's
`heartbeat.json` (rewritten every obs.heartbeat_period_s, wedge-watchdog
verdict included) is the supervisor's input. A replica is evicted —
SIGTERM for graceful drain, SIGKILL after `fleet.term_grace_s` — when
its heartbeat goes stale, its watchdog marks `wedged: true`, its
heartbeat shows requests in flight and nothing completing for
`fleet.stall_after_s`, or its process dies outright (kill -9, OOM,
crash). Respawns back off exponentially (`fleet.backoff_s * 2^k`,
capped), and a replica that keeps dying within `fleet.healthy_after_s`
of becoming ready trips the circuit breaker after
`fleet.crash_loop_threshold` consecutive fast failures: it stays down
(state `broken`), surfaced in the fleet counters, instead of burning
backoff forever while masking the defect.

The chaos sites `replica_crash` / `replica_wedge` / `replica_degrade`
(resilience/faults.py, armed by `serve/server.py::
install_replica_faults`) inject exactly these failures
deterministically: each replica process rebuilds the injector from the
shared config and its own `DEEPOF_TPU_REPLICA` index.

Replicas inherit the supervisor's exact config (`serve.precisions`,
`serve.buckets`, `serve.session.*` and the fault schedule round-trip
through the replica's config.json), each with its own
`train.log_dir = <log_dir>/replica-<i>`, `serve.port=0` and
`fleet.replicas=0`. A replica that serves a model restores the newest
checkpoint under ITS OWN `<log_dir>/replica-<i>/ckpt`, as the JAX
package's replicas do (ROADMAP F16): the checkpoint of a trained run
must be placed there (a link will do). Session state is replica-local —
an evicted replica takes its sessions with it, and the router demotes
those to structured `session_lost` replies.

On the card: every replica is a process with a CUDA context of its own
(the card time-slices between them), and the supervisor creates none.
Before it spawns model replicas it readies the libraries they launch
once (`prebuild_libraries`: `engine.serve_libraries`, fetched from the
artifact store under `serve.artifacts_dir`, else built by nvcc), so N
replicas booting at once load libraries that are already there.

The artifact store (`serve/artifacts.py`) rides each replica's config
as an absolute path, so every replica, a respawn and an autoscaler's
spawn boot from the same store. A graceful retirement and the fleet's
close sweep it (`gc_store`): corrupt entries and orphaned staging, and
with `serve.fleet.artifacts_gc_days` > 0 entries older than that,
except the index's targets and every fingerprint of a replica's ledger.

`run_fleet` is the `serve --replicas N` (and `--autoscale`) entry: fleet
+ front router (serve/router.py) + the autoscaler (serve/autoscale.py)
and the brownout controller (serve/degrade.py) when configured + a fleet
heartbeat whose `fleet_*` counter block (evictions, respawns,
failovers, shed, per-replica states) lands in `heartbeat.json` and the
shutdown metrics record. Shutdown and SIGTERM drain gracefully: stop
admission at the router, flush in-flight requests, then SIGTERM (and if
needed SIGKILL) the replicas.

Under `obs.incidents` the supervisor installs its own incident recorder
(`obs/incident.py`, role "fleet", the run root's incidents/): an
eviction (`fleet_eviction`), a crash (`fleet_replica_crash`), a tripped
circuit breaker (`fleet_broken`), the router's exhausted fleet SLO, the
brownout controller's L3 entry (`brownout_l3`) and a wedge of the
supervisor itself commit critical bundles, and every poll (and the
close) collects the replicas' own bundles from `replica-<i>/incidents`
into the run root.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

from ..core import supervise
from ..core.config import ExperimentConfig
from ..obs import incident
from .artifacts import store_root
from .server import REPLICA_ENV

#: Replica lifecycle states (Fleet._check is the transition table).
#: "spawning" is the transient claim a monitor pass holds while it runs
#: the (lock-free) process spawn for a slot. "retiring"/"retired" are
#: the autoscaler's graceful scale-down path (serve/autoscale.py):
#: routed around, drained, SIGTERMed, reaped — never counted as an
#: eviction, because nothing was sick.
STATES = ("spawning", "starting", "ready", "terminating", "backoff",
          "broken", "stopped", "retiring", "retired")


class _Replica(supervise.Child):
    """Supervisor-side record of one replica slot. All mutation happens
    under the fleet lock; the router sees only immutable snapshots."""

    def __init__(self, idx: int):
        super().__init__(idx, "stopped")
        self.port: int | None = None
        self.ready_m: float | None = None
        self.term_deadline = 0.0
        self.backoff_until = 0.0
        self.fast_failures = 0


def _serve_in_flight(hb: dict) -> bool:
    """The fleet's stall gate for the shared heartbeat verdict: the
    stall clock is meaningful only while work is in flight (submitted >
    answered — last_step_age_s only resets on beat() or the idle
    touch(), and the serve sample touch()es only when everything
    submitted is answered)."""
    return (hb.get("serve_requests", 0) - hb.get("serve_responses", 0)
            - hb.get("serve_errors", 0)) > 0


class Fleet:
    """See module docstring.

    cfg: the fleet-level experiment config; each replica gets a copy
        with its own log_dir, serve.port=0, and fleet.replicas=0
        serialized to <replica-dir>/config.json.
    replicas: replica count (overrides cfg.serve.fleet.replicas).
    device: the replicas' device ("cuda" or "cpu"), passed on their
        command line; the supervisor itself never touches it.
    """

    def __init__(self, cfg: ExperimentConfig, replicas: int | None = None,
                 device: str = "cuda"):
        self.cfg = cfg
        self.device = str(device)
        self.fc = cfg.serve.fleet
        n = int(replicas) if replicas is not None else int(self.fc.replicas)
        n = max(n, 1)
        if self.fc.autoscale:
            lo = max(int(self.fc.min_replicas), 1)
            hi = max(int(self.fc.max_replicas), 1)
            if lo > hi:
                raise ValueError(
                    f"serve.fleet.min_replicas={self.fc.min_replicas} > "
                    f"max_replicas={self.fc.max_replicas}: the autoscale "
                    "bounds are unsatisfiable — fix the config rather "
                    "than let the pool pick a side")
            # the autoscaler owns the pool size between its bounds:
            # start inside them whatever --replicas said
            n = min(max(n, lo), hi)
        self.dir = cfg.train.log_dir
        self.host = cfg.serve.host
        self._lock = threading.RLock()
        self._replicas = [_Replica(i) for i in range(n)]
        self._counters = {k: 0 for k in (
            "spawns", "respawns", "evictions", "crashes", "clean_exits",
            "wedge_evictions", "stale_evictions", "spawn_failures",
            "kill_escalations", "broken", "retired")}
        self._stopping = False
        self._active = n  # cached non-retired slot count (see size)
        self._wake = threading.Event()
        # scale-down hook (run_fleet wires the router's map aging):
        # called with the retired slot's idx AFTER the replica is gone
        self.on_retired = None
        # the supervisor's incident recorder (run_fleet installs it under
        # obs.incidents). Triggers fire inside the locked state machine,
        # so they queue here and _drain_incidents captures them after
        # the lock is released (a capture writes to disk)
        self.incidents = None
        self._pending_incidents: list[tuple[str, str, dict]] = []
        self._monitor = threading.Thread(target=self._run, daemon=True,
                                         name="fleet-monitor")

    @property
    def size(self) -> int:
        """ACTIVE replica slots (everything but retired) — the modulus
        of the router's affinity map and its sticky-cap factor. Fixed
        for a plain fleet; shrinks/grows with the autoscaler's scale
        events (slot indices stay monotonic — a retired index is never
        reused, so per-index maps can age it out unambiguously). A
        cached integer, maintained under the lock at the two mutation
        sites (scale_up append, retire_one retirement) and read without
        it — the router reads this up to three times per request, and
        iterating a monotonically-growing slot list under the fleet
        lock on the proxy hot path would contend with the monitor."""
        return self._active

    # ------------------------------------------------------------ start
    def start(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with self._lock:
            for r in self._replicas:
                r.state = "spawning"  # claim every slot before spawning
        for r in self._replicas:
            self._spawn(r)
        self._monitor.start()

    def wait_ready(self, min_ready: int = 1, timeout_s: float = 180.0) -> None:
        """Block until `min_ready` replicas are serving (TimeoutError
        otherwise, naming each replica's state for the operator)."""
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        while True:
            # drive transitions ourselves: callers may wait before the
            # monitor's first poll tick
            self._poll_all()
            now = time.monotonic()
            with self._lock:
                ready = sum(r.state == "ready" for r in self._replicas)
                states = {f"replica-{r.idx}": r.state for r in self._replicas}
            if ready >= min_ready:
                return
            if now >= deadline:
                raise TimeoutError(
                    f"only {ready}/{min_ready} replicas ready after "
                    f"{timeout_s}s: {states}")
            time.sleep(0.05)

    # ------------------------------------------------------------ spawn
    def _replica_dir(self, r: _Replica) -> str:
        return os.path.join(self.dir, f"replica-{r.idx}")

    def _spawn(self, r: _Replica) -> None:
        """Spawn one replica process for a slot already claimed (state
        "spawning") under the lock. The filesystem work and the
        fork+exec run WITHOUT the fleet lock — the router's
        ready_replicas() must not stall behind a respawn — and only the
        field publication at the end takes it."""
        rdir = self._replica_dir(r)
        rcfg = self.cfg.replace(
            train=dataclasses.replace(self.cfg.train, log_dir=rdir),
            serve=dataclasses.replace(
                self.cfg.serve, port=0,
                # absolute: a replica's cwd never decides its store
                artifacts_dir=store_root(self.cfg) or "",
                fleet=dataclasses.replace(self.fc, replicas=0,
                                          autoscale=False)))
        try:
            cfg_path = supervise.prepare_child_dir(rdir, rcfg)
            env = supervise.child_env(extra={REPLICA_ENV: str(r.idx)})
            with open(os.path.join(rdir, "stderr.log"), "ab") as stderr:
                proc = supervise.spawn_child(
                    [sys.executable, "-m", "deepof_tpu_torch", "serve",
                     "--config-json", cfg_path, "--device", self.device],
                    env, subprocess.PIPE, stderr, text=True)
        except OSError:
            # fork/fd exhaustion or an unwritable replica dir — most
            # likely under exactly the load that triggered a scale-up.
            # The claimed slot must not stay a zombie "spawning" entry
            # (the monitor skips that state forever): count it and
            # route it through the same backoff/breaker ladder a
            # spawn_failed death takes, so the monitor retries or opens
            # the breaker.
            with self._lock:
                r.last_exit = None
                r.last_reason = "spawn_failed"
                self._counters["spawn_failures"] += 1
                self._counters["evictions"] += 1
                self._schedule_backoff(r)
                self._log_event(r, "spawn failed (OSError); "
                                   "scheduling respawn")
            return
        with self._lock:
            if self._stopping:  # lost the race with close(): don't orphan
                supervise.kill_quietly(proc)  # served nothing: no drain owed
                proc.wait()
                r.state = "stopped"
                return
            r.proc = proc
            r.incarnation += 1
            r.state = "starting"
            r.port = None
            r.ready_m = None
            r.started_m = time.monotonic()
            self._counters["spawns"] += 1
        threading.Thread(target=self._read_stdout, args=(r, proc),
                         daemon=True,
                         name=f"fleet-stdout-{r.idx}").start()

    def _read_stdout(self, r: _Replica, proc: subprocess.Popen) -> None:
        """First stdout line is the replica's announce JSON (bound port);
        the rest is teed to <replica-dir>/stdout.log so the pipe never
        fills."""
        try:
            line = proc.stdout.readline()
            port = None
            try:
                serving = json.loads(line).get("serving", "")
                port = int(str(serving).rsplit(":", 1)[1].rstrip("/"))
            except (ValueError, IndexError, json.JSONDecodeError):
                pass
            with self._lock:
                if r.proc is proc:  # not already respawned
                    r.port = port
            self._wake.set()
            with open(os.path.join(self._replica_dir(r), "stdout.log"),
                      "a") as f:
                if line:
                    f.write(line)
                for line in proc.stdout:
                    f.write(line)
        except (OSError, ValueError):
            pass

    # ---------------------------------------------------------- monitor
    def _run(self) -> None:
        while True:
            self._wake.wait(timeout=max(float(self.fc.poll_s), 0.05))
            self._wake.clear()
            if self._stopping:
                return
            self._poll_all()

    def _poll_all(self) -> None:
        """One health pass over every slot. Three phases so the fleet
        lock — which the router's per-request ready_replicas() also
        takes — is never held across blocking I/O: (1) snapshot what
        needs probing, (2) run the TCP listen probes and heartbeat file
        reads UNLOCKED, (3) apply transitions under the lock (each
        _check re-validates state, so a transition that raced the probe
        just uses slightly stale health data — one period old at
        worst). Respawns _check claimed run after the lock is
        released."""
        now = time.monotonic()
        with self._lock:
            probe_ports = {r.idx: r.port for r in self._replicas
                           if r.state == "starting" and r.port is not None}
            hb_reads = [r for r in self._replicas if r.state == "ready"]
        listening = {idx: supervise.listening(self.host, port)
                     for idx, port in probe_ports.items()}
        heartbeats = {r.idx: self._read_heartbeat(r) for r in hb_reads}
        with self._lock:
            to_spawn = [r for r in self._replicas
                        if self._check(r, now, listening, heartbeats)]
        self._drain_incidents()
        for r in to_spawn:
            self._spawn(r)

    def _check(self, r: _Replica, now: float, listening: dict,
               heartbeats: dict) -> bool:
        """One replica's state-machine step (fleet lock held; probe/
        heartbeat results gathered unlocked by _poll_all). Returns True
        when the slot was claimed for a respawn the caller must perform
        (outside the lock)."""
        if r.state in ("stopped", "broken", "spawning", "retired",
                       "retiring"):
            # "retiring" is owned end to end by retire_one (autoscale
            # scale-down): already out of rotation, being drained —
            # the health machine must not evict or respawn it
            return False
        alive = r.proc is not None and r.proc.poll() is None
        if r.state == "starting":
            if not alive:
                self._on_death(r, "spawn_failed")
            elif r.port is not None and listening.get(r.idx):
                r.state = "ready"
                r.ready_m = now
            elif now - r.started_m > float(self.fc.spawn_timeout_s):
                self._evict(r, "spawn_timeout", now)
        elif r.state == "ready":
            if not alive:
                self._on_death(r, "crashed")
                return False
            if now - r.ready_m >= float(self.fc.healthy_after_s):
                r.fast_failures = 0  # proved healthy: crash-loop reset
            # shared pid-gated verdict (core/supervise.py): wedged is
            # the replica's own watchdog, stalled the supervisor-side
            # detector (requests in flight, nothing completing, before
            # the replica's watchdog — which needs 3 flushes — arms)
            verdict = supervise.heartbeat_verdict(
                heartbeats.get(r.idx), r.proc.pid, time.time(),
                self.fc.stale_after_s, self.fc.stall_after_s,
                stall_gate=_serve_in_flight)
            if verdict == "wedged":
                self._evict(r, "wedged", now)
            elif verdict == "stalled":
                self._evict(r, "stalled", now)
            elif verdict == "stale":
                self._evict(r, "stale", now)
            elif verdict in ("no_heartbeat", "foreign_pid"):
                # no current-incarnation file yet: grace from ready
                if now - (r.ready_m or now) > float(self.fc.stale_after_s):
                    self._evict(r, "stale", now)
        elif r.state == "terminating":
            if not alive:
                self._to_backoff(r, now)
            elif now >= r.term_deadline:
                supervise.kill_quietly(r.proc)  # SIGTERM grace expired
                self._counters["kill_escalations"] += 1
                r.term_deadline = now + 3600.0  # kill once; reap next poll
        elif r.state == "backoff":
            if now >= r.backoff_until:
                if supervise.breaker_open(r.fast_failures,
                                          self.fc.crash_loop_threshold):
                    r.state = "broken"
                    self._counters["broken"] += 1
                    self._queue_incident(
                        "fleet_broken", "critical",
                        {"replica": r.idx,
                         "fast_failures": r.fast_failures})
                    self._log_event(r, "circuit breaker OPEN: "
                                       f"{r.fast_failures} consecutive fast "
                                       "failures, not respawning")
                else:
                    r.state = "spawning"  # claim; caller spawns unlocked
                    self._counters["respawns"] += 1
                    return True
        return False

    def _read_heartbeat(self, r: _Replica) -> dict | None:
        return supervise.read_heartbeat(self._replica_dir(r))

    # --------------------------------------------------- state changes
    def _queue_incident(self, kind: str, severity: str,
                        trigger: dict) -> None:
        """Stage a trigger while the fleet lock is held; `_poll_all` and
        `close` capture it unlocked."""
        if self.incidents is not None:
            self._pending_incidents.append((kind, severity, trigger))

    def _drain_incidents(self) -> None:
        """Capture the staged triggers (fleet lock not held), then move
        the replicas' committed bundles into the run root, so one
        `incidents list` there sees the whole fleet, bundles a SIGKILLed
        replica left behind included."""
        rec = self.incidents
        if rec is None:
            return
        with self._lock:
            pending, self._pending_incidents = self._pending_incidents, []
        for kind, severity, trigger in pending:
            rec.record(kind, severity, trigger=trigger)
        rec.note_collected(incident.collect_from_children(self.dir))

    def _evict(self, r: _Replica, reason: str, now: float) -> None:
        """Sick replica out of rotation: SIGTERM (graceful drain),
        SIGKILL after term_grace_s (the terminating-state poll)."""
        self._queue_incident("fleet_eviction", "critical",
                             {"replica": r.idx, "reason": reason})
        self._counters["evictions"] += 1
        if reason in ("wedged", "stalled"):  # both are stuck dispatches
            self._counters["wedge_evictions"] += 1
        elif reason == "stale":
            self._counters["stale_evictions"] += 1
        elif reason in ("spawn_timeout", "spawn_failed"):
            self._counters["spawn_failures"] += 1
        r.last_reason = reason
        r.port = None  # router stops picking it immediately
        self._log_event(r, f"evicting ({reason}): SIGTERM, SIGKILL after "
                           f"{self.fc.term_grace_s}s")
        supervise.terminate_quietly(r.proc)
        r.state = "terminating"
        r.term_deadline = now + max(float(self.fc.term_grace_s), 0.0)

    def _on_death(self, r: _Replica, reason: str) -> None:
        """Process found dead on its own (kill -9, OOM, crash, clean
        exit): reap, count, schedule the respawn."""
        rc = None
        if r.proc is not None:
            rc = r.proc.wait()
        r.last_exit = rc
        clean = False
        if reason == "crashed" and rc == 0:
            reason = "exited"  # clean exit (external rolling restart)
            clean = True
            self._counters["clean_exits"] += 1
        elif reason == "spawn_failed":
            self._counters["spawn_failures"] += 1
            self._counters["evictions"] += 1
        else:
            self._counters["crashes"] += 1
            self._counters["evictions"] += 1
            self._queue_incident("fleet_replica_crash", "critical",
                                 {"replica": r.idx, "rc": rc})
        r.last_reason = reason
        self._log_event(r, f"died ({reason}, rc={rc}); scheduling respawn")
        self._schedule_backoff(r, clean=clean)

    def _to_backoff(self, r: _Replica, now: float) -> None:
        rc = r.proc.wait() if r.proc is not None else None
        r.last_exit = rc
        self._schedule_backoff(r)

    def _schedule_backoff(self, r: _Replica, clean: bool = False) -> None:
        now = time.monotonic()
        fast = (r.ready_m is None
                or now - r.ready_m < float(self.fc.healthy_after_s))
        # breaker arithmetic shared with every supervisor
        # (core/supervise.py): only a FAST non-clean death counts — a
        # slow death resets, a clean rc=0 exit (rolling restart) never
        # counts either way
        r.fast_failures = supervise.crash_loop_update(r.fast_failures,
                                                      fast, clean=clean)
        delay = supervise.backoff_delay(self.fc.backoff_s,
                                        self.fc.backoff_max_s,
                                        r.fast_failures)
        r.state = "backoff"
        r.port = None
        r.backoff_until = now + delay
        r.proc = None

    def _log_event(self, r: _Replica, message: str) -> None:
        """One kind="warn" line per lifecycle event into the FLEET's
        metrics.jsonl (the replica's own logs live in its subdir)."""
        try:
            rec = {"kind": "warn", "step": 0, "time": time.time(),
                   "message": f"fleet replica-{r.idx} "
                              f"(incarnation {r.incarnation}): {message}"}
            with open(os.path.join(self.dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            pass

    # ------------------------------------------------------- router API
    def ready_replicas(self) -> list:
        """Immutable (idx, port) snapshots of replicas safe to route to."""
        with self._lock:
            return [SimpleNamespace(idx=r.idx, port=r.port)
                    for r in self._replicas
                    if r.state == "ready" and r.port is not None]

    def note_failure(self, idx: int) -> None:
        """Router hint: a proxy attempt to this replica just failed —
        poll now instead of waiting out the period (a crashed process is
        discovered on the next monitor pass)."""
        self._wake.set()

    # ------------------------------------------------------ autoscaling
    def scale_up(self) -> int | None:
        """Add one replica slot and spawn it (the autoscaler's scale-up
        primitive). The new slot gets the next monotonic index — retired
        indices are never reused, so the router's per-index maps stay
        unambiguous across any number of scale events. Returns the new
        index, or None when the fleet is stopping."""
        with self._lock:
            if self._stopping:
                return None
            r = _Replica(len(self._replicas))
            r.state = "spawning"  # claimed; spawned below, unlocked
            self._replicas.append(r)
            self._active += 1
        self._spawn(r)
        if r.state != "backoff":  # spawn failure logs its own event
            self._log_event(r, "scale-up: new replica slot spawned")
        return r.idx

    def begin_retire(self) -> _Replica | None:
        """Claim the scale-down victim: the highest-index ready replica
        leaves rotation IMMEDIATELY (state "retiring" — ready_replicas()
        stops offering it, so the router admits nothing new there) but
        keeps running so in-flight requests finish. None when no replica
        is ready or the fleet is stopping."""
        with self._lock:
            if self._stopping:
                return None
            ready = [x for x in self._replicas if x.state == "ready"]
            if not ready:
                return None
            victim = max(ready, key=lambda x: x.idx)
            victim.state = "retiring"
            victim.last_reason = "scale_down"
            return victim

    def retire_one(self, router=None) -> int | None:
        """Graceful scale-down of ONE healthy replica — the eviction
        ladder's drain half applied to a replica that did nothing
        wrong: stop admission (begin_retire), wait out the router's
        in-flight count for the slot (bounded by drain_timeout_s),
        SIGTERM (the replica's own drain hook flushes any racing
        request and exits 0), reap with SIGKILL escalation after
        term_grace_s. Zero silent drops by construction: requests the
        router already proxied complete inside the replica's drain, and
        a request racing the SIGTERM fails transport and REPLAYS on a
        sibling (the existing failover contract). Counted as `retired`,
        never as an eviction: evictions stay about sickness. Blocks (the
        autoscaler's thread); returns the retired index or None."""
        r = self.begin_retire()
        if r is None:
            return None
        self._log_event(r, "scale-down: draining, then SIGTERM")
        deadline = time.monotonic() + max(float(self.fc.drain_timeout_s),
                                          0.0)
        while (router is not None and router.in_flight_of(r.idx) > 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        supervise.terminate_quietly(r.proc)
        rc = supervise.reap_within(
            r.proc, time.monotonic() + max(float(self.fc.term_grace_s), 0.1)
            + max(float(self.fc.drain_timeout_s), 0.0))
        with self._lock:
            r.last_exit = rc
            r.state = "retired"
            r.port = None
            r.proc = None
            self._active -= 1
            self._counters["retired"] += 1
            if rc not in (0, None):
                # SIGKILL escalation (wedged drain) or a crash that
                # raced the retirement — the capacity was leaving either
                # way, but the escalation stays visible
                self._counters["kill_escalations"] += 1
        self._log_event(r, f"retired (scale-down, rc={rc})")
        self._artifacts_gc("retire")
        hook = self.on_retired
        if hook is not None:
            try:
                hook(r.idx)  # router ages out the slot's maps
            except Exception:  # noqa: BLE001 - aging must not kill scaling
                pass
        return r.idx

    # ------------------------------------------------------------ stats
    def describe(self) -> list[dict]:
        """ACTIVE slots only, like stats()'s states map — retired slots
        would otherwise grow the /healthz payload by one permanent
        entry per scale-up for the life of an oscillating fleet; the
        `fleet_retired` counter accounts for them instead. `ready_s` is
        the current incarnation's spawn-to-ready time (None until it is
        ready)."""
        with self._lock:
            return [{"replica": r.idx, "state": r.state, "port": r.port,
                     "pid": r.proc.pid if r.proc is not None else None,
                     "incarnation": r.incarnation,
                     "fast_failures": r.fast_failures,
                     "last_exit": r.last_exit,
                     "last_reason": r.last_reason,
                     "ready_s": (round(r.ready_m - r.started_m, 3)
                                 if r.ready_m is not None else None)}
                    for r in self._replicas if r.state != "retired"]

    def stats(self) -> dict:
        """The supervisor's half of the fleet_* counter block. The
        states map covers ACTIVE slots only — retired slots leave it
        (bounded however many scale events a long-lived fleet sees) and
        are accounted by the `fleet_retired` counter instead."""
        with self._lock:
            c = dict(self._counters)
            states = {f"replica-{r.idx}": r.state for r in self._replicas
                      if r.state != "retired"}
            ready = sum(r.state == "ready" for r in self._replicas)
            size = self._active  # the one non-retired count (see size)
        return {
            "fleet_replicas": size,
            "fleet_ready": ready,
            "fleet_retired": c["retired"],
            "fleet_states": states,
            "fleet_evictions": c["evictions"],
            "fleet_crashes": c["crashes"],
            "fleet_clean_exits": c["clean_exits"],
            "fleet_wedge_evictions": c["wedge_evictions"],
            "fleet_stale_evictions": c["stale_evictions"],
            "fleet_spawn_failures": c["spawn_failures"],
            "fleet_respawns": c["respawns"],
            "fleet_broken": c["broken"],
            "fleet_kill_escalations": c["kill_escalations"],
        }

    # ------------------------------------------------------------ close
    def close(self) -> None:
        """Graceful fleet teardown: stop the monitor, SIGTERM every live
        replica (each drains in-flight work per serve/server.py's
        SIGTERM hook), SIGKILL stragglers after the drain+grace window.
        Idempotent."""
        with self._lock:
            if self._stopping:
                return
            self._stopping = True
        self._wake.set()
        if self._monitor.ident is not None:  # started
            self._monitor.join(timeout=max(float(self.fc.poll_s), 0.05) + 5.0)
        with self._lock:
            live = [(r, r.proc) for r in self._replicas
                    if r.proc is not None and r.proc.poll() is None]
            for r, proc in live:
                supervise.terminate_quietly(proc)
        deadline = time.monotonic() + (float(self.fc.drain_timeout_s)
                                       + float(self.fc.term_grace_s))
        for r, proc in live:
            rc = supervise.reap_within(proc, deadline)
            with self._lock:
                r.last_exit = rc
        with self._lock:
            for r in self._replicas:
                if r.state != "retired":
                    r.state = "stopped"
                r.port = None
        # the final pass: staged triggers captured and every replica's
        # bundles collected before the run dir is read
        self._drain_incidents()
        self._artifacts_gc("close")

    # -------------------------------------------------- artifact gc
    def _live_fingerprints(self) -> set[str]:
        """Every fingerprint a replica's ledger recorded in this run (the
        live lattice), read off the replica dirs without torch."""
        from ..obs.ledger import load_ledger

        with self._lock:
            dirs = [self._replica_dir(r) for r in self._replicas]
        fps: set[str] = set()
        for d in dirs:
            try:
                rows = load_ledger(d)
            except OSError:
                continue
            fps.update(row["fingerprint"] for row in rows
                       if isinstance(row.get("fingerprint"), str)
                       and row["fingerprint"])
        return fps

    def _artifacts_gc(self, trigger: str) -> None:
        """Sweep the artifact store at a retirement or the close (module
        docstring), the live fingerprints and the index's targets
        pinned; one kind="warn" line into the fleet's metrics.jsonl when
        it removed anything. Best-effort: it never blocks the caller."""
        root = store_root(self.cfg)
        if root is None:
            return
        try:
            from .artifacts import gc_store

            days = float(self.fc.artifacts_gc_days)
            rep = gc_store(root, older_than_days=days if days > 0 else None,
                           roots=self._live_fingerprints())
            if rep["removed"] or rep["tmp_removed"]:
                rec = {"kind": "warn", "step": 0, "time": time.time(),
                       "message": (f"fleet artifacts gc ({trigger}): "
                                   f"removed {len(rep['removed'])} "
                                   f"entries, {len(rep['tmp_removed'])} "
                                   f"tmp, kept {len(rep['kept'])}")}
                with open(os.path.join(self.dir, "metrics.jsonl"),
                          "a") as f:
                    f.write(json.dumps(rec) + "\n")
        except Exception:  # noqa: BLE001 - gc must not block retirement
            pass

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------ CLI entry


def prebuild_libraries(cfg: ExperimentConfig) -> dict[str, str]:
    """Ready the CUDA libraries the replicas of `cfg` launch
    (`engine.serve_libraries`, never one they do not), once, before
    they boot: each is fetched from the artifact store when one is set
    and holds it at this checkout's source hash, else built by nvcc (one
    process a library, at once). No CUDA context. Returns {name:
    verdict}: the store's ("hit", "present", or a miss or reject that
    was then built) or, built here, "built"."""
    from concurrent.futures import ThreadPoolExecutor

    from ..ops.cuda import build
    from .artifacts import store_for_config
    from .engine import serve_libraries

    names = serve_libraries(cfg)
    store = store_for_config(cfg, "cuda", context=False)
    out = store.fetch_libraries(names) if store is not None else {}
    todo = [n for n in names if out.get(n) not in ("hit", "present")]
    if todo:
        with ThreadPoolExecutor(len(todo)) as pool:
            for n, r in zip(todo, pool.map(build.build, todo)):
                out[n] = "built" if r["built"] else "present"
    return out



def run_fleet(cfg: ExperimentConfig, replicas: int | None = None,
              device: str = "cuda") -> int:
    """`serve --replicas N` (or `--autoscale`): fleet + router + fleet
    heartbeat, serving until SIGINT/SIGTERM, then graceful drain (stop
    admission, flush in-flight, reap replicas). Blocks; returns the exit
    code. Prints one JSON line {"serving": "http://host:port", "mode":
    "fleet", ...} once the router listens. `device` is the replicas';
    for model replicas on "cuda" the kernels are built here first (nvcc
    only: this process creates no CUDA context)."""
    from ..obs import trace as obs_trace

    # router-side span tracer: every admitted request's `route` span
    # (request_id-stamped) lands in <log_dir>/trace.json beside the
    # replicas' serve_* spans in their own directories
    tracer = None
    if cfg.obs.trace:
        tracer = obs_trace.Tracer(
            path=os.path.join(cfg.train.log_dir, "trace.json"),
            ring_size=cfg.obs.trace_ring, role="router")
    with obs_trace.installed(tracer):
        return _run_fleet(cfg, replicas, device, tracer)


def _run_fleet(cfg: ExperimentConfig, replicas: int | None, device: str,
               tracer) -> int:
    from ..obs.heartbeat import Heartbeat
    from .router import Router, build_router_server

    if str(device) == "cuda" and cfg.serve.fake_exec_ms is None:
        prebuild_libraries(cfg)  # once, before N replicas would each
    fleet = Fleet(cfg, replicas, device=device)
    # the supervisor's incident recorder, in the run root (None unless
    # obs.incidents): the fleet's, the router's and the brownout
    # controller's verdicts, and the replicas' bundles collected there
    fleet.incidents = incident.install(cfg, cfg.train.log_dir, "fleet")
    router = None
    httpd = None
    hb = None
    scaler = None
    degr = None
    # one teardown path for EVERY exit — replicas are detached
    # (start_new_session), so any escape without fleet.close() would
    # orphan serving processes: a partway-failed start() (EMFILE on
    # replica k), Ctrl-C during the spawns, or the router port already
    # bound raising EADDRINUSE after the replicas spawned
    try:
        fleet.start()
        try:
            fleet.wait_ready(
                min_ready=1,
                timeout_s=float(cfg.serve.fleet.spawn_timeout_s))
        except TimeoutError as e:
            print(f"fleet: no replica became ready: {e}", file=sys.stderr)
            return 1
        router = Router(cfg, fleet)
        router.incidents = fleet.incidents
        # scale-down aging: a retired slot leaves the router's
        # per-replica maps; its pinned sessions demote to session_lost
        fleet.on_retired = router.retire_slot
        httpd = build_router_server(cfg, router)
        host, port = httpd.server_address[:2]

        if cfg.serve.fleet.autoscale:
            from .autoscale import Autoscaler

            scaler = Autoscaler(cfg, fleet, router)
            # scale counters ride router.stats(): /healthz, /metrics,
            # the heartbeat sample and the shutdown record all see them
            router.autoscale_stats = scaler.stats
            scaler.start()

        if cfg.serve.degrade.enabled:
            from .degrade import DegradeController

            # the brownout plane (serve/degrade.py): degrades QUALITY
            # within ~a second while the autoscaler (above) adds
            # capacity over a replica's boot — the two watch the same
            # signals, so the level walks back down when capacity lands
            degr = DegradeController(cfg, fleet, router)
            degr.incidents = fleet.incidents  # L3 entry -> a bundle
            router.degrade_stats = degr.stats
            router.degrade_level = degr.level
            degr.start()

        hb_ref: dict = {}

        def sample() -> dict:
            s = {**fleet.stats(), **router.stats()}
            # idle fleet is healthy, not wedged (same contract as serve)
            if s.get("fleet_in_flight", 0) <= 0 and "hb" in hb_ref:
                hb_ref["hb"].touch()
            return s

        sample_fn = sample
        if fleet.incidents is not None:
            # the samples feed the recorder's ring and alert rules; a
            # wedged supervisor is itself a critical incident
            sample_fn = fleet.incidents.wrap_sample(sample)
        # device=None: the supervisor samples no device memory (it has
        # no CUDA context, and must not make one)
        hb = Heartbeat(os.path.join(cfg.train.log_dir, "heartbeat.json"),
                       period_s=cfg.obs.heartbeat_period_s,
                       watchdog_factor=cfg.obs.watchdog_factor,
                       watchdog_min_s=cfg.obs.watchdog_min_s,
                       sample=sample_fn, tracer=tracer, device=None,
                       on_wedge=(None if fleet.incidents is None else
                                 lambda dump: fleet.incidents.record(
                                     "watchdog_wedge", "critical",
                                     text_files={"stacks.txt": dump})))
        hb_ref["hb"] = hb
        router.beat_hook = hb.beat

        if threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                threading.Thread(target=httpd.shutdown, daemon=True,
                                 name="fleet-drain").start()

            signal.signal(signal.SIGTERM, _on_term)

        print(json.dumps({"serving": f"http://{host}:{port}",
                          "mode": "fleet",
                          "replicas": fleet.size, "pid": os.getpid(),
                          "replica_ports": [s.port for s
                                            in fleet.ready_replicas()]}),
              flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    finally:
        if degr is not None:
            degr.close()  # no level transitions during teardown
        if scaler is not None:
            scaler.close()  # no scale events during teardown
        if router is not None:
            router.draining = True  # stop admission
        if httpd is not None:
            httpd.server_close()
            deadline = (time.monotonic()
                        + float(cfg.serve.fleet.drain_timeout_s))
            while (router.in_flight_total() > 0
                   and time.monotonic() < deadline):
                time.sleep(0.05)  # flush in-flight through the replicas
        fleet.close()  # then reap
        if router is not None:
            _log_fleet_summary(cfg, fleet, router)
        if hb is not None:
            hb.close()


def _log_fleet_summary(cfg: ExperimentConfig, fleet: Fleet,
                       router) -> None:
    """One kind="serve" record with the final fleet_* block, appended to
    the fleet's metrics.jsonl. router.stats() already folds in the
    autoscaler's and the brownout controller's blocks — one merge path,
    never two to drift."""
    try:
        os.makedirs(cfg.train.log_dir, exist_ok=True)
        rec = {"kind": "serve", "step": 0, "time": time.time(),
               **fleet.stats(), **router.stats()}
        with open(os.path.join(cfg.train.log_dir, "metrics.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec, allow_nan=False) + "\n")
    except OSError:
        pass
