"""The elastic trainer pool: a coordinator-supervised pool of trainer
processes that survives the loss or preemption of a host without an
operator (port of `deepof_tpu/train/elastic.py`; its protocol, verdicts,
counters and records as they are).

One coordinator (`ElasticCoordinator`, stdlib-only at import: it builds
no model and makes no CUDA context) spawns N single-host trainer
children:

    python -m deepof_tpu_torch train --config-json \
        <log_dir>/host-<i>/config.json --host-index <i> --device <dev>

Each child gets the parent's config tree with its elastic identity
filled in (host_index, the generation's world size, the generation, the
shared checkpoint directory, the generation's primary, the world file).
Every child trains on the coordinator's device (`train --device`, cuda
unless the caller asks for the CPU): on the card every child shares this
host's one device. ``elastic.virtual_devices`` is carried for the JAX
config's sake: there it is the count of virtual CPU devices a CPU child
shards its batch over, which changes no result, so the port reads it
nowhere.

Health comes from each host's ``heartbeat.json`` (`host_verdict`, the
supervisor verdict of `core/supervise.py` under the coordinator's stall
gate: >= 1 completed step) and from ``poll()`` between heartbeats. On a
lost host the coordinator bumps the generation:

  1. **Barrier**: SIGTERM every survivor; the trainer's handler
     (train/loop.py) finishes its call, saves a verified checkpoint (the
     primary writes the shared directory; the others open it
     restore-only) and exits 0. Stragglers are SIGKILLed after
     ``elastic.barrier_timeout_s``.
  2. **Re-form**: the world is the surviving original host indices (a
     lost host is never respawned). New world size, new primary (the
     lowest survivor), generation + 1; each survivor's data stream is
     re-seeded by `parallel/mesh.py::elastic_stream_seed`.
  3. **Resume**: the survivors respawn and restore the newest valid
     checkpoint of the shared directory (verify and fall back).

The chaos sites ``host_loss`` / ``host_wedge`` / ``preempt_notice``
(resilience/faults.py, keyed by host index, armed at
``faults.host_fault_step``) inject these failures from config:
`maybe_host_fault` runs in each trainer's step loop.

The trainers exchange no gradients: each host trains its own replica on
its own stream, and the run is the primary's checkpoint lineage, as in
the JAX package (the data-parallel step across ranks is `train
--multihost`, `parallel/mesh.py`). The coordinator spawns its children
on this machine.

`run_elastic` is the ``train --elastic N`` entry: the coordinator, a
heartbeat whose ``elastic_*`` block (generation, reforms, lost_hosts,
resumed_step, steps_lost, per-host states) lands in ``heartbeat.json``
and in ``kind="elastic"`` records (`tail` exits 5 on a run that
re-formed), and with ``obs.metrics_port`` a GET /metrics and /healthz
endpoint of the same block (obs/export.py).
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

from ..core import supervise
from ..core.config import ExperimentConfig
from ..obs import incident
from ..resilience import verify as ckpt_verify

#: Trainer-host lifecycle states (ElasticCoordinator._check_host is the
#: transition table). Terminal: "lost" (never respawned), "done"
#: (reached the target step), "stopped" (coordinator shutdown).
HOST_STATES = ("spawning", "starting", "running", "barrier", "lost",
               "done", "stopped")


# --------------------------------------------------------------- verdicts


def _trainer_stepped(hb: dict) -> bool:
    """The coordinator's stall gate for the shared heartbeat verdict
    (core/supervise.py): the stall clock is meaningful only once >= 1
    beat completed — a first call's kernel build is never judged."""
    return int(hb.get("beats") or 0) >= 1


def host_verdict(hb: dict | None, pid: int | None, now_wall: float,
                 stale_after_s: float, wedge_after_s: float) -> str:
    """Pure health verdict for one trainer from its heartbeat CONTENT —
    the shared supervisor verdict (`supervise.heartbeat_verdict`, the
    same decision function the serving fleet judges replicas with) under
    the coordinator's stall gate.

    Returns one of:
      "no_heartbeat"  — no (readable) file yet: pre-fit grace, judged
                        only by the spawn timeout;
      "foreign_pid"   — the file belongs to another incarnation: same
                        treatment as no_heartbeat (it can neither vouch
                        for nor condemn this process);
      "wedged"        — the trainer's own watchdog declared the wedge;
      "stale"         — the heartbeat thread itself stopped writing
                        (frozen/SIGSTOPped process, dead host);
      "stalled"       — the file is fresh but >= 1 step completed and
                        nothing has progressed for wedge_after_s: the
                        main loop is hung before the in-process watchdog
                        (3 beats + obs.watchdog_min_s) would say so.
                        Gated on beats >= 1 so the first call's
                        kernel build is never judged;
      "ok"            — healthy.
    """
    return supervise.heartbeat_verdict(hb, pid, now_wall, stale_after_s,
                                       wedge_after_s,
                                       stall_gate=_trainer_stepped)


# ------------------------------------------------------- in-trainer chaos


def maybe_host_fault(inj, host_index: int, gstep: int, arm_step: int,
                     log=None, _kill=os.kill,
                     _block=lambda: threading.Event().wait()) -> None:
    """Host-level chaos hook, called from the trainer's step loop after
    each completed dispatch (train/loop.py). Sites are keyed by the
    host index and arm once the global step reaches ``arm_step``
    (``faults.host_fault_step``); `FaultInjector.hit` is consume-once,
    so each site fires at most once per trainer incarnation.

      preempt_notice — SIGTERM self-delivery: the graceful handler saves
        a verified checkpoint and exits 0 (the cloud's preemption
        warning, end to end).
      host_wedge — the main loop blocks forever: the heartbeat thread
        keeps the file fresh while ``last_step_age_s`` grows — exactly
        the content stall the coordinator's `host_verdict` exists for.
      host_loss — SIGKILL: the host vanishes mid-step (preemption
        without notice, OOM kill), nothing gets to clean up.

    ``_kill`` / ``_block`` are test seams (the real actions end or hang
    the calling process)."""
    if inj is None or host_index < 0 or gstep < max(int(arm_step), 0):
        return
    if inj.hit("preempt_notice", host_index):
        if log is not None:
            log(f"fault injection: preemption notice (SIGTERM) to host "
                f"{host_index} at step {gstep}")
        _kill(os.getpid(), signal.SIGTERM)
        return
    if inj.hit("host_wedge", host_index):
        if log is not None:
            log(f"fault injection: host {host_index} wedging at step "
                f"{gstep} (main loop blocks forever)")
        _block()
    if inj.hit("host_loss", host_index):
        if log is not None:
            log(f"fault injection: host loss (SIGKILL) of host "
                f"{host_index} at step {gstep}")
        _kill(os.getpid(), signal.SIGKILL)


def pace_to_world(world_file: str, generation: int, gstep: int,
                  sync_ahead: int, should_stop, touch=None,
                  poll_s: float = 0.05, stale_s: float = 30.0,
                  _sleep=time.sleep, _now=time.time) -> int | None:
    """Step-skew limiter, called from the trainer's step loop
    (train/loop.py) before each dispatch: block while this host is more
    than ``sync_ahead`` steps ahead of the slowest live host (the world
    FLOOR the coordinator publishes to ``world_file`` every poll).

    Real synchronous data-parallel training is lockstepped by its
    collectives; virtual elastic hosts are independent processes, and on
    a contended machine their step counts diverge by whole compile
    times — which would void the guarantee that a re-form discards at
    most checkpoint-cadence + sync_ahead steps (the furthest host's
    uncommitted tail IS the lost work). While paced, the wait
    ``touch``es the heartbeat so a deliberately-waiting leader never
    reads as a stall. The gate yields immediately when the file is
    missing/unreadable (pacing is an optimization, never a hard
    dependency), names a different generation (stale across a re-form —
    the SIGTERM barrier is what actually stops this host), or the stop
    flag is raised.

    Returns the last floor observed (None when pacing is inapplicable:
    missing/unreadable file, a stale generation, or a floor older than
    ``stale_s`` — a coordinator killed uncleanly leaves the file frozen
    forever, and a paced ORPHAN must finish training to target, not
    block on a dead supervisor; pacing is an optimization, never a hard
    dependency). The floor only ever advances within one generation, so
    callers may cache it and skip the file read entirely while ``gstep -
    cached_floor <= sync_ahead`` — the hot loop then touches the
    filesystem only when it could actually need to block."""
    floor_seen: int | None = None
    while not should_stop():
        try:
            with open(world_file) as f:
                w = json.load(f)
        except (OSError, ValueError):
            return floor_seen
        if w.get("generation") != generation:
            return floor_seen
        t = w.get("time")
        if (isinstance(t, (int, float))
                and _now() - t > max(float(stale_s), 0.1)):
            return floor_seen  # frozen file: the coordinator is gone
        floor = w.get("floor")
        if not isinstance(floor, (int, float)):
            return floor_seen
        floor_seen = int(floor)
        if gstep - floor_seen <= max(int(sync_ahead), 0):
            return floor_seen
        if touch is not None:
            touch()
        _sleep(poll_s)
    return floor_seen


# ------------------------------------------------------------ coordinator


class _TrainerHost(supervise.Child):
    """Coordinator-side record of one trainer host (keyed by its
    ORIGINAL index — survivors keep their identity across re-forms, so
    a host-indexed fault schedule can never re-fire on a renumbered
    neighbor). Built on the shared supervisor child record
    (core/supervise.py); only the coordinator's monitor loop mutates
    it."""

    def __init__(self, idx: int):
        super().__init__(idx, "spawning")
        self.last_step = 0


class ElasticCoordinator:
    """See module docstring.

    cfg: the run-level experiment config; each trainer child gets a copy
        with its own log_dir and elastic identity serialized to
        <log_dir>/host-<i>/config.json.
    hosts: initial world size (overrides cfg.elastic.hosts).
    target_step: absolute global step the run trains to (overrides
        cfg.elastic.target_step; elastic runs REQUIRE one — a respawned
        trainer must stop where the run ends, not "max_steps further").
    device: where every child trains (its `train --device`).
    """

    def __init__(self, cfg: ExperimentConfig, hosts: int | None = None,
                 target_step: int | None = None, device: str = "cuda"):
        self.cfg = cfg
        self.device = device
        self.ec = cfg.elastic
        n = int(hosts) if hosts is not None else int(self.ec.hosts)
        if n < 1:
            raise ValueError(f"elastic world needs >= 1 host, got {n}")
        self.target = int(target_step if target_step is not None
                          else self.ec.target_step)
        if self.target <= 0:
            raise ValueError(
                "elastic training needs an absolute target step "
                "(`train --elastic N --max-steps T`, or "
                "--set elastic.target_step=T)")
        # absolute paths throughout: children run with cwd=_REPO_ROOT,
        # so a relative --log-dir serialized verbatim into their configs
        # would split the run across two directory trees (coordinator
        # reading under the caller's cwd, children writing under the
        # repo) and every host would "spawn_timeout"
        self.dir = os.path.abspath(cfg.train.log_dir)
        self.ckpt_dir = os.path.abspath(
            self.ec.ckpt_dir or os.path.join(self.dir, "ckpt"))
        self.size = n
        self.generation = 0
        self.hosts: dict[int, _TrainerHost] = {
            i: _TrainerHost(i) for i in range(n)}
        self._counters = {k: 0 for k in (
            "spawns", "respawns", "reforms", "lost_hosts", "preemptions",
            "kill_escalations", "steps_lost")}
        self.max_step_seen = 0
        self.resumed_step = 0
        self.last_reform_s: float | None = None
        self._reform_started: float | None = None
        self._stopping = False
        self.beat_hook = None  # set by run_elastic: (step) -> None
        self.incidents = None  # set by run_elastic (obs/incident.py)
        self.world_path = os.path.join(self.dir, "elastic_world.json")
        self._last_poll_m = time.monotonic()

    # ------------------------------------------------------------- spawn
    def _host_dir(self, h: _TrainerHost) -> str:
        return os.path.join(self.dir, f"host-{h.idx}")

    def _live(self) -> list[_TrainerHost]:
        """Hosts still part of the training world (not lost/done)."""
        return [h for h in self.hosts.values()
                if h.state in ("spawning", "starting", "running", "barrier")]

    def start(self) -> None:
        if self._stopping:  # SIGTERM already landed: spawn nothing
            return
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        # A rerun over an existing run directory auto-resumes from the
        # newest valid checkpoint: every host's presumed step — and the
        # published world floor — must start THERE, not at 0, or the
        # pace gate would judge resumed trainers "ahead" of a floor
        # nobody is actually at (and an at-target trainer's instant
        # clean exit would be misread as a preemption).
        self.resumed_step = self._newest_ckpt_step()
        for h in self.hosts.values():
            h.last_step = self.resumed_step
        self._write_world()
        for h in self._live():
            if self._stopping:
                break
            self._spawn(h)

    def _spawn(self, h: _TrainerHost) -> None:
        """Spawn one trainer child for the CURRENT generation. The world
        the child sees — size, generation, primary — is computed from
        the live set at spawn time, so every member of one generation
        agrees on it (all spawns of a generation happen before the next
        poll can change the live set)."""
        hdir = self._host_dir(h)  # absolute (self.dir is)
        live_idx = sorted(x.idx for x in self._live())
        hcfg = self.cfg.replace(
            train=dataclasses.replace(self.cfg.train, log_dir=hdir),
            elastic=dataclasses.replace(
                self.ec, hosts=0, host_index=h.idx,
                num_hosts=len(live_idx), generation=self.generation,
                primary_host=min(live_idx), target_step=self.target,
                ckpt_dir=self.ckpt_dir, world_file=self.world_path))
        # shared child-dir prep (core/supervise.py): mkdir, delete the
        # dead incarnation's heartbeat (it must not speak for the next),
        # serialize the child's EXACT config tree
        cfg_path = supervise.prepare_child_dir(hdir, hcfg)
        env = supervise.child_env()
        with open(os.path.join(hdir, "stdout.log"), "ab") as out, \
                open(os.path.join(hdir, "stderr.log"), "ab") as err:
            h.proc = supervise.spawn_child(
                [sys.executable, "-m", "deepof_tpu_torch", "train",
                 "--config-json", cfg_path, "--host-index", str(h.idx),
                 "--device", self.device],
                env, out, err)
        h.incarnation += 1
        h.state = "starting"
        h.started_m = time.monotonic()
        h.last_exit = None
        self._counters["spawns"] += 1
        if h.incarnation > 1:
            self._counters["respawns"] += 1
        self._log_event(h, f"spawned (generation {self.generation}, "
                           f"world {len(live_idx)}, pid {h.proc.pid})")

    # ----------------------------------------------------------- monitor
    def run(self) -> int:
        """Supervise until the run completes (0), aborts (1), or the
        coordinator is stopped externally (`stop()`; 0 — a preempted
        coordinator is a clean save-and-exit, like its trainers)."""
        while True:
            if self._stopping:
                self._stop_world("coordinator stop requested")
                return 0
            lost = self._poll()
            self._last_poll_m = time.monotonic()
            self._sweep_incidents()
            if lost:
                if self._counters["reforms"] >= int(self.ec.max_reforms):
                    self._log(f"giving up: {self.ec.max_reforms} re-forms "
                              "exhausted and another host was lost")
                    self._record_incident(
                        "elastic_abort", "critical",
                        {"reason": "max_reforms exhausted",
                         "reforms": self._counters["reforms"],
                         "lost": sorted(h.idx for h in lost)})
                    self._stop_world("max_reforms exhausted")
                    return 1
                self._reform(lost)
            if not self._live():
                # every host is terminal: the run completed iff a host
                # trained to the target AND the persisted lineage (the
                # shared checkpoint directory — the only state that
                # outlives the pool) reached it too. A non-primary
                # finishing while every primary died below target is
                # NOT success: its replica's progress was never saved.
                if any(h.state == "done" for h in self.hosts.values()):
                    if self._newest_ckpt_step(valid_only=True) \
                            >= self.target:
                        return 0
                    self._log("a host reached the target but the shared "
                              "checkpoint lineage's newest VERIFIED "
                              "step is "
                              f"{self._newest_ckpt_step(valid_only=True)}"
                              f" < {self.target} (primary lost or torn "
                              "final save); failing the run")
                    self._record_incident(
                        "elastic_abort", "critical",
                        {"reason": "lineage below target",
                         "target": self.target})
                    return 1
                self._log("all hosts terminal below the target step "
                          f"{self.target}; aborting")
                self._record_incident(
                    "elastic_abort", "critical",
                    {"reason": "all hosts terminal below target",
                     "target": self.target,
                     "max_step_seen": self.max_step_seen})
                return 1
            time.sleep(max(float(self.ec.poll_s), 0.05))

    def _poll(self) -> list[_TrainerHost] | None:
        """One health pass. Returns the hosts newly judged lost this
        pass (None = nothing lost)."""
        now_m = time.monotonic()
        now_w = time.time()
        lost: list[_TrainerHost] = []
        progressed = False
        for h in list(self._live()):
            hb = self._read_heartbeat(h)
            if hb is not None and isinstance(hb.get("step"), int):
                pid = h.proc.pid if h.proc is not None else None
                if (hb.get("pid") in (None, pid)
                        and int(hb.get("beats") or 0) >= 1):
                    # the current incarnation's heartbeat is
                    # authoritative once it has completed a step — a
                    # respawn legitimately reports a LOWER step than
                    # the incarnation it replaced. Before the first
                    # beat the file's step field is a meaningless 0
                    # (obs/heartbeat.py initializes it): adopting it
                    # would drag the world floor to 0, deadlocking the
                    # pace gate pool-wide, and make an at-target
                    # respawn's clean exit read as a preemption — keep
                    # the spawn-time resume point instead.
                    h.last_step = hb["step"]
                    if h.last_step > self.max_step_seen:
                        self.max_step_seen = h.last_step
                        progressed = True
            rc = h.proc.poll() if h.proc is not None else None
            if rc is not None:
                h.last_exit = rc
                if rc == 0 and h.last_step < self.target:
                    # TOCTOU: the heartbeat above may predate the
                    # trainer's FINAL write (Heartbeat.close() flushes
                    # one last state before process exit) while poll()
                    # already sees the exit — re-read before judging a
                    # clean exit "preempted", or a host finishing at
                    # target between the two reads triggers a spurious
                    # re-form that barrier-kills healthy survivors
                    hb2 = self._read_heartbeat(h)
                    pid2 = h.proc.pid if h.proc is not None else None
                    if (hb2 is not None
                            and hb2.get("pid") in (None, pid2)
                            and int(hb2.get("beats") or 0) >= 1
                            and isinstance(hb2.get("step"), int)):
                        h.last_step = max(h.last_step, hb2["step"])
                        self.max_step_seen = max(self.max_step_seen,
                                                 h.last_step)
                if rc == 0 and h.last_step >= self.target:
                    h.state = "done"
                    self._log_event(h, f"completed at step {h.last_step} "
                                       f"(target {self.target})")
                elif rc == 0:
                    # a clean exit below the target is a preemption
                    # notice honored: checkpoint saved, capacity gone
                    self._counters["preemptions"] += 1
                    self._mark_lost(h, f"preempted (clean exit at step "
                                       f"{h.last_step})")
                    lost.append(h)
                else:
                    self._mark_lost(h, f"crashed (rc={rc})")
                    lost.append(h)
                continue
            pid = h.proc.pid if h.proc is not None else None
            verdict = host_verdict(hb, pid, now_w,
                                   self.ec.stale_after_s,
                                   self.ec.wedge_after_s)
            if h.state == "starting":
                if verdict == "ok":
                    h.state = "running"
                    if (self._reform_started is not None
                            and all(x.state == "running"
                                    for x in self._live())):
                        self.last_reform_s = round(
                            now_m - self._reform_started, 3)
                        self._reform_started = None
                        self._log("re-form complete: all survivors "
                                  f"running again after "
                                  f"{self.last_reform_s}s")
                elif now_m - h.started_m > float(self.ec.spawn_timeout_s):
                    self._kill(h)
                    self._mark_lost(h, "spawn_timeout")
                    lost.append(h)
            elif h.state == "running":
                if verdict in ("wedged", "stale", "stalled"):
                    self._kill(h)  # sick: no graceful drain owed
                    self._mark_lost(h, verdict)
                    lost.append(h)
        if progressed and self.beat_hook is not None:
            try:
                self.beat_hook(self.max_step_seen)
            except Exception:  # noqa: BLE001 - observability must not kill
                pass
        self._write_world()  # publish the (possibly advanced) floor
        return lost or None

    def _write_world(self) -> None:
        """Atomically publish the world floor (the slowest live host's
        last observed step) for `pace_to_world`'s step-skew limiter.
        Done hosts are excluded — they sit at the target and must not
        hold the floor down; a missing/stale file only disables pacing,
        never training."""
        live = self._live()
        if not live:
            return
        rec = {"generation": self.generation,
               "floor": min(h.last_step for h in live),
               "target": self.target, "time": time.time()}
        try:
            tmp = f"{self.world_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, self.world_path)
        except OSError:
            pass

    def _read_heartbeat(self, h: _TrainerHost) -> dict | None:
        return supervise.read_heartbeat(self._host_dir(h))

    # ------------------------------------------------------------ reform
    def _reform(self, lost: list[_TrainerHost]) -> None:
        """Generation bump: barrier-stop the survivors, account the lost
        work against the newest valid checkpoint, respawn the shrunken
        world."""
        t0 = time.monotonic()
        self._reform_started = t0
        survivors = self._live()
        self._counters["reforms"] += 1
        self._log(f"re-forming: lost host(s) "
                  f"{sorted(h.idx for h in lost)} "
                  f"({'; '.join(h.last_reason or '?' for h in lost)}); "
                  f"{len(survivors)} survivor(s); barrier SIGTERM")
        self._record_incident(
            "elastic_reform", "warn",
            {"generation": self.generation,
             "lost": sorted(h.idx for h in lost),
             "reasons": sorted({h.last_reason or "?" for h in lost}),
             "survivors": len(survivors)})
        self._barrier(survivors)
        self.resumed_step = self._newest_ckpt_step()
        stride = max(int(self.cfg.train.steps_per_call), 1)
        lost_now = max(0, self.max_step_seen - self.resumed_step)
        self._counters["steps_lost"] += lost_now
        # the world genuinely rewound to the resume point: max_step_seen
        # restarts there, or a SECOND re-form before the respawned world
        # re-passes the old high-water mark would re-charge this same
        # discarded tail a second time (steps_lost double-count)
        self.max_step_seen = self.resumed_step
        self.generation += 1
        if len(survivors) < max(int(self.ec.min_hosts), 1):
            self._log(f"only {len(survivors)} survivor(s) left, below "
                      f"elastic.min_hosts={self.ec.min_hosts}; not "
                      "re-forming (run() aborts)")
            for h in survivors:  # cleanly barrier-stopped, not lost
                h.state = "stopped"
                h.last_reason = "below min_hosts"
            self._write_record()
            return
        self._log(f"generation {self.generation}: re-forming on "
                  f"{len(survivors)} survivor(s) "
                  f"{sorted(h.idx for h in survivors)} from checkpoint "
                  f"step {self.resumed_step} ({lost_now} step(s) of the "
                  f"furthest host discarded; dispatch stride {stride})")
        for h in survivors:
            h.state = "spawning"
            h.last_step = self.resumed_step  # where the respawn resumes
        self._write_world()  # new generation's floor, before any child
        #                      of it could read a stale one
        for h in survivors:
            self._spawn(h)
        self._write_record()

    def _barrier(self, survivors: list[_TrainerHost]) -> None:
        """Clean stop of every survivor: SIGTERM (the trainer saves a
        verified checkpoint and exits 0), SIGKILL stragglers after
        barrier_timeout_s. A survivor that dies un-cleanly here is still
        respawned — it was healthy, and the resume point covers it."""
        for h in survivors:
            h.state = "barrier"
            if h.proc is not None and h.proc.poll() is None:
                supervise.terminate_quietly(h.proc)
        deadline = time.monotonic() + max(float(self.ec.barrier_timeout_s),
                                          1.0)
        for h in survivors:
            if h.proc is None:
                continue
            if not self._wait_supervising(h.proc, deadline):
                self._counters["kill_escalations"] += 1
                self._log_event(h, "barrier SIGTERM grace expired; SIGKILL")
                supervise.kill_quietly(h.proc)
                h.proc.wait()
            h.last_exit = h.proc.returncode
            self._log_event(h, f"barrier stop complete (rc={h.last_exit})")

    def _wait_supervising(self, proc: subprocess.Popen,
                          deadline: float) -> bool:
        """Wait (poll at 0.2 s) for a process to exit, refreshing the
        supervise-liveness clock each tick: a barrier legitimately lasts
        up to barrier_timeout_s (a survivor writing its checkpoint), and
        the coordinator heartbeat's touch gate must not read that
        as "run() hung" — the supervisor is alive, doing exactly its
        job. Returns True when the process exited before the
        deadline."""
        while True:
            if proc.poll() is not None:
                return True
            now = time.monotonic()
            self._last_poll_m = now
            if now >= deadline:
                return False
            time.sleep(min(0.2, max(deadline - now, 0.01)))

    def _newest_ckpt_step(self, valid_only: bool = False) -> int:
        """Newest restorable checkpoint step in the shared directory —
        the generation's resume point, judged by the same torch-free
        manifest verification `verify-ckpt` and the trainer's
        verify-and-fallback restore use. By default unverified
        (manifest-less) checkpoints count: restore tries them too.
        valid_only=True counts only manifest-verified steps — the RUN
        SUCCESS gate must not accept a primary's torn final save
        (SIGKILL mid-write leaves a partial, manifest-less step dir that
        classifies "unverified" but will not restore)."""
        report = ckpt_verify.verify_run(self.ckpt_dir)
        steps = report["valid_steps"]
        if not valid_only:
            steps = steps + report["unverified_steps"]
        return max(steps) if steps else 0

    # ----------------------------------------------------- state changes
    def poll_age_s(self) -> float:
        """Seconds since the supervise loop last completed a health
        pass — the coordinator's OWN liveness signal (run_elastic's
        heartbeat touch()es only while this is fresh, so a coordinator
        hung in a re-form or a filesystem walk eventually trips its
        wedge watchdog instead of reporting healthy forever)."""
        return time.monotonic() - self._last_poll_m

    def _record_incident(self, kind: str, severity: str = "warn",
                         trigger: dict | None = None) -> None:
        """Flight-recorder trigger (obs/incident.py); no-op unless
        run_elastic installed a recorder. The coordinator is
        single-threaded, so captures run inline (no lock to shed,
        unlike the fleet's pending-queue)."""
        if self.incidents is not None:
            self.incidents.record(kind, severity, trigger=trigger)

    def _sweep_incidents(self) -> None:
        """Move committed bundles out of host-<i>/incidents/ into the
        run root (the fleet supervisor runs the same sweep): one triage
        surface per run, each bundle counted exactly once."""
        rec = self.incidents
        if rec is not None:
            rec.note_collected(incident.collect_from_children(self.dir))

    def _mark_lost(self, h: _TrainerHost, reason: str) -> None:
        self._counters["lost_hosts"] += 1
        h.state = "lost"
        h.last_reason = reason
        self._log_event(h, f"LOST ({reason}) at observed step "
                           f"{h.last_step}")

    def _kill(self, h: _TrainerHost) -> None:
        if h.proc is not None and h.proc.poll() is None:
            supervise.kill_quietly(h.proc)
            h.proc.wait()
            h.last_exit = h.proc.returncode

    def stop(self) -> None:
        """External graceful stop (coordinator SIGTERM/^C): barrier-stop
        the world — every trainer saves — and exit cleanly."""
        self._stopping = True

    def _stop_world(self, why: str) -> None:
        live = self._live()
        if live:
            self._log(f"stopping world ({why}): barrier over "
                      f"{len(live)} live host(s)")
            self._barrier(live)
            for h in live:
                h.state = "stopped"
        self._write_record()

    def close(self) -> None:
        """Last-resort teardown for EVERY exit path: no trainer process
        may outlive the coordinator (they are detached sessions).
        Idempotent; graceful stops have already emptied the live set."""
        self._stopping = True
        for h in self.hosts.values():
            if h.proc is not None and h.proc.poll() is None:
                supervise.terminate_quietly(h.proc)
        deadline = time.monotonic() + max(float(self.ec.term_grace_s), 1.0)
        for h in self.hosts.values():
            if h.proc is not None:
                # bounded reap, SIGKILL escalation on expiry (shared
                # SIGTERM-then-SIGKILL ladder, core/supervise.py)
                supervise.reap_within(h.proc, deadline)

    def __enter__(self) -> "ElasticCoordinator":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The elastic_* counter block (heartbeat sample, kind="elastic"
        records, the run summary — one source, three surfaces)."""
        states = {f"host-{h.idx}": h.state for h in self.hosts.values()}
        return {
            "elastic_hosts": self.size,
            "elastic_live": len(self._live()),
            "elastic_done": sum(h.state == "done"
                                for h in self.hosts.values()),
            "elastic_generation": self.generation,
            "elastic_reforms": self._counters["reforms"],
            "elastic_lost_hosts": self._counters["lost_hosts"],
            "elastic_preemptions": self._counters["preemptions"],
            "elastic_resumed_step": self.resumed_step,
            "elastic_steps_lost": self._counters["steps_lost"],
            "elastic_max_step": self.max_step_seen,
            "elastic_target_step": self.target,
            "elastic_spawns": self._counters["spawns"],
            "elastic_respawns": self._counters["respawns"],
            "elastic_kill_escalations": self._counters["kill_escalations"],
            "elastic_last_reform_s": self.last_reform_s,
            "elastic_states": states,
        }

    # ----------------------------------------------------------- logging
    def _log(self, message: str) -> None:
        self._append({"kind": "warn", "step": self.max_step_seen,
                      "time": time.time(),
                      "message": f"elastic: {message}"})

    def _log_event(self, h: _TrainerHost, message: str) -> None:
        self._append({"kind": "warn", "step": self.max_step_seen,
                      "time": time.time(),
                      "message": f"elastic host-{h.idx} (incarnation "
                                 f"{h.incarnation}): {message}"})

    def _write_record(self) -> None:
        """One kind="elastic" record with the cumulative elastic_* block
        (after each re-form and at shutdown) — the run's reform timeline
        is auditable from metrics.jsonl alone."""
        self._append({"kind": "elastic", "step": self.max_step_seen,
                      "time": time.time(), **self.stats()})

    def _append(self, rec: dict) -> None:
        try:
            os.makedirs(self.dir, exist_ok=True)
            with open(os.path.join(self.dir, "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec, allow_nan=False) + "\n")
        except OSError:
            pass


# ------------------------------------------------------------- CLI entry


def run_elastic(cfg: ExperimentConfig, hosts: int | None = None,
                max_steps: int | None = None, device: str = "cuda") -> int:
    """`train --elastic N`: coordinator + a heartbeat with no device,
    supervising until the run completes or aborts, its children training
    on `device`. Blocks; returns the exit code. SIGTERM is a graceful full-stop: barrier-save the world,
    write the summary, exit 0 (a second SIGTERM falls through to the
    default action — a wedged barrier stays killable)."""
    coord = ElasticCoordinator(cfg, hosts=hosts, target_step=max_steps,
                               device=device)
    coord.incidents = incident.install(cfg, coord.dir, "elastic")
    hb = None
    metrics_srv = None
    rc = 1
    # graceful-stop handler BEFORE any child exists: a preemption
    # SIGTERM landing mid-start() would otherwise take the default
    # action, skip every finally, and orphan the already-spawned
    # detached trainer sessions
    if threading.current_thread() is threading.main_thread():
        def _on_term(signum, frame):
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            coord.stop()

        signal.signal(signal.SIGTERM, _on_term)
    try:
        coord.start()
        # the heartbeat's module imports torch (no CUDA context): after
        # the spawn, so the children boot meanwhile
        from ..obs.heartbeat import Heartbeat

        hb_ref: dict = {}

        def sample() -> dict:
            s = coord.stats()
            # an idle coordinator (world training away between polls) is
            # healthy, not wedged — but ONLY while the supervise loop is
            # actually completing health passes: an unconditional touch
            # would keep heartbeat.json fresh forever while run() hangs
            # in a re-form or a filesystem walk, hiding the exact wedge
            # the watchdog exists to flag
            if ("hb" in hb_ref and coord.poll_age_s()
                    < 3 * max(float(cfg.elastic.poll_s), 0.05) + 5.0):
                hb_ref["hb"].touch()
            return s

        sample_fn = sample
        if coord.incidents is not None:
            # observe each sample (alert rules + last-K ring) and merge
            # the incident_*/alert_* counters into the heartbeat block
            sample_fn = coord.incidents.wrap_sample(sample)
        hb = Heartbeat(os.path.join(coord.dir, "heartbeat.json"),
                       period_s=cfg.obs.heartbeat_period_s,
                       watchdog_factor=cfg.obs.watchdog_factor,
                       watchdog_min_s=cfg.obs.watchdog_min_s,
                       sample=sample_fn,
                       on_wedge=(None if coord.incidents is None else
                                 lambda dump: coord.incidents.record(
                                     "watchdog_wedge", "critical",
                                     text_files={"stacks.txt": dump})),
                       device=None)  # the supervisor holds no device
        hb_ref["hb"] = hb
        coord.beat_hook = hb.beat

        if cfg.obs.metrics_port is not None:
            # scrapeable elastic_* block (obs/export.py): GET /metrics
            # (Prometheus text) + /healthz (JSON) on the coordinator —
            # the pool's generation/reform/lost-host counters become
            # dashboard series instead of a heartbeat file read
            from ..obs.export import start_metrics_server

            metrics_srv = start_metrics_server(
                coord.stats, port=int(cfg.obs.metrics_port))
            print(json.dumps(
                {"metrics": f"http://127.0.0.1:"
                            f"{metrics_srv.server_address[1]}/metrics"}),
                flush=True)

        try:
            rc = coord.run()
        except KeyboardInterrupt:
            coord.stop()
            coord._stop_world("keyboard interrupt")
            rc = 0
        return rc
    finally:
        coord.close()  # every exit path: no orphaned trainer sessions
        coord._sweep_incidents()  # children are dead: final collection
        coord._write_record()
        if metrics_srv is not None:
            metrics_srv.shutdown()
            metrics_srv.server_close()
        if hb is not None:
            hb.close()
        print(json.dumps(
            {**coord.stats(),
             "completed": rc == 0
             and coord._newest_ckpt_step(valid_only=True) >= coord.target,
             "rc": rc}, allow_nan=False), flush=True)
