"""SLO-driven fleet autoscaler: the fixed replica pool becomes a
load-follower (port of `deepof_tpu/serve/autoscale.py`).

`serve --replicas N` is a fixed pool: under burst it sheds structured
503s, at idle it holds N warm replicas doing nothing — and the router
and fleet already export exactly the signals a load-follower needs.
This module closes that loop. One control thread
evaluates the LIVE router/fleet counters every
`fleet.autoscale_period_s` and drives the pool between
`fleet.min_replicas` and `fleet.max_replicas`:

  Pressure (scale up): a tick counts as pressure when NEW shed/
  unavailable rejections landed since the previous tick (refused work
  is the hardest evidence of under-capacity), when pool occupancy
  (router in-flight over ready * max_in_flight) reaches
  `autoscale_up_occupancy`, or when NEW SLO latency breaches landed
  while the error-budget burn is past `autoscale_up_slo_burn` (capacity
  arrives while the budget still has headroom). Pressure sustained for
  `autoscale_up_after_s` adds ONE replica (`Fleet.scale_up` — a new
  monotonic slot index, spawned through the same supervisor state
  machine every replica lives in).

  Idle (scale down): a tick counts as idle when occupancy is at or
  below `autoscale_down_occupancy` AND nothing was shed. Idle sustained
  for `autoscale_down_after_s` retires ONE replica via
  `Fleet.retire_one`: out of rotation immediately, router in-flight
  drained, SIGTERM (the replica's own drain hook flushes any racing
  request), reap — zero silent drops by construction, counted as
  `retired`, never as an eviction.

  Hysteresis + cooldown: the wide gap between the up and down
  occupancy thresholds is the band where the pool holds steady; ticks
  in the band reset both streaks. `autoscale_up_cooldown_s` keeps one
  burst from spawning the whole ladder before the first new replica
  has booted; `autoscale_down_cooldown_s` (measured from ANY scale
  event) keeps a fresh replica's warm-up idle from immediately
  retiring its sibling. A replica's boot cost cannot flap the pool.

The decision core (`evaluate`) is a pure function of (clock, signals,
accumulated streak state) — unit-testable without threads, subprocesses
or sleeps. Scale events are first-class observability: the
`fleet_autoscale_*` counter block (obs/registry.py-declared) rides the
fleet heartbeat, `/healthz` and `/metrics`, and every scale event
appends one `kind="fleet"` record to the fleet's metrics.jsonl — the
pool-size timeline is auditable from the run dir alone.

No torch, no device: the supervisor runs it (core/supervise.py).
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..core.config import ExperimentConfig


class Autoscaler:
    """See module docstring.

    cfg: the fleet-level experiment config (fleet.autoscale knobs).
    fleet: the live Fleet (scale_up / retire_one / stats).
    router: the live Router (stats — shed/SLO/in-flight signals — and
        in_flight_of, which retire_one drains against).
    """

    def __init__(self, cfg: ExperimentConfig, fleet, router):
        self.cfg = cfg
        self.fc = cfg.serve.fleet
        self.fleet = fleet
        self.router = router
        self.min = max(int(self.fc.min_replicas), 1)
        self.max = max(int(self.fc.max_replicas), 1)
        if self.min > self.max:
            # Fleet.__init__ rejects this too; repeated here so a
            # standalone Autoscaler can never scale past the ceiling
            raise ValueError(
                f"serve.fleet.min_replicas={self.fc.min_replicas} > "
                f"max_replicas={self.fc.max_replicas}: unsatisfiable "
                "autoscale bounds")
        self.period_s = max(float(self.fc.autoscale_period_s), 0.05)
        self._lock = threading.Lock()
        self._counters = {k: 0 for k in (
            "up", "down", "blocked_max", "pressure_ticks", "idle_ticks",
            "slope_ticks")}
        # streak clocks: monotonic time the current pressure/idle run
        # started (None = the condition does not currently hold)
        self._pressure_since: float | None = None
        self._idle_since: float | None = None
        self._last_up_m: float | None = None
        self._last_event_m: float | None = None
        # previous tick's cumulative rejection/breach counts — the
        # deltas are the "NEW refused work this tick" pressure signal
        self._prev_bad = 0
        self._prev_breaches = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-autoscaler")

    # ---------------------------------------------------------- signals
    def signals(self) -> dict:
        """One tick's inputs from the live fleet/router counters."""
        fs = self.fleet.stats()
        rs = self.router.stats()
        ready = int(fs.get("fleet_ready") or 0)
        cap = max(ready, 1) * max(int(self.fc.max_in_flight), 1)
        slo = rs.get("fleet_slo") or {}
        # broken slots (breaker open — terminal, no process, never
        # respawned) must not count toward the pool size: against the
        # max gate they would block scale-up FOREVER while the one
        # surviving replica sheds; backoff slots DO count (they hold
        # resources and respawn into capacity on their own)
        states = fs.get("fleet_states") or {}
        broken = sum(1 for v in states.values() if v == "broken")
        return {
            "size": max(int(fs.get("fleet_replicas") or 0) - broken, 0),
            "ready": ready,
            "bad_total": (int(rs.get("fleet_shed") or 0)
                          + int(rs.get("fleet_unavailable") or 0)),
            "occupancy": float(rs.get("fleet_in_flight") or 0) / cap,
            "slo_breaches": int(slo.get("breaches") or 0),
            "slo_burn": float(slo.get("burn") or 0.0),
            # requests/s growth from the router's per-second completion
            # buckets (router._load_trend) — the PREDICTIVE signal:
            # positive slope means the load is still climbing toward
            # whatever will shed, so capacity can start booting now
            "load_slope": float(rs.get("fleet_load_slope") or 0.0),
        }

    # --------------------------------------------------------- decision
    def evaluate(self, now_m: float, sig: dict) -> tuple[str | None, str]:
        """One control-loop decision from (clock, signals): ("up"|"down"
        |None, reason). Pure in the streak state this object
        accumulates — tests drive it with fabricated clocks and signals,
        no threads or sleeps. Cooldowns and the min/max bounds are
        enforced HERE so a unit test of the policy is a test of the
        shipped behavior."""
        bad_delta = sig["bad_total"] - self._prev_bad
        breach_delta = sig["slo_breaches"] - self._prev_breaches
        self._prev_bad = sig["bad_total"]
        self._prev_breaches = sig["slo_breaches"]

        shed_pressure = bad_delta > 0
        occ_pressure = sig["occupancy"] >= float(self.fc.autoscale_up_occupancy)
        slo_pressure = (breach_delta > 0 and sig["slo_burn"]
                        >= float(self.fc.autoscale_up_slo_burn))
        # predictive pressure: the load TREND crossed
        # autoscale_up_slope req/s-per-s — scale while the ramp is still
        # climbing, before occupancy saturates or the first shed lands.
        # Disabled (<= 0) keeps the policy reactive only.
        slope_pressure = (float(self.fc.autoscale_up_slope) > 0
                          and sig.get("load_slope", 0.0)
                          >= float(self.fc.autoscale_up_slope))
        pressure = (shed_pressure or occ_pressure or slo_pressure
                    or slope_pressure)
        idle = (bad_delta == 0 and sig["occupancy"]
                <= float(self.fc.autoscale_down_occupancy))

        with self._lock:
            if pressure:
                self._counters["pressure_ticks"] += 1
                if slope_pressure and not (shed_pressure or occ_pressure
                                           or slo_pressure):
                    # the slope ALONE saw it coming: the tick the pool
                    # moved ahead of the load instead of behind it
                    self._counters["slope_ticks"] += 1
                self._idle_since = None
                if self._pressure_since is None:
                    self._pressure_since = now_m
            elif idle:
                self._counters["idle_ticks"] += 1
                self._pressure_since = None
                if self._idle_since is None:
                    self._idle_since = now_m
            else:
                # the hysteresis band between the thresholds: hold, and
                # require any future decision to re-earn its full window
                self._pressure_since = None
                self._idle_since = None

            if (self._pressure_since is not None
                    and now_m - self._pressure_since
                    >= float(self.fc.autoscale_up_after_s)):
                # reactive causes outrank the predictive one in the
                # label: "load_slope" on a scale record means the pool
                # grew BEFORE any shed/breach/saturation existed
                why = ("shed" if shed_pressure
                       else "slo_burn" if slo_pressure
                       else "occupancy" if occ_pressure else "load_slope")
                if sig["size"] >= self.max:
                    self._counters["blocked_max"] += 1
                    return None, f"pressure ({why}) but at max_replicas"
                if (self._last_up_m is not None
                        and now_m - self._last_up_m
                        < float(self.fc.autoscale_up_cooldown_s)):
                    return None, "up cooldown"
                return "up", why
            if (self._idle_since is not None
                    and now_m - self._idle_since
                    >= float(self.fc.autoscale_down_after_s)):
                # floor on BOTH counts: size (slots) keeps the pool's
                # footprint at min, ready keeps its serving capacity
                # there — a broken/backoff slot counts toward size but
                # serves nothing, and retiring the last READY replica
                # because a dead sibling pads the count would leave the
                # pool serving nothing at all
                if sig["size"] <= self.min or sig["ready"] <= self.min:
                    return None, "idle but at min_replicas"
                if (self._last_event_m is not None
                        and now_m - self._last_event_m
                        < float(self.fc.autoscale_down_cooldown_s)):
                    return None, "down cooldown"
                return "down", "sustained idle"
        return None, "holding"

    # ------------------------------------------------------------- act
    def _tick(self) -> None:
        now_m = time.monotonic()
        sig = self.signals()
        action, reason = self.evaluate(now_m, sig)
        if action == "up":
            idx = self.fleet.scale_up()
            if idx is None:
                return  # fleet stopping: no event
            with self._lock:
                self._counters["up"] += 1
                self._last_up_m = now_m
                self._last_event_m = now_m
                self._pressure_since = None  # re-earn the next window
            self._record("scale_up", reason, sig, replica=idx)
        elif action == "down":
            idx = self.fleet.retire_one(self.router)  # blocks: drains
            if idx is None:
                return
            with self._lock:
                self._counters["down"] += 1
                self._last_event_m = time.monotonic()
                self._idle_since = None
            self._record("scale_down", reason, sig, replica=idx)

    def _record(self, event: str, reason: str, sig: dict,
                replica: int) -> None:
        """One kind="fleet" scale record into the fleet's metrics.jsonl:
        the pool-size timeline."""
        try:
            after = self.fleet.size
            before = after + (1 if event == "scale_down" else -1)
            rec = {"kind": "fleet", "step": 0, "time": time.time(),
                   "event": event, "reason": reason, "replica": replica,
                   "replicas_before": before, "replicas_after": after,
                   "occupancy": round(sig["occupancy"], 4),
                   **self.stats()}
            os.makedirs(self.cfg.train.log_dir, exist_ok=True)
            with open(os.path.join(self.cfg.train.log_dir,
                                   "metrics.jsonl"), "a") as f:
                f.write(json.dumps(rec, allow_nan=False) + "\n")
        except OSError:
            pass

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        """The fleet_autoscale_* counter block (obs/registry.py-declared;
        rides the fleet heartbeat, /metrics, and the shutdown
        kind="serve" record)."""
        with self._lock:
            c = dict(self._counters)
            last = self._last_event_m
        return {
            "fleet_autoscale_enabled": True,
            "fleet_autoscale_min": self.min,
            "fleet_autoscale_max": self.max,
            "fleet_autoscale_up": c["up"],
            "fleet_autoscale_down": c["down"],
            "fleet_autoscale_blocked_max": c["blocked_max"],
            "fleet_autoscale_pressure_ticks": c["pressure_ticks"],
            "fleet_autoscale_idle_ticks": c["idle_ticks"],
            "fleet_autoscale_slope_ticks": c["slope_ticks"],
            "fleet_autoscale_last_event_s": (
                round(time.monotonic() - last, 1)
                if last is not None else None),
        }

    # --------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.period_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - scaling must not die mid-run
                pass  # next tick re-reads live state; fleet health owns
                #       replica failures, this loop only sizes the pool

    def close(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            # worst case: a tick is inside retire_one — router drain
            # (drain_timeout_s) then reap with a term_grace_s +
            # drain_timeout_s deadline before the SIGKILL escalation
            self._thread.join(timeout=self.period_s
                              + 2.0 * float(self.fc.drain_timeout_s)
                              + float(self.fc.term_grace_s) + 5.0)

    def __enter__(self) -> "Autoscaler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
