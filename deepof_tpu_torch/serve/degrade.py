"""Brownout controller: rebuild-free quality degradation under overload
(port of `deepof_tpu/serve/degrade.py`).

The autoscaler (serve/autoscale.py) answers overload with CAPACITY —
but a replica takes seconds-to-minutes to spawn, warm and join the
pool, and until it does the router's only moves are spill then
structured 503 shed. This module adds the missing fast axis: QUALITY.
One control thread evaluates the live router/fleet counters every
`serve.degrade.period_s` (deliberately faster than the autoscaler's
cadence) and walks a declared brownout ladder:

  L0  normal — every request serves at its asked-for operating point.
  L1  downgrade the DEFAULT precision tier: requests that name no
      `precision` serve at the cheapest configured tier
      (serve.precisions' last entry — bf16/int8); an explicit
      `precision` is always honored.
  L2  additionally route to the next-smaller shape bucket on the
      resolution ladder: the resize protocol already rescales flow to
      native pixel units from ANY bucket, so only accuracy drops.
  L3  additionally shed low-priority requests (X-Priority: low) at
      router admission with a structured 503 — default-priority work
      keeps serving on the degraded operating point.

Degradation NEVER builds anything: every (bucket, tier) pair the ladder
can reach ran once in each replica's `engine.warm()` before it
announced (the kernels built, cuDNN's first calls for the shape made),
so a level transition is a pure routing decision.

Escalation/recovery is the autoscaler's hysteresis/cooldown pattern
with a symmetric DOWN ladder: pressure (new shed/unavailable
rejections, occupancy >= up_occupancy, or SLO burn >= up_slo_burn)
sustained for `escalate_after_s` raises the level by ONE; calm (zero
new rejections AND occupancy <= down_occupancy AND burn under the
threshold) sustained for `recover_after_s` lowers it by one. Ticks in
the band between the thresholds reset both streaks, and the cooldowns
keep an oscillating load from flapping the level. The decision core
(`evaluate`) is a pure function of (clock, signals, accumulated streak
state) — unit-testable without threads or sleeps, same contract as
`Autoscaler.evaluate` and the `core/supervise` verdict functions.

Interplay with the autoscaler: both watch the same signals, so
overload degrades within ~a second AND starts a scale-up; when the new
replica lands, occupancy falls, the calm streak accrues, and the level
walks back down — degrade instantly, scale up slowly, restore when
capacity arrives. Every transition is first-class observability: the
`degrade_*` counter block rides router.stats() -> /healthz, /metrics
and the fleet heartbeat; each transition appends one kind="serve"
record to the fleet's metrics.jsonl. Sustained L3 (`l3_sustained_s`)
sets `degrade_l3_sustained`. Entering L3 commits a critical
`brownout_l3` incident bundle when the fleet has a recorder
(`obs/incident.py`; `incidents`, set by `serve/fleet.py::run_fleet`).

No torch, no device: the supervisor runs it (core/supervise.py).
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..core.config import ExperimentConfig

#: Human labels for the ladder, indexed by level (stats/records/docs).
LEVELS: tuple[str, ...] = ("normal", "tier_downgrade", "bucket_downgrade",
                           "shed_low_priority")


class DegradeController:
    """See module docstring.

    cfg: the fleet-level experiment config (serve.degrade knobs).
    fleet: the live Fleet (stats — ready count).
    router: the live Router (stats — shed/occupancy/SLO signals).
    """

    def __init__(self, cfg: ExperimentConfig, fleet, router):
        self.cfg = cfg
        self.dc = cfg.serve.degrade
        self.fc = cfg.serve.fleet
        self.fleet = fleet
        self.router = router
        self.max_level = min(max(int(self.dc.max_level), 0), 3)
        self.period_s = max(float(self.dc.period_s), 0.05)
        self._lock = threading.Lock()
        self._level = 0
        self._counters = {k: 0 for k in (
            "transitions", "escalations", "recoveries", "l3_entries")}
        # streak clocks: monotonic time the current pressure/calm run
        # started (None = the condition does not currently hold)
        self._pressure_since: float | None = None
        self._calm_since: float | None = None
        self._last_escalate_m: float | None = None
        self._last_event_m: float | None = None
        # monotonic time the fleet entered L3 (None below L3): the
        # l3_sustained_s clock
        self._l3_since: float | None = None
        # the supervisor's incident recorder (run_fleet sets it under
        # obs.incidents): L3 entry -> a critical brownout_l3 bundle
        self.incidents = None
        # previous tick's cumulative rejection count — the delta is the
        # "NEW refused work this tick" pressure signal (deliberately
        # EXCLUDES the L3 low-priority sheds this controller causes:
        # its own shedding must not hold it at L3 forever)
        self._prev_bad = 0
        self._last_reason = "init"
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fleet-degrade")

    # ---------------------------------------------------------- signals
    def signals(self) -> dict:
        """One tick's inputs from the live fleet/router counters."""
        fs = self.fleet.stats()
        rs = self.router.stats()
        ready = int(fs.get("fleet_ready") or 0)
        cap = max(ready, 1) * max(int(self.fc.max_in_flight), 1)
        slo = rs.get("fleet_slo") or {}
        return {
            "ready": ready,
            # saturation sheds only — degrade_shed_low is this
            # controller's own output, never its input
            "bad_total": (int(rs.get("fleet_shed") or 0)
                          + int(rs.get("fleet_unavailable") or 0)),
            # router in-flight over pool capacity: the fleet-wide
            # queue-depth signal (every queued request is in-flight at
            # the router until its reply lands)
            "occupancy": float(rs.get("fleet_in_flight") or 0) / cap,
            "slo_burn": float((slo.get("burn") or 0.0)),
        }

    # --------------------------------------------------------- decision
    def evaluate(self, now_m: float, sig: dict) -> tuple[str | None, str]:
        """One control-loop decision from (clock, signals):
        ("escalate"|"recover"|None, reason). Pure in the streak state
        this object accumulates — tests drive it with fabricated clocks
        and signals, no threads or sleeps. Cooldowns and the level
        bounds are enforced HERE so a unit test of the policy is a test
        of the shipped behavior."""
        bad_delta = sig["bad_total"] - self._prev_bad
        shed_pressure = bad_delta > 0
        occ_pressure = sig["occupancy"] >= float(self.dc.up_occupancy)
        burn_pressure = sig["slo_burn"] >= float(self.dc.up_slo_burn)
        pressure = shed_pressure or occ_pressure or burn_pressure
        calm = (bad_delta == 0
                and sig["occupancy"] <= float(self.dc.down_occupancy)
                and not burn_pressure)
        with self._lock:
            self._prev_bad = sig["bad_total"]
            if pressure:
                self._calm_since = None
                if self._pressure_since is None:
                    self._pressure_since = now_m
            elif calm:
                self._pressure_since = None
                if self._calm_since is None:
                    self._calm_since = now_m
            else:
                # the hysteresis band between the thresholds: hold, and
                # require any future transition to re-earn its window
                self._pressure_since = None
                self._calm_since = None

            if (self._pressure_since is not None
                    and now_m - self._pressure_since
                    >= float(self.dc.escalate_after_s)):
                why = ("shed" if shed_pressure
                       else "slo_burn" if burn_pressure else "occupancy")
                if self._level >= self.max_level:
                    return None, f"pressure ({why}) but at max_level"
                if (self._last_escalate_m is not None
                        and now_m - self._last_escalate_m
                        < float(self.dc.escalate_cooldown_s)):
                    return None, "escalate cooldown"
                return "escalate", why
            if (self._calm_since is not None
                    and now_m - self._calm_since
                    >= float(self.dc.recover_after_s)):
                if self._level <= 0:
                    return None, "calm at L0"
                if (self._last_event_m is not None
                        and now_m - self._last_event_m
                        < float(self.dc.recover_cooldown_s)):
                    return None, "recover cooldown"
                return "recover", "sustained calm"
        return None, "holding"

    # ------------------------------------------------------------- act
    def level(self) -> int:
        """The live brownout level — the router's per-request hook."""
        with self._lock:
            return self._level

    def _tick(self) -> None:
        now_m = time.monotonic()
        sig = self.signals()
        action, reason = self.evaluate(now_m, sig)
        if action is None:
            return
        with self._lock:
            before = self._level
            if action == "escalate":
                self._level = min(before + 1, self.max_level)
                self._counters["escalations"] += 1
                self._last_escalate_m = now_m
                # re-earn the next window: one sustained burst walks
                # the ladder one deliberate step per window, not all at
                # once
                self._pressure_since = None
                if self._level == 3 and before < 3:
                    self._counters["l3_entries"] += 1
                    self._l3_since = now_m
            else:
                self._level = max(before - 1, 0)
                self._counters["recoveries"] += 1
                self._calm_since = None
                if before == 3:
                    self._l3_since = None
            self._counters["transitions"] += 1
            self._last_event_m = now_m
            self._last_reason = reason
            after = self._level
        event = ("degrade_escalate" if action == "escalate"
                 else "degrade_recover")
        self._record(event, reason, sig, before, after)
        if action == "escalate" and after == 3 and self.incidents is not None:
            # the fleet now refuses work (low-priority sheds): the bundle
            # keeps the verdict and the signals that drove it; the dedup
            # window absorbs re-entries
            self.incidents.record(
                "brownout_l3", "critical",
                trigger={"reason": reason, "level": after,
                         "occupancy": round(sig["occupancy"], 4),
                         "slo_burn": round(sig["slo_burn"], 4)})

    def _record(self, event: str, reason: str, sig: dict,
                before: int, after: int) -> None:
        """One kind="serve" transition record into the fleet's
        metrics.jsonl — the brownout-level timeline, next to the
        autoscaler's kind="fleet" scale records."""
        try:
            rec = {"kind": "serve", "step": 0, "time": time.time(),
                   "event": event, "reason": reason,
                   "level_before": before, "level_after": after,
                   "level_name": LEVELS[after],
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
        """The degrade_* counter block (obs/registry.py-declared; rides
        router.stats() -> /healthz, /metrics, the fleet heartbeat and
        the shutdown kind="serve" record)."""
        now_m = time.monotonic()
        with self._lock:
            c = dict(self._counters)
            level = self._level
            l3_since = self._l3_since
            reason = self._last_reason
        l3_age = (now_m - l3_since) if l3_since is not None else None
        return {
            "degrade_enabled": True,
            "degrade_level": level,
            "degrade_level_name": LEVELS[level],
            "degrade_transitions": c["transitions"],
            "degrade_escalations": c["escalations"],
            "degrade_recoveries": c["recoveries"],
            "degrade_l3_entries": c["l3_entries"],
            "degrade_l3_age_s": (round(l3_age, 1)
                                 if l3_age is not None else None),
            # L3 held continuously past the configured budget —
            # brownout as a steady state means the autoscaler's
            # capacity never arrived
            "degrade_l3_sustained": bool(
                l3_age is not None
                and l3_age >= float(self.dc.l3_sustained_s)),
            "degrade_last_reason": reason,
        }

    # --------------------------------------------------------- lifecycle
    def start(self) -> None:
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(timeout=self.period_s):
            try:
                self._tick()
            except Exception:  # noqa: BLE001 - brownout must not die mid-run
                pass  # next tick re-reads live state

    def close(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=self.period_s + 5.0)

    def __enter__(self) -> "DegradeController":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
