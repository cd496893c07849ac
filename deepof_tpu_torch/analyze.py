"""Offline training-log analysis (port of `deepof_tpu/analyze.py`): the
reference's `analyze_test_loss.py` (grep stdout for `***Test:` lines +
matplotlib) rebuilt over the structured JSONL metrics log, and `tail`'s
one-glance health of a live or finished run.

Prints per-kind summaries (train loss trajectory, eval AEE/AAE curve,
throughput, the staged recipe's block) and, when matplotlib is
importable, writes loss/AEE curves as PNGs next to the log.

Deliberately imports NOTHING from the training stack (no torch):
analyzing a log must not create a CUDA context next to a live trainer
or server. The whole chain (`obs/aggregate.py`, `obs/registry.py`,
`obs/export.py`, `obs/incident.py`) is stdlib-only.

The executable ledger (`obs/ledger.py`, stdlib-only too): `analyze` and
`tail_summary` carry the run's condensed `ledger` block and, when a
baseline exists (`--ledger-baseline`, or `<log_dir>/ledger_baseline.jsonl`),
the `ledger_diff` verdict that `tail` turns into exit code 8; with
`fleet`, every supervised child's ledger is diffed against the same
baseline. The `exec_*` counters of a heartbeat or a serve record make
the `exec` block.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import time
from collections import defaultdict

from .obs.registry import merge_stats_blocks, resilience_keys


def _finite(records: list[dict], key: str) -> list[dict]:
    return [r for r in records
            if isinstance(r.get(key), (int, float))
            and math.isfinite(r[key])]


def load_records(log_dir: str, filename: str = "metrics.jsonl") -> list[dict]:
    path = os.path.join(log_dir, filename)
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # tolerate torn writes from a killed run
    return records


def _phase_breakdown(rec: dict) -> dict | None:
    """Host-phase share of accounted loop time from ONE train record.

    `phase_<name>_s` fields are cumulative totals (StepTimer), so the
    freshest record carries the whole run so far; shares are each
    phase's fraction of the summed phase time (assemble / put / dispatch
    / fetch — note put+fetch run on background threads, so shares answer
    "where does host work go", not "what serializes the main thread").
    """
    phases = {k[len("phase_"):-len("_s")]: r
              for k, r in rec.items()
              if k.startswith("phase_") and k.endswith("_s")
              and isinstance(r, (int, float)) and math.isfinite(r)}
    total = sum(phases.values())
    if not phases or total <= 0:
        return None
    return {
        "seconds": {k: round(v, 4) for k, v in sorted(phases.items())},
        "share": {k: round(v / total, 4) for k, v in sorted(phases.items())},
    }


def _counter_summary(rec: dict) -> dict | None:
    """Starvation + input-pipeline counters from one (cumulative) train
    record. `starvation_rate` approximates starved dispatches per
    trained step (with steps_per_call=K one dispatch serves K steps, so
    the per-dispatch rate is at most 1/K of the per-step figure)."""
    out: dict = {}
    step = rec.get("step", 0)
    starved = rec.get("starved")
    if isinstance(starved, (int, float)):
        out["starved"] = starved
        if isinstance(step, int) and step > 0:
            out["starvation_rate"] = round(starved / step, 6)
    res = _resilience_counters(rec)
    if res:
        out["resilience"] = res
    data = {k[len("data_"):]: v for k, v in rec.items()
            if k.startswith("data_")}
    if data:
        out["data"] = data
    return out or None


#: Resilience-layer counters (cumulative, in train records AND the
#: heartbeat): recovery activity an operator should see at a glance.
#: Driven from the observability schema (obs/registry.py — the single
#: owner of which keys exist and how they surface), not a hand-kept
#: list: registering a counter with resilience=True adds it here.
_RESILIENCE_KEYS = resilience_keys()


def _resilience_counters(rec: dict) -> dict:
    """Nonzero resilience counters from one record (zero counters are
    the healthy steady state and would only be noise)."""
    out = {k: rec[k] for k in _RESILIENCE_KEYS
           if isinstance(rec.get(k), (int, float)) and rec[k]}
    out.update({k: v for k, v in rec.items()
                if k.startswith("fault_") and isinstance(v, (int, float))
                and v})
    return out


def _serve_counters(rec: dict) -> dict:
    """`serve_*` counters from one record or heartbeat sample (the
    serving subsystem's block: requests/responses/errors, batch
    occupancy, latency percentiles, queue depths, and the per-precision
    `requests_by_tier`/`responses_by_tier` maps — a tier nobody asks
    for shows up as a zero here, not as silence)."""
    return {k[len("serve_"):]: v for k, v in rec.items()
            if k.startswith("serve_") and v is not None}


def _fleet_counters(rec: dict) -> dict:
    """`fleet_*` counters from one record or heartbeat sample (the
    serving-fleet block: replica states, evictions/respawns, circuit
    breaker, failover retries, shed counts)."""
    return {k[len("fleet_"):]: v for k, v in rec.items()
            if k.startswith("fleet_") and v is not None}


def _degrade_counters(rec: dict) -> dict:
    """`degrade_*` counters from one record or heartbeat sample (the
    brownout plane, serve/degrade.py: the live level, escalation/
    recovery ledger, L3 age, and the tier/bucket downgrade + low-
    priority shed counts the level drove). `tail` exits 10 when the
    block shows sustained L3."""
    return {k[len("degrade_"):]: v for k, v in rec.items()
            if k.startswith("degrade_") and v is not None}


def _deadline_counters(rec: dict) -> dict:
    """`deadline_*` counters from one record or heartbeat sample (the
    propagated-deadline plane: budgeted arrivals and where expired
    budgets died — router admission, engine enqueue/flush, the server's
    response wait)."""
    return {k[len("deadline_"):]: v for k, v in rec.items()
            if k.startswith("deadline_") and v is not None}


def _elastic_counters(rec: dict) -> dict:
    """`elastic_*` counters from one record or heartbeat sample (the
    elastic-training block, train/elastic.py: generation, re-forms,
    lost hosts, resumed step, steps lost, per-host states). `tail`
    exits 5 when the block shows the run had to re-form."""
    return {k[len("elastic_"):]: v for k, v in rec.items()
            if k.startswith("elastic_") and v is not None}


def _exec_counters(rec: dict) -> dict:
    """`exec_*` counters from one record or heartbeat sample (the
    executable-ledger block, obs/ledger.py: lowerings, recompiles,
    compile seconds, cache hits/misses, per-executable fingerprints,
    nominal-roofline MFU)."""
    return {k[len("exec_"):]: v for k, v in rec.items()
            if k.startswith("exec_") and v is not None}


def _recipe_counters(rec: dict) -> dict:
    """`recipe_*` counters from one record or heartbeat sample (the
    staged-recipe engine, train/recipe.py: active stage index/count,
    stage advances, the deterministic mixture's per-dataset draw
    counts, and the newest advance trigger's cause)."""
    return {k[len("recipe_"):]: v for k, v in rec.items()
            if k.startswith("recipe_") and v is not None}


def _ledger_rows(log_dir: str) -> list[dict]:
    """The run dir's ledger.jsonl rows, [] when it recorded none —
    loaded ONCE per tail/analyze pass and shared by the condensed
    summary and the drift verdict (a `tail --follow` tick must not
    parse the same file twice forever)."""
    from .obs.ledger import load_ledger

    try:
        return load_ledger(log_dir)
    except OSError:
        return []


def ledger_drift(log_dir: str, baseline: str | None = None,
                 fleet: bool = False, run_rows: list | None = None,
                 **bounds) -> dict | None:
    """The perf-regression sentinel's verdict for a run dir: the run's
    ledger.jsonl diffed against its baseline ledger (an explicit path,
    or the committed-by-convention <log_dir>/ledger_baseline.jsonl).
    With fleet=True, every supervised child dir's ledger is diffed
    against the SAME baseline (a fleet's replicas share one lattice)
    and condensed per child; `failed` then covers root and children —
    `tail` maps it to exit code 8. None when there is no baseline or no
    ledger to compare."""
    from .obs.ledger import diff_ledgers, find_baseline, ledger_verdict

    base_path = find_baseline(log_dir, baseline)
    if base_path is None:
        return None
    # the baseline is shared by the root and every fleet child — load
    # it ONCE per pass, not once per process per --follow tick
    from .obs.ledger import load_ledger

    try:
        base_rows = load_ledger(base_path)
    except OSError:
        base_rows = None
    out = ledger_verdict(log_dir, base_path, run_rows=run_rows,
                         base_rows=base_rows, **bounds)
    if fleet:
        children: dict[str, dict] = {}
        for name, d in discover_process_dirs(log_dir).items():
            v = ledger_verdict(d, base_path, base_rows=base_rows,
                               **bounds)
            if v is None:
                continue
            children[name] = {
                "failed": v["failed"],
                **{k: len(v[k]) for k in
                   ("fingerprint_drift", "unexpected_recompiles",
                    "compile_blowups", "memory_growth")}}
        if children:
            if out is None:
                # the root process lowered nothing but its children
                # did: a zero-comparison diff keeps the full documented
                # verdict schema (failure-class lists, bounds, new/
                # missing) instead of a bare {"failed": ...} whose
                # shape depends on whether the root had a ledger
                out = diff_ledgers([], [], **bounds)
            out["children"] = children
            out["failed"] = bool(out["failed"]
                                 or any(c["failed"]
                                        for c in children.values()))
    return out


#: Per-pyramid-scale loss-decomposition record fields (train/loop.py
#: writes them into every periodic train record, finest scale first).
_SCALE_FIELDS = ("loss_total_by_scale", "loss_photo_by_scale",
                 "loss_smooth_by_scale")


def eval_trend(evals: list[dict], window: int = 8,
               regress_tol: float = 0.02) -> dict | None:
    """Eval-EPE trend over the newest `window` eval records: the
    least-squares slope of AEE vs step (per 1000 steps — a readable
    unit at any eval cadence) plus a regression flag. `regressing` is
    True when the recent slope is positive AND the newest AEE sits more
    than `regress_tol` above the run's best — one noisy eval above best
    does not flag, a sustained climb does. This is the signal an
    EPE-driven curriculum switch point consumes (ROADMAP item 3): a
    plateaued-or-regressing stage is what triggers the next stage."""
    pts = [(r["step"], r["aee"]) for r in evals
           if isinstance(r.get("step"), int)
           and isinstance(r.get("aee"), (int, float))
           and math.isfinite(r["aee"])]
    if len(pts) < 3:
        return None
    recent = pts[-max(int(window), 3):]
    xs = [p[0] for p in recent]
    ys = [p[1] for p in recent]
    n = len(xs)
    mx = sum(xs) / n
    my = sum(ys) / n
    denom = sum((x - mx) ** 2 for x in xs)
    if denom <= 0:
        return None
    slope = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / denom
    best = min(y for _, y in pts)
    last = pts[-1][1]
    return {
        "window": n,
        "slope_aee_per_kstep": round(slope * 1e3, 6),
        "last_aee": last,
        "best_aee": best,
        "regressing": bool(slope > 0
                           and last > best * (1.0 + float(regress_tol))),
    }


def _scale_event_summary(scales: list[dict]) -> dict:
    """Condensed view of the autoscaler's kind="fleet" scale records:
    how many times the pool moved, which way, and the newest event."""
    last = scales[-1]
    return {
        "events": len(scales),
        "ups": sum(1 for r in scales if r.get("event") == "scale_up"),
        "downs": sum(1 for r in scales if r.get("event") == "scale_down"),
        "last": {k: last.get(k) for k in
                 ("event", "reason", "replica", "replicas_before",
                  "replicas_after", "time") if last.get(k) is not None},
    }


def summarize(records: list[dict]) -> dict:
    by_kind: dict[str, list[dict]] = defaultdict(list)
    for r in records:
        by_kind[r.get("kind", "?")].append(r)

    out: dict = {"counts": {k: len(v) for k, v in by_kind.items()}}

    raw_train = [r for r in by_kind.get("train", []) if "loss" in r]
    train = _finite(raw_train, "loss")
    if len(train) != len(raw_train):  # NaN losses break min() and JSON
        out["non_finite_train_records"] = len(raw_train) - len(train)
    if train:
        first, last = train[0], train[-1]
        best = min(train, key=lambda r: r["loss"])
        out["train"] = {
            "steps": last["step"],
            "first_loss": first["loss"],
            "last_loss": last["loss"],
            "best_loss": best["loss"],
            "best_step": best["step"],
            "last_lr": last.get("lr"),
            "items_per_sec_per_chip": last.get("items_per_sec_per_chip"),
        }
        # per-pyramid-scale loss decomposition from the newest record
        # (finest first): where the objective's mass sits — photometric
        # vs smoothness, coarse vs fine — not just its total
        for field in _SCALE_FIELDS:
            if isinstance(last.get(field), list):
                out["train"][field] = last[field]
        # phase/counter aggregation rides on the freshest train record
        # (phase_*_s / starved / data_* fields are cumulative totals)
        newest = raw_train[-1]
        phases = _phase_breakdown(newest)
        if phases:
            out["phases"] = phases
        counters = _counter_summary(newest)
        if counters:
            out["counters"] = counters
        # staged-recipe block (train/recipe.py extra_stats ride every
        # periodic train record): stage index, advances, mixture draws
        recipe = _recipe_counters(newest)
        if recipe:
            out["recipe"] = recipe

    evals = _finite(by_kind.get("eval", []), "aee")
    if evals:
        best = min(evals, key=lambda r: r["aee"])
        out["eval"] = {
            "evals": len(evals),
            "last_aee": evals[-1]["aee"],
            "best_aee": best["aee"],
            "best_step": best["step"],
            "last_aae": evals[-1].get("aae"),
        }
        trend = eval_trend(evals)
        if trend:
            out["eval_trend"] = trend
    accs = _finite(by_kind.get("eval", []), "accuracy")
    if accs:
        best = max(accs, key=lambda r: r["accuracy"])
        out["accuracy"] = {"last": accs[-1]["accuracy"],
                          "best": best["accuracy"], "best_step": best["step"]}

    serves = by_kind.get("serve", [])
    if serves:
        # cumulative counters: the newest serve record carries the whole
        # serving session (server.py / fleet.py append one at shutdown)
        serve = _serve_counters(serves[-1])
        if serve:
            out["serve"] = serve
        fleet = _fleet_counters(serves[-1])
        if fleet:
            out["fleet"] = fleet
        degrade = _degrade_counters(serves[-1])
        if degrade:
            out["degrade"] = degrade
        deadline = _deadline_counters(serves[-1])
        if deadline:
            out["deadline"] = deadline
        execs = _exec_counters(serves[-1])
        if execs:
            out["exec"] = execs

    scales = by_kind.get("fleet", [])
    if scales:
        # the autoscaler's pool-size timeline (serve/autoscale.py
        # appends one kind="fleet" record per scale event): the event
        # count plus the newest event's what/why/when
        out["scale_events"] = _scale_event_summary(scales)

    elastics = by_kind.get("elastic", [])
    if elastics:
        # cumulative: the newest elastic record carries the whole run's
        # re-form history (train/elastic.py appends one per re-form and
        # one at shutdown)
        elastic = _elastic_counters(elastics[-1])
        if elastic:
            out["elastic"] = elastic

    warns = by_kind.get("warn", [])
    if warns:
        out["warnings"] = [r.get("message", "") for r in warns[-5:]]
    return out


def load_heartbeat(log_dir: str) -> dict | None:
    """The run's heartbeat.json (obs/heartbeat.py), or None. The file is
    atomically rewritten, so a read never sees a torn record."""
    try:
        with open(os.path.join(log_dir, "heartbeat.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# ----------------------------------------------- multi-process run dirs


def discover_process_dirs(log_dir: str) -> dict[str, str]:
    """{child name -> dir} for a supervised run's per-process subdirs
    (fleet replicas / elastic trainer hosts) that actually hold
    observability artifacts. Empty for a plain single-process run.
    Delegates to obs/aggregate.py's walker — ONE definition of "a child
    process dir", shared with `trace_summary --merge`, so the two views
    can never disagree about which processes a drill contains."""
    from .obs.aggregate import discover_processes  # stdlib-only chain

    out: dict[str, str] = {}
    for p in discover_processes(log_dir):
        if not p["rel"]:
            continue  # the supervisor itself: the caller's own summary
        out[p["rel"].replace(os.sep, "/")] = p["dir"]
    return out


def _process_summary(d: str, now: float) -> dict:
    """One child process's condensed health block: record counts, the
    live heartbeat verdict, and whichever counter blocks (serve / fleet
    / elastic / resilience) the process emits."""
    out: dict = {}
    try:
        records = load_records(d)
    except FileNotFoundError:
        records = []
    out["records"] = len(records)
    hb = load_heartbeat(d)
    newest: dict = {}
    for kind in ("serve", "elastic"):
        kinds = [r for r in records if r.get("kind") == kind]
        if kinds:
            newest.update(kinds[-1])
    if hb is not None:
        newest.update(hb)  # fresher than any record, wins per key
        out["step"] = hb.get("step")
        out["wedged"] = hb.get("wedged")
        t = hb.get("time")
        if isinstance(t, (int, float)):
            out["heartbeat_age_s"] = round(now - t, 1)
    for name, extract in (("serve", _serve_counters),
                          ("fleet", _fleet_counters),
                          ("degrade", _degrade_counters),
                          ("deadline", _deadline_counters),
                          ("elastic", _elastic_counters),
                          ("exec", _exec_counters),
                          ("recipe", _recipe_counters)):
        block = extract(newest)
        if block:
            out[name] = block
    res = _resilience_counters(newest)
    if res:
        out["resilience"] = res
    warns = [r for r in records if r.get("kind") == "warn"]
    if warns:
        out["warnings"] = len(warns)
    return out


def aggregate_processes(log_dir: str, now: float | None = None) -> dict | None:
    """The whole-drill view of a multi-process run dir: one condensed
    block per child (replica-N / host-N) plus a `merged` block — summed
    serve counters and the EXACT fixed-bucket latency-histogram merge
    (obs/export.py) across every child that reports one. None when the
    dir has no supervised children (plain run)."""
    dirs = discover_process_dirs(log_dir)
    if not dirs:
        return None
    now = time.time() if now is None else now
    children = {name: _process_summary(d, now) for name, d in dirs.items()}
    # registry-driven merge (obs/registry.py): every serve-owned counter
    # combines by its declared kind — sums add, high-water marks max,
    # per-tier maps merge key-wise, histograms merge EXACTLY per key
    # (request latency and per-session-frame latency are separate
    # stories), gauges/bools/derived values are dropped. A counter
    # registered tomorrow joins this block with no edit here — the
    # hand-kept sum list this replaces missed one in four of the last
    # six PRs.
    merged = merge_stats_blocks(
        [child.get("serve") or {} for child in children.values()],
        prefix="serve_")  # child blocks store serve_* keys stripped
    out = {"processes": children}
    if merged:
        out["merged"] = merged
    # the fleet-wide executable-ledger view: per-replica exec_* blocks
    # merged by their registry kinds (compile seconds and cache counters
    # sum; fingerprints and MFU stay per-process — state/derived)
    merged_exec = merge_stats_blocks(
        [child.get("exec") or {} for child in children.values()],
        prefix="exec_")
    if merged_exec:
        out["merged_exec"] = merged_exec
    return out


def tail_summary(log_dir: str, recent: int = 10,
                 now: float | None = None, fleet: bool = False,
                 ledger_baseline: str | None = None,
                 ledger_bounds: dict | None = None) -> dict:
    """One-glance health of a LIVE or finished run (`deepof_tpu tail`):
    where it is, whether it is moving, how fast recently vs overall,
    where host time goes, and how stale the heartbeat is.

    recent: train records in the throughput-trend window. The per-record
    `steps_per_sec` is a since-start cumulative average, so the recent
    rate is recomputed from the newest records' (step, time) gaps —
    median of per-gap slopes, robust to one eval/ckpt pause inside the
    window — the number that answers "is it slowing down?".
    fleet: also aggregate the run dir's supervised children (fleet
    replicas / elastic hosts) into a `processes` + `merged` block
    (`tail --fleet`) — the whole drill in one read.
    """
    records = load_records(log_dir)
    now = time.time() if now is None else now
    out: dict = {"log_dir": log_dir, "records": len(records)}
    if records:
        t = records[-1].get("time")
        if isinstance(t, (int, float)):
            out["last_record_age_s"] = round(now - t, 1)

    train = [r for r in records if r.get("kind") == "train"]
    if train:
        last = train[-1]
        out["step"] = last.get("step")
        out["loss"] = last.get("loss")
        out["steps_per_sec"] = last.get("steps_per_sec")
        out["items_per_sec_per_chip"] = last.get("items_per_sec_per_chip")
        for k in ("model_tflops", "mfu_nominal", "dev_mem_bytes_in_use",
                  "dev_mem_peak_bytes", "rss_bytes"):
            if last.get(k) is not None:
                out[k] = last[k]
        window = [r for r in train[-max(recent, 2):]
                  if isinstance(r.get("time"), (int, float))
                  and isinstance(r.get("step"), int)]
        if len(window) >= 2:
            # median of per-gap slopes, not one end-to-end slope: an
            # eval sweep / checkpoint inside the window stretches ONE
            # gap's wall time (the cumulative steps_per_sec excludes
            # those pauses via StepTimer), and a single stretched gap
            # must not read as a run-wide slowdown
            gap_rates = []
            for a, b in zip(window, window[1:]):
                dt, dstep = b["time"] - a["time"], b["step"] - a["step"]
                if dt > 0 and dstep > 0:
                    gap_rates.append(dstep / dt)
            if gap_rates:
                rsps = statistics.median(gap_rates)
                out["recent_steps_per_sec"] = round(rsps, 4)
                overall = last.get("steps_per_sec")
                if isinstance(overall, (int, float)) and overall > 0:
                    # >1: speeding up; <1: the recent window is slower
                    # than the run's average
                    out["throughput_trend"] = round(rsps / overall, 3)
        phases = _phase_breakdown(last)
        if phases:
            out["phase_share"] = phases["share"]
        counters = _counter_summary(last)
        if counters:
            out.update({k: v for k, v in counters.items() if k != "data"})
        recipe = _recipe_counters(last)
        if recipe:
            out["recipe"] = recipe

    evals = [r for r in records if r.get("kind") == "eval"]
    if evals:
        out["last_eval"] = {k: evals[-1][k] for k in ("step", "aee", "aae",
                                                      "accuracy")
                            if k in evals[-1]}
    warns = [r for r in records if r.get("kind") == "warn"]
    if warns:
        out["warnings"] = len(warns)
        out["last_warning"] = str(warns[-1].get("message", ""))[:200]

    hb = load_heartbeat(log_dir)
    if hb is not None:
        entry = {"step": hb.get("step"), "wedged": hb.get("wedged"),
                 "wedges": hb.get("wedges"),
                 "last_step_age_s": hb.get("last_step_age_s")}
        t = hb.get("time")
        if isinstance(t, (int, float)):
            # fresh: age < ~2x the period => the writer thread is alive
            entry["age_s"] = round(now - t, 1)
            entry["period_s"] = hb.get("heartbeat_period_s")
        out["heartbeat"] = entry
        # heartbeat-carried resilience counters are fresher than the last
        # train record (they update every period, records every
        # log_every): merge per key with the heartbeat winning, so a
        # recovery burst between log points surfaces within one period
        res = {**out.get("resilience", {}), **_resilience_counters(hb)}
        if res:
            out["resilience"] = res
        # a serving process's heartbeat carries the live serve_* block
        # (queue depth, occupancy, p50/p99 latency, requests/s)
        serve = _serve_counters(hb)
        if serve:
            out["serve"] = serve
        # a fleet supervisor's heartbeat carries the live fleet_* block
        # (replica states, evictions/respawns/broken, failovers, shed) —
        # `tail` exits 4 when it shows evictions or a broken replica
        # (fleet_block, not fleet: the parameter must stay visible)
        fleet_block = _fleet_counters(hb)
        if fleet_block:
            out["fleet"] = fleet_block
        # the brownout/deadline planes (serve/degrade.py + the deadline
        # gates): the live level, shed/downgrade ledger, and where
        # expired budgets died — `tail` exits 10 on sustained L3
        degrade = _degrade_counters(hb)
        if degrade:
            out["degrade"] = degrade
        deadline = _deadline_counters(hb)
        if deadline:
            out["deadline"] = deadline
        # an elastic coordinator's heartbeat carries the live elastic_*
        # block (generation, re-forms, lost hosts, steps lost, per-host
        # states) — `tail` exits 5 when the run had to re-form
        elastic = _elastic_counters(hb)
        if elastic:
            out["elastic"] = elastic
        # a ledgered process's heartbeat carries the live exec_* block
        # (lowerings, recompiles, compile seconds, cache hit/miss,
        # fingerprints, roofline MFU — obs/ledger.py)
        execs = _exec_counters(hb)
        if execs:
            out["exec"] = execs
        # a recipe-driven trainer's heartbeat carries the live recipe_*
        # block (stage, advances, mixture draws) — fresher than the
        # newest train record, wins per block
        recipe = _recipe_counters(hb)
        if recipe:
            out["recipe"] = recipe

    serves = [r for r in records if r.get("kind") == "serve"]
    if serves:
        if "serve" not in out:
            serve = _serve_counters(serves[-1])
            if serve:
                out["serve"] = serve
        if "fleet" not in out:
            fleet_block = _fleet_counters(serves[-1])
            if fleet_block:
                out["fleet"] = fleet_block
        if "degrade" not in out:
            degrade = _degrade_counters(serves[-1])
            if degrade:
                out["degrade"] = degrade
        if "deadline" not in out:
            deadline = _deadline_counters(serves[-1])
            if deadline:
                out["deadline"] = deadline
        if "exec" not in out:
            execs = _exec_counters(serves[-1])
            if execs:
                out["exec"] = execs
    scales = [r for r in records if r.get("kind") == "fleet"]
    if scales:
        # autoscale pool-size timeline (one kind="fleet" record per
        # scale event) — the live fleet block above already carries the
        # fleet_autoscale_* counters; this names the newest move
        out["scale_events"] = _scale_event_summary(scales)
    if "elastic" not in out:
        elastics = [r for r in records if r.get("kind") == "elastic"]
        if elastics:
            elastic = _elastic_counters(elastics[-1])
            if elastic:
                out["elastic"] = elastic
    if fleet:
        agg = aggregate_processes(log_dir, now=now)
        if agg:
            out.update(agg)
    # executable-ledger surfaces (obs/ledger.py): the run's condensed
    # ledger.jsonl, and — when a baseline ledger exists (explicit path
    # or the committed <log_dir>/ledger_baseline.jsonl) — the drift
    # verdict the CLI maps to exit code 8
    from .obs.ledger import summarize_ledger

    rows = _ledger_rows(log_dir)
    if rows:
        ledger = summarize_ledger(rows)
        if ledger:
            out["ledger"] = ledger
    drift = ledger_drift(log_dir, ledger_baseline, fleet=fleet,
                         run_rows=rows, **(ledger_bounds or {}))
    if drift is not None:
        out["ledger_diff"] = drift
    # incident-plane surface (obs/incident.py): the committed bundle
    # summary the CLI maps to exit code 9 (unacked critical) — absent
    # entirely when the run recorded no incidents
    from .obs.incident import incident_summary

    inc = incident_summary(log_dir)
    if inc is not None:
        out["incidents"] = inc
    return out


def plot_curves(records: list[dict], out_dir: str) -> list[str]:
    """Write loss/AEE PNGs when matplotlib is available; returns paths."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # noqa: BLE001 - plotting is strictly optional
        return []

    written = []
    series = {
        "train_loss": [(r["step"], r["loss"]) for r in records
                       if r.get("kind") == "train" and "loss" in r],
        "eval_aee": [(r["step"], r["aee"]) for r in records
                     if r.get("kind") == "eval" and "aee" in r],
    }
    for name, pts in series.items():
        if len(pts) < 2:
            continue
        xs, ys = zip(*pts)
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.plot(xs, ys)
        ax.set_xlabel("step")
        ax.set_ylabel(name)
        ax.grid(True, alpha=0.3)
        path = os.path.join(out_dir, f"{name}.png")
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)
        written.append(path)
    return written


def analyze(log_dir: str, plot: bool = True) -> dict:
    records = load_records(log_dir)
    summary = summarize(records)
    # a supervised run dir (fleet replicas / elastic hosts) aggregates
    # its children too: one `analyze` summarizes the whole drill
    agg = aggregate_processes(log_dir)
    if agg:
        summary.update(agg)
    from .obs.ledger import summarize_ledger

    rows = _ledger_rows(log_dir)
    if rows:
        ledger = summarize_ledger(rows)
        if ledger:
            summary["ledger"] = ledger
    drift = ledger_drift(log_dir, fleet=True, run_rows=rows)
    if drift is not None:
        summary["ledger_diff"] = drift
    from .obs.incident import incident_summary

    inc = incident_summary(log_dir)
    if inc is not None:
        summary["incidents"] = inc
    if plot:
        summary["plots"] = plot_curves(records, log_dir)
    return summary
