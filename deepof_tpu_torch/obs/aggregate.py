"""Cross-process trace aggregation: one fleet timeline from a run dir
(a copy of `deepof_tpu/obs/aggregate.py`; stdlib-only).

A fleet drill (`serve --replicas N`), or any supervised run, leaves a
TREE of per-process observability artifacts under its log dir:

    <run>/trace.json  heartbeat.json  metrics.jsonl          (supervisor)
    <run>/replica-0/trace.json  heartbeat.json  metrics.jsonl
    <run>/replica-1/...

Each artifact is single-process by construction. This module merges the
whole tree into ONE Perfetto/chrome://tracing-loadable trace:

  Process tracks — every process dir becomes its own pid track, named
      from the tracer's (role, index) stamp (obs/trace.py otherData)
      with the original pid and relative path preserved; tids stay
      process-local (pids are remapped to small distinct values, so a
      recycled OS pid in two dirs cannot collide).

  One clock — each tracer's timestamps are relative to its OWN
      monotonic construction epoch; the stamp records that epoch's wall
      time (`trace_epoch_unix`), so every event rebases onto a shared
      zero (the earliest epoch in the tree). Wall-clock skew between
      processes ON ONE HOST is bounded by the time.time() resolution —
      good enough to see a router span enclose its replica's spans.

  Flow arrows — spans carrying a `request_id` (or a batched
      `request_ids` list) in their args are chained per request id with
      Chrome flow events (ph s/t/f, id = the request id): the router's
      `route` span connects to the replica's `serve_enqueue ->
      serve_batch -> serve_dispatch -> serve_postprocess`, so one
      request's journey across processes renders as one arrowed path —
      failover replays show as a fan-out from the same id.

  Context events — each process's heartbeat.json becomes an instant
      event (final counters at its wall time), and its metrics.jsonl
      non-train records (warn / serve / elastic / eval / info) become
      instant markers, so "replica-1 evicted" sits ON the timeline next
      to the spans it explains.

Stdlib-only: aggregation runs next to a live fleet without touching the
card (`analyze` and `tail --fleet` import it through `analyze.py`).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict

#: metrics.jsonl kinds rendered as instant markers (train records are
#: periodic bulk data, not timeline landmarks).
_MARKER_KINDS = ("warn", "serve", "elastic", "eval", "info")
#: cap on instant markers per process (a long run's metrics.jsonl must
#: not dwarf the span timeline; the newest markers win)
_MAX_MARKERS = 512

_ARTIFACTS = ("trace.json", "heartbeat.json", "metrics.jsonl")


def discover_processes(run_dir: str) -> list[dict]:
    """Process dirs of a supervised run: the run dir itself (the
    supervisor) plus its IMMEDIATE subdirectories holding at least one
    observability artifact. Returns [{"dir", "rel", "role", "index"}]
    supervisor-first, then by name. Depth is deliberately bounded at 1:
    supervised children (fleet replicas, elastic trainer hosts) are
    only ever direct subdirs, and an unbounded walk would enumerate a
    co-located checkpoint tree on every `tail --follow` tick — and
    adopt any unrelated nested dir that happens to hold a metrics file
    as a phantom "child". Role/index prefer the tracer's own stamp
    (read later, from trace.json); this infers a fallback from the
    directory naming conventions (replica-N = fleet replica, host-N =
    elastic trainer, the root = the supervisor/router/coordinator)."""
    run_dir = os.path.abspath(run_dir)

    def has_artifact(d: str) -> bool:
        return any(os.path.isfile(os.path.join(d, a)) for a in _ARTIFACTS)

    out = []
    if has_artifact(run_dir):
        out.append({"dir": run_dir, "rel": "", "role": "supervisor",
                    "index": None})
    try:
        children = sorted(e.name for e in os.scandir(run_dir)
                          if e.is_dir(follow_symlinks=False))
    except OSError:
        children = []
    for base in children:
        d = os.path.join(run_dir, base)
        if not has_artifact(d):
            continue
        role, index = "process", None
        if base.startswith("replica-"):
            role, index = "replica", _int_suffix(base)
        elif base.startswith("host-"):
            role, index = "trainer", _int_suffix(base)
        out.append({"dir": d, "rel": base, "role": role, "index": index})
    return out


def _int_suffix(name: str):
    try:
        return int(name.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return None


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _load_jsonl(path: str) -> list[dict]:
    records = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue  # torn tail from a killed process
    except OSError:
        pass
    return records


def _request_ids(args: dict | None) -> list:
    """Every request id a span's args name (single or batched)."""
    if not args:
        return []
    out = []
    rid = args.get("request_id")
    if rid is not None:
        out.append(rid)
    rids = args.get("request_ids")
    if isinstance(rids, (list, tuple)):
        out.extend(r for r in rids if r is not None)
    return out


def aggregate_run(run_dir: str, out_path: str | None = None) -> dict:
    """Merge every process's trace/heartbeat/metrics under `run_dir`
    into one Chrome trace (written to `out_path`, default
    `<run_dir>/trace_merged.json`) and return the summary dict:

        {"path", "processes": [{"name", "rel", "pid", "orig_pid",
          "spans", "markers"}], "spans", "flows",
         "request_ids", "requests_correlated"}

    `requests_correlated` counts request ids whose spans appear in >= 2
    distinct processes — the cross-process correlation the plane exists
    for."""
    procs = discover_processes(run_dir)
    if not procs:
        raise FileNotFoundError(
            f"no trace.json/heartbeat.json/metrics.jsonl anywhere under "
            f"{run_dir!r} — is this a run's --log-dir?")

    # pass 1: load + establish the shared clock zero
    epochs = []
    for p in procs:
        p["trace"] = _load_json(os.path.join(p["dir"], "trace.json"))
        p["heartbeat"] = _load_json(os.path.join(p["dir"],
                                                 "heartbeat.json"))
        p["records"] = _load_jsonl(os.path.join(p["dir"], "metrics.jsonl"))
        other = (p["trace"] or {}).get("otherData", {})
        if other.get("role"):
            p["role"] = other["role"]
            if other.get("index") is not None:
                p["index"] = other["index"]
        p["orig_pid"] = other.get("pid")
        epoch = other.get("trace_epoch_unix")
        p["epoch"] = epoch if isinstance(epoch, (int, float)) else None
        if p["epoch"] is not None:
            epochs.append(p["epoch"])
        for r in p["records"]:
            t = r.get("time")
            if isinstance(t, (int, float)):
                epochs.append(t)
    zero = min(epochs) if epochs else 0.0

    merged: list[dict] = []
    spans_by_rid: dict = defaultdict(list)
    summary: dict = {"path": None, "processes": [], "spans": 0,
                     "flows": 0, "request_ids": 0,
                     "requests_correlated": 0}

    for i, p in enumerate(procs):
        pid = i + 1  # small distinct pids: OS pid reuse across dirs is
        #              irrelevant, and Perfetto sorts tracks stably
        name = (p["role"] if p["index"] is None
                else f"{p['role']}-{p['index']}")
        label = name
        if p["orig_pid"] is not None:
            label += f" (pid {p['orig_pid']})"
        if p["rel"]:
            label += f" [{p['rel']}]"
        merged.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": label}})
        merged.append({"ph": "M", "name": "process_sort_index",
                       "pid": pid, "tid": 0, "args": {"sort_index": i}})
        # rebase: event ts are relative to the tracer's own epoch
        offset_us = ((p["epoch"] - zero) * 1e6
                     if p["epoch"] is not None else 0.0)
        n_spans = 0
        for ev in (p["trace"] or {}).get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    continue  # replaced by the labeled track above
                merged.append(ev)
                continue
            if isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(ev["ts"] + offset_us, 1)
            merged.append(ev)
            if ev.get("ph") == "X":
                n_spans += 1
                for rid in _request_ids(ev.get("args")):
                    # only STRING ids correlate across processes: the
                    # router's X-Request-Id embeds its pid + a sequence,
                    # so it is fleet-unique by construction. Integer ids
                    # are each engine's process-LOCAL itertools counter —
                    # two replicas both have a request 1 — so they are
                    # namespaced per process (intra-process chains only,
                    # never a false cross-process arrow).
                    key = rid if isinstance(rid, str) else f"p{pid}#{rid}"
                    spans_by_rid[key].append(ev)
        # heartbeat: one instant with the final counters at its wall time
        n_markers = 0
        hb = p["heartbeat"]
        if hb is not None and isinstance(hb.get("time"), (int, float)):
            merged.append({"ph": "i", "name": "heartbeat", "cat": "obs",
                           "pid": pid, "tid": 0, "s": "p",
                           "ts": round((hb["time"] - zero) * 1e6, 1),
                           "args": hb})
            n_markers += 1
        # metrics.jsonl landmarks (newest first under the cap)
        markers = [r for r in p["records"]
                   if r.get("kind") in _MARKER_KINDS
                   and isinstance(r.get("time"), (int, float))]
        for r in markers[-_MAX_MARKERS:]:
            args = {k: v for k, v in r.items() if k != "time"}
            msg = args.get("message")
            if isinstance(msg, str) and len(msg) > 300:
                args["message"] = msg[:300] + "..."
            merged.append({"ph": "i", "name": f"metrics_{r['kind']}",
                           "cat": "obs", "pid": pid, "tid": 0, "s": "p",
                           "ts": round((r["time"] - zero) * 1e6, 1),
                           "args": args})
            n_markers += 1
        summary["processes"].append({
            "name": name, "rel": p["rel"], "pid": pid,
            "orig_pid": p["orig_pid"], "spans": n_spans,
            "markers": n_markers})
        summary["spans"] += n_spans

    # flow arrows: chain each request id's spans in time order
    n_flows = 0
    n_corr = 0
    for rid, evs in sorted(spans_by_rid.items()):
        if len(evs) < 2:
            continue
        evs.sort(key=lambda e: e.get("ts", 0.0))
        if len({e["pid"] for e in evs}) >= 2:
            n_corr += 1
        last = len(evs) - 1
        for j, ev in enumerate(evs):
            ph = "s" if j == 0 else ("f" if j == last else "t")
            flow = {"ph": ph, "cat": "request", "name": "request",
                    "id": rid, "pid": ev["pid"], "tid": ev["tid"],
                    "ts": ev["ts"]}
            if ph == "f":
                flow["bp"] = "e"  # bind to the enclosing slice
            merged.append(flow)
            n_flows += 1
    summary["flows"] = n_flows
    summary["request_ids"] = len(spans_by_rid)
    summary["requests_correlated"] = n_corr

    out_path = out_path or os.path.join(os.path.abspath(run_dir),
                                        "trace_merged.json")
    payload = {"traceEvents": merged, "displayTimeUnit": "ms",
               "otherData": {"merged_from": [p["rel"] or "." for p in
                                             procs],
                             "clock_zero_unix": zero}}
    d = os.path.dirname(os.path.abspath(out_path))
    os.makedirs(d, exist_ok=True)
    tmp = os.path.join(d, f".{os.path.basename(out_path)}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, out_path)
    summary["path"] = out_path
    return summary


# ------------------------------------------------------- headless views


def per_process_table(merged_path: str) -> dict[str, dict[str, dict]]:
    """{process -> {span name -> {"count", "total_ms", "max_ms"}}} from
    a merged trace: each process's span totals."""
    payload = _load_json(merged_path) or {}
    events = payload.get("traceEvents", [])
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    table: dict[str, dict[str, dict]] = defaultdict(dict)
    for e in events:
        if e.get("ph") != "X" or not isinstance(e.get("dur"),
                                                (int, float)):
            continue
        proc = names.get(e.get("pid"), str(e.get("pid")))
        row = table[proc].setdefault(e.get("name", "?"),
                                     {"count": 0, "total_ms": 0.0,
                                      "max_ms": 0.0})
        ms = float(e["dur"]) / 1e3
        row["count"] += 1
        row["total_ms"] += ms
        row["max_ms"] = max(row["max_ms"], ms)
    for proc in table.values():
        for row in proc.values():
            row["total_ms"] = round(row["total_ms"], 3)
            row["max_ms"] = round(row["max_ms"], 3)
    return dict(table)


def per_request_table(merged_path: str, limit: int = 20) -> list[dict]:
    """Per-request-id journeys from a merged trace, slowest first:
    [{"request_id", "processes", "spans": [{"process", "name",
    "dur_ms"}], "total_ms"}]."""
    payload = _load_json(merged_path) or {}
    events = payload.get("traceEvents", [])
    names = {e["pid"]: e["args"]["name"] for e in events
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    by_rid: dict = defaultdict(list)
    for e in events:
        if e.get("ph") != "X":
            continue
        for rid in _request_ids(e.get("args")):
            # same namespacing rule as aggregate_run: integer ids are
            # process-local counters, never cross-process identities
            key = rid if isinstance(rid, str) else f"p{e.get('pid')}#{rid}"
            by_rid[key].append(e)
    rows = []
    for rid, evs in by_rid.items():
        evs.sort(key=lambda e: e.get("ts", 0.0))
        spans = [{"process": names.get(e.get("pid"), str(e.get("pid"))),
                  "name": e.get("name", "?"),
                  "dur_ms": round(float(e.get("dur", 0.0)) / 1e3, 3)}
                 for e in evs]
        rows.append({"request_id": rid,
                     "processes": len({e["pid"] for e in evs}),
                     "spans": spans,
                     "total_ms": round(sum(s["dur_ms"] for s in spans),
                                       3)})
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:max(int(limit), 1)]
