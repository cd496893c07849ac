"""Incident plane: an anomaly-triggered flight recorder (port of
`deepof_tpu/obs/incident.py`; stdlib only).

When a verdict fires (a wedge, a fleet eviction or crash, an exhausted
SLO or quality budget, brownout L3, a NaN rollback), the evidence is
snapshotted into `<log_dir>/incidents/<ts>-<kind>-<pid>-<seq>/`:

    manifest.json       schema, kind, severity, role, the trigger's
                        payload, a counter snapshot, config and registry
                        digests, the file inventory; written last
    stacks.txt          every live thread's stack at capture time
    heartbeats.jsonl    the last observed heartbeat samples
    heartbeat.json      the live heartbeat file, verbatim
    metrics_tail.jsonl  the newest lines of metrics.jsonl
    ledger_tail.jsonl   the newest executable-ledger rows of the run's
                        ledger.jsonl (`obs/ledger.py`), if it has any
    trace.json          the flushed span ring, if a tracer is installed

Capture is rare, bounded and harmless to the process it diagnoses:

  - atomic-rename commit: a bundle is staged under a `.tmp-` name and
    renamed into place after manifest.json lands, so a reader never
    takes a torn bundle for a committed one; `incidents gc` removes
    orphaned staging dirs;
  - per-kind dedup: a kind (or dedup key) that captured within
    `obs.incident_dedup_window_s` is counted (`incident_deduped`), not
    captured again;
  - a token bucket: `obs.incident_burst` tokens refilled at
    `obs.incident_rate_per_min` bound a storm of distinct kinds
    (`incident_rate_limited`);
  - a keep bound: the newest `obs.incident_keep` bundles are kept, older
    ones pruned at capture;
  - never raises: a failed capture counts `incident_capture_errors`.

Declarative alert rules (`obs.alerts`) evaluate on the heartbeat's
cadence over keys declared in `obs/registry.py`:

    "[name:] [rate(]counter[)] OP value [warn|critical]"

e.g. ``"err_burst: rate(serve_errors) > 5 critical"``; a firing rule
records an incident of kind ``alert_<name>``.

`obs.incidents=false` (the default) is a structural no-op: `install`
returns None, no `incident_*` key enters any stats block, and every
trigger site guards on `is not None`. The `incidents` verb of the
command line lists, shows, acknowledges and collects the bundles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from collections import deque

SCHEMA_VERSION = 1
INCIDENTS_DIRNAME = "incidents"
STAGING_PREFIX = ".tmp-"
MANIFEST_NAME = "manifest.json"
ACK_FILENAME = "ACK"
SEVERITIES = ("warn", "critical")

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_ALERT_RE = re.compile(
    r"^\s*(?:(?P<name>[A-Za-z0-9_.-]+)\s*:)?\s*"
    r"(?:(?P<rate>rate)\s*\(\s*(?P<rcounter>[A-Za-z0-9_]+)\s*\)"
    r"|(?P<counter>[A-Za-z0-9_]+))\s*"
    r"(?P<op>>=|<=|>|<)\s*"
    r"(?P<value>-?[0-9]+(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?)"
    r"(?:\s+(?P<sev>warn|critical))?\s*$")


class AlertRule:
    """One parsed `obs.alerts` rule (see module docstring grammar)."""

    __slots__ = ("spec", "name", "counter", "rate", "op", "threshold",
                 "severity")

    def __init__(self, spec: str, name: str, counter: str, rate: bool,
                 op: str, threshold: float, severity: str):
        self.spec = spec
        self.name = name
        self.counter = counter
        self.rate = rate
        self.op = op
        self.threshold = threshold
        self.severity = severity

    def evaluate(self, sample: dict, prev, now_m: float):
        """(fired, observed value) against one heartbeat sample. `prev`
        is (monotonic time, sample) of the previous observation —
        rate() rules need it and never fire on the first sample."""
        cur = sample.get(self.counter)
        if not isinstance(cur, (int, float)) or isinstance(cur, bool):
            return False, None
        if self.rate:
            if prev is None:
                return False, None
            pt, psample = prev
            pv = psample.get(self.counter)
            dt = now_m - pt
            if (not isinstance(pv, (int, float)) or isinstance(pv, bool)
                    or dt <= 0):
                return False, None
            value = (float(cur) - float(pv)) / dt
        else:
            value = float(cur)
        return _OPS[self.op](value, self.threshold), round(value, 6)


def parse_alert_rules(specs) -> list[AlertRule]:
    """Parse + validate `obs.alerts` rule strings. Loud ValueError on a
    malformed rule or a counter the registry does not declare — a typo'd
    alert that silently never fires is worse than no alert."""
    from .registry import lookup

    rules: list[AlertRule] = []
    seen: set[str] = set()
    for spec in specs or ():
        m = _ALERT_RE.match(str(spec))
        if m is None:
            raise ValueError(
                f"bad obs.alerts rule {spec!r}: expected "
                f"'[name:] [rate(]counter[)] OP value [warn|critical]' "
                f"with OP one of > >= < <=")
        counter = m.group("counter") or m.group("rcounter")
        if lookup(counter) is None:
            raise ValueError(
                f"obs.alerts rule {spec!r}: counter {counter!r} is not "
                f"declared in obs/registry.py — alert rules may only "
                f"watch registered keys")
        name = m.group("name") or counter
        if name in seen:
            raise ValueError(f"obs.alerts: duplicate rule name {name!r}")
        seen.add(name)
        rules.append(AlertRule(
            spec=str(spec), name=name, counter=counter,
            rate=bool(m.group("rate")), op=m.group("op"),
            threshold=float(m.group("value")),
            severity=m.group("sev") or "warn"))
    return rules


# -------------------------------------------------------------- helpers


def _tail_lines(path: str, n: int, max_bytes: int = 1 << 18) -> str | None:
    """The newest n lines of a (possibly large) text file, reading at
    most max_bytes from the end — the bundle stays bounded no matter
    how long the run's metrics log has grown."""
    if n <= 0:
        return None
    try:
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            f.seek(max(0, size - max_bytes))
            data = f.read(max_bytes)
    except OSError:
        return None
    lines = data.decode("utf-8", errors="replace").splitlines()
    if size > max_bytes and lines:
        lines = lines[1:]  # the first line may be torn by the seek
    tail = lines[-n:]
    if not tail:
        return None
    return "\n".join(tail) + "\n"


def config_digest(cfg) -> str | None:
    """Stable short digest of a (dataclass) config tree — the manifest
    records which config the incident happened under without embedding
    the whole tree in every bundle."""
    try:
        blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True,
                          default=str)
    except Exception:  # noqa: BLE001 - digesting is best-effort
        return None
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def registry_digest() -> str:
    """Short digest of the observability schema (registered key names):
    two bundles with the same digest were captured under the same
    counter vocabulary."""
    from .registry import REGISTRY

    return hashlib.sha256(
        ",".join(sorted(REGISTRY)).encode()).hexdigest()[:16]


def _safe_kind(kind: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "-", str(kind))[:64] or "incident"


# Bundle names are <ts>-<kind>-<pid>-<seq>: the sequence must be unique
# per PROCESS, not per recorder — two recorder instances capturing the
# same kind within the same second (record_offline constructs one per
# call) would otherwise collide on the final rename.
_seq_lock = threading.Lock()
_seq_counter = 0


def _next_seq() -> int:
    global _seq_counter
    with _seq_lock:
        _seq_counter += 1
        return _seq_counter


# ------------------------------------------------------------- recorder


class IncidentRecorder:
    """See module docstring. One per process; spawns no threads —
    capture runs on whichever thread hit the trigger (rare + bounded
    by construction)."""

    def __init__(self, log_dir: str, role: str, *,
                 rate_per_min: float = 6.0, burst: int = 3,
                 dedup_window_s: float = 300.0, metrics_tail: int = 200,
                 heartbeats: int = 8, keep: int = 32, alerts=(),
                 config_digest: str | None = None):
        self.log_dir = log_dir
        self.role = role
        self._rate = max(float(rate_per_min), 0.0) / 60.0
        self._burst = max(int(burst), 1)
        self._tokens = float(self._burst)
        self._refilled = time.monotonic()
        self._dedup_s = max(float(dedup_window_s), 0.0)
        self._tail = max(int(metrics_tail), 0)
        self._keep = max(int(keep), 1)
        self._config_digest = config_digest
        self._rules = parse_alert_rules(alerts)
        self._hb_ring: deque = deque(maxlen=max(int(heartbeats), 1))
        self._prev_sample: tuple[float, dict] | None = None
        self._lock = threading.Lock()
        self._seq = 0
        self._last_capture: dict[str, float] = {}
        self._captured = 0
        self._deduped = 0
        self._rate_limited = 0
        self._errors = 0
        self._collected = 0
        self._by_kind: dict[str, int] = {}
        self._last_kind: str | None = None
        self._alert_firings = 0
        self._alert_errors = 0

    # ------------------------------------------------------------ record
    def record(self, kind: str, severity: str = "warn",
               trigger: dict | None = None,
               text_files: dict[str, str] | None = None,
               dedup_key: str | None = None) -> str | None:
        """Capture one incident bundle; returns its committed path, or
        None when deduped / rate-limited / capture failed. Never raises
        — the trigger site must not die of its own flight recorder."""
        try:
            return self._record(kind, severity, trigger, text_files,
                                dedup_key)
        except Exception:  # noqa: BLE001 - capture must never propagate
            with self._lock:
                self._errors += 1
            return None

    def _record(self, kind, severity, trigger, text_files, dedup_key):
        key = dedup_key or str(kind)
        now = time.monotonic()
        with self._lock:
            last = self._last_capture.get(key)
            if (last is not None and self._dedup_s > 0
                    and now - last < self._dedup_s):
                self._deduped += 1
                return None
            # token bucket, refilled lazily: a storm of distinct kinds
            # is bounded even when each passes its own dedup window
            self._tokens = min(
                float(self._burst),
                self._tokens + (now - self._refilled) * self._rate)
            self._refilled = now
            if self._tokens < 1.0:
                self._rate_limited += 1
                return None
            self._tokens -= 1.0
            self._last_capture[key] = now
            seq = _next_seq()
            self._seq = seq
            hb_ring = [dict(h) for h in self._hb_ring]
            counters = self._stats_locked()
        path = self._capture(kind, severity, dict(trigger or {}),
                             dict(text_files or {}), key, seq, counters,
                             hb_ring)
        with self._lock:
            self._captured += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            self._last_kind = str(kind)
        return path

    def _capture(self, kind, severity, trigger, text_files, key, seq,
                 counters, hb_ring) -> str:
        inc_root = os.path.join(self.log_dir, INCIDENTS_DIRNAME)
        os.makedirs(inc_root, exist_ok=True)
        ts = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
        name = f"{ts}-{_safe_kind(kind)}-{os.getpid()}-{seq}"
        staging = os.path.join(inc_root,
                               f"{STAGING_PREFIX}{os.getpid()}-{seq}")
        os.makedirs(staging)
        files: dict[str, int] = {}

        def put(fname: str, text: str) -> None:
            p = os.path.join(staging, fname)
            with open(p, "w") as f:
                f.write(text)
            files[fname] = os.path.getsize(p)

        if "stacks.txt" not in text_files:
            from .heartbeat import dump_all_stacks

            text_files["stacks.txt"] = dump_all_stacks()
        for fname, text in text_files.items():
            put(fname, str(text))
        if hb_ring:
            put("heartbeats.jsonl",
                "\n".join(json.dumps(h, default=str) for h in hb_ring)
                + "\n")
        hb_path = os.path.join(self.log_dir, "heartbeat.json")
        if os.path.isfile(hb_path):
            try:
                shutil.copyfile(hb_path,
                                os.path.join(staging, "heartbeat.json"))
                files["heartbeat.json"] = os.path.getsize(
                    os.path.join(staging, "heartbeat.json"))
            except OSError:
                pass
        for src, dst in (("metrics.jsonl", "metrics_tail.jsonl"),
                         ("ledger.jsonl", "ledger_tail.jsonl")):
            tail = _tail_lines(os.path.join(self.log_dir, src),
                               self._tail)
            if tail:
                put(dst, tail)
        try:  # flushed span ring: the timeline leading into the anomaly
            from . import trace as obs_trace

            tr = os.path.join(staging, "trace.json")
            obs_trace.flush_current(tr)
            if os.path.isfile(tr):
                files["trace.json"] = os.path.getsize(tr)
        except Exception:  # noqa: BLE001 - trace capture is best-effort
            pass
        t = time.time()
        manifest = {
            "schema": SCHEMA_VERSION,
            "id": name,
            "kind": str(kind),
            "severity": severity if severity in SEVERITIES else "warn",
            "role": self.role,
            "pid": os.getpid(),
            "seq": seq,
            "time": t,
            "iso_time": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                      time.gmtime(t)),
            "trigger": trigger,
            "counters": counters,
            "dedup_key": key,
            "config_digest": self._config_digest,
            "registry_digest": registry_digest(),
            "files": files,
            "origin": None,
        }
        # manifest LAST, then the atomic rename: a bundle without a
        # manifest is torn by definition; a renamed bundle is complete
        with open(os.path.join(staging, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2, default=str)
        final = os.path.join(inc_root, name)
        os.rename(staging, final)
        self._prune(inc_root)
        return final

    def _prune(self, inc_root: str) -> None:
        """Bounded disk: beyond `keep` committed bundles, the oldest
        are removed (dedup + the token bucket bound the rate; this
        bounds the total)."""
        try:
            names = sorted(n for n in os.listdir(inc_root)
                           if not n.startswith(STAGING_PREFIX))
        except OSError:
            return
        for name in names[:max(0, len(names) - self._keep)]:
            shutil.rmtree(os.path.join(inc_root, name),
                          ignore_errors=True)

    # ----------------------------------------------------- alert engine
    def observe(self, sample: dict) -> None:
        """Feed one heartbeat sample: ring-buffer it (the bundle's
        `heartbeats.jsonl`) and evaluate the alert rules against it.
        Called on the heartbeat cadence; never raises."""
        try:
            now_m = time.monotonic()
            rec = dict(sample or {})
            rec.setdefault("time", time.time())
            with self._lock:
                prev = self._prev_sample
                self._hb_ring.append(rec)
                self._prev_sample = (now_m, rec)
            for rule in self._rules:
                try:
                    fired, value = rule.evaluate(rec, prev, now_m)
                except Exception:  # noqa: BLE001 - one bad rule != all
                    with self._lock:
                        self._alert_errors += 1
                    continue
                if not fired:
                    continue
                with self._lock:
                    self._alert_firings += 1
                self.record(
                    f"alert_{rule.name}", rule.severity,
                    trigger={"rule": rule.spec, "counter": rule.counter,
                             "op": rule.op, "threshold": rule.threshold,
                             "value": value, "rate": rule.rate})
        except Exception:  # noqa: BLE001
            with self._lock:
                self._errors += 1

    def wrap_sample(self, fn):
        """Wrap a heartbeat `sample` callback: observe each sample for
        the ring + alert rules, and merge the incident_*/alert_*
        counter block into it (registry -> heartbeat -> /metrics)."""
        def wrapped() -> dict:
            out = dict(fn() or {})
            self.observe(out)
            out.update(self.stats())
            return out
        return wrapped

    # ------------------------------------------------------------- stats
    def note_collected(self, n: int) -> None:
        """Supervisor-side sweep accounting (collect_from_children)."""
        if n:
            with self._lock:
                self._collected += int(n)

    def stats(self) -> dict:
        with self._lock:
            return self._stats_locked()

    def _stats_locked(self) -> dict:
        out = {
            "incident_captured": self._captured,
            "incident_deduped": self._deduped,
            "incident_rate_limited": self._rate_limited,
            "incident_capture_errors": self._errors,
            "incident_collected": self._collected,
            "incident_by_kind": dict(self._by_kind),
            "alert_rules": len(self._rules),
            "alert_firings": self._alert_firings,
            "alert_errors": self._alert_errors,
        }
        if self._last_kind is not None:
            out["incident_last_kind"] = self._last_kind
        return out


def install(cfg, log_dir: str | None, role: str) -> IncidentRecorder | None:
    """The one construction path every process kind uses. None when
    `obs.incidents` is off or there is no log dir — the structural
    no-op: callers guard every trigger on `is not None`."""
    obs = cfg.obs
    if not getattr(obs, "incidents", False) or not log_dir:
        return None
    return IncidentRecorder(
        log_dir, role,
        rate_per_min=obs.incident_rate_per_min,
        burst=obs.incident_burst,
        dedup_window_s=obs.incident_dedup_window_s,
        metrics_tail=obs.incident_metrics_tail,
        heartbeats=obs.incident_heartbeats,
        keep=obs.incident_keep,
        alerts=obs.alerts,
        config_digest=config_digest(cfg))


# ------------------------------------------- offline one-shot recording


def record_offline(log_dir: str, kind: str, severity: str,
                   trigger: dict | None = None,
                   dedup_key: str | None = None,
                   role: str = "offline") -> str | None:
    """One-shot bundle writer for verdicts computed outside the live
    process (`tail`'s rc-8 ledger-drift gate). Dedup is
    structural: a committed bundle with the same kind and dedup key
    suppresses the capture, so a polling caller writes one bundle per
    distinct verdict. Best-effort and silent: a read-only run dir does
    not break the caller."""
    key = dedup_key or str(kind)
    try:
        for man in list_incidents(log_dir):
            if man.get("kind") == kind and man.get("dedup_key") == key:
                return None
        rec = IncidentRecorder(log_dir, role, dedup_window_s=0.0)
        return rec._record(kind, severity, trigger, None, key)
    except Exception:  # noqa: BLE001
        return None


# ----------------------------------------------------------------- triage


def incidents_dir(log_dir: str) -> str:
    return os.path.join(log_dir, INCIDENTS_DIRNAME)


def list_incidents(log_dir: str) -> list[dict]:
    """Every COMMITTED bundle's manifest under <log_dir>/incidents/,
    oldest first, each annotated with `id` and the live `acked` state
    (an ACK file in the bundle dir). Staging dirs and manifest-less
    dirs are torn, not incidents."""
    root = incidents_dir(log_dir)
    out: list[dict] = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        if name.startswith(STAGING_PREFIX):
            continue
        d = os.path.join(root, name)
        try:
            with open(os.path.join(d, MANIFEST_NAME)) as f:
                man = json.load(f)
        except (OSError, ValueError):
            continue
        man["id"] = name
        man["acked"] = os.path.exists(os.path.join(d, ACK_FILENAME))
        out.append(man)
    out.sort(key=lambda m: (m.get("time") or 0, m["id"]))
    return out


def _staging_dirs(log_dir: str) -> list[str]:
    root = incidents_dir(log_dir)
    try:
        return sorted(os.path.join(root, n) for n in os.listdir(root)
                      if n.startswith(STAGING_PREFIX))
    except OSError:
        return []


def incident_summary(log_dir: str) -> dict | None:
    """The condensed `incidents` block (the JAX package's analyze/tail
    embed it); None when the run recorded none. `unacked_critical` is
    the figure the JAX `tail` maps to exit code 9."""
    mans = list_incidents(log_dir)
    torn = len(_staging_dirs(log_dir))
    if not mans and not torn:
        return None
    by_kind: dict[str, int] = {}
    critical = unacked = 0
    for m in mans:
        by_kind[m.get("kind", "?")] = by_kind.get(m.get("kind", "?"), 0) + 1
        if m.get("severity") == "critical":
            critical += 1
            if not m.get("acked"):
                unacked += 1
    out = {"total": len(mans), "critical": critical,
           "unacked_critical": unacked, "torn": torn,
           "by_kind": by_kind}
    if mans:
        last = mans[-1]
        out["last"] = {k: last.get(k) for k in
                       ("id", "kind", "severity", "time", "acked",
                        "origin")}
    return out


def show_incident(log_dir: str, incident_id: str) -> dict:
    """One bundle's manifest + on-disk file inventory. Raises
    FileNotFoundError for an unknown or torn id."""
    d = os.path.join(incidents_dir(log_dir), incident_id)
    mpath = os.path.join(d, MANIFEST_NAME)
    if (incident_id.startswith(STAGING_PREFIX)
            or not os.path.isfile(mpath)):
        raise FileNotFoundError(
            f"no committed incident {incident_id!r} under {log_dir!r}")
    with open(mpath) as f:
        man = json.load(f)
    man["id"] = incident_id
    man["acked"] = os.path.exists(os.path.join(d, ACK_FILENAME))
    man["dir"] = d
    man["files_on_disk"] = {
        n: os.path.getsize(os.path.join(d, n))
        for n in sorted(os.listdir(d)) if n != MANIFEST_NAME}
    return man


def ack_incidents(log_dir: str, incident_id: str | None = None) -> list[str]:
    """Acknowledge one bundle (or all, id=None) by dropping an ACK
    file, the reviewed-by-an-operator marker (`incidents list` then
    returns 0). Returns the ids newly acknowledged."""
    if incident_id is not None:
        targets = [show_incident(log_dir, incident_id)]
    else:
        targets = list_incidents(log_dir)
    acked = []
    for man in targets:
        if man.get("acked"):
            continue
        p = os.path.join(incidents_dir(log_dir), man["id"], ACK_FILENAME)
        with open(p, "w") as f:
            f.write(time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
                    + "\n")
        acked.append(man["id"])
    return acked


def gc_incidents(log_dir: str, older_than_days: float | None = None,
                 acked: bool = False, keep: int | None = None) -> dict:
    """Remove torn staging dirs (always), plus — opt-in — acknowledged
    bundles, bundles older than `older_than_days`, and everything
    beyond the newest `keep`."""
    removed: list[str] = []
    staging_removed = 0
    for d in _staging_dirs(log_dir):
        shutil.rmtree(d, ignore_errors=True)
        staging_removed += 1
    mans = list_incidents(log_dir)
    now = time.time()
    survivors = []
    for m in mans:
        drop = False
        if acked and m.get("acked"):
            drop = True
        if (older_than_days is not None
                and isinstance(m.get("time"), (int, float))
                and now - m["time"] > float(older_than_days) * 86400.0):
            drop = True
        if drop:
            shutil.rmtree(os.path.join(incidents_dir(log_dir), m["id"]),
                          ignore_errors=True)
            removed.append(m["id"])
        else:
            survivors.append(m)
    if keep is not None and len(survivors) > max(int(keep), 0):
        for m in survivors[:len(survivors) - max(int(keep), 0)]:
            shutil.rmtree(os.path.join(incidents_dir(log_dir), m["id"]),
                          ignore_errors=True)
            removed.append(m["id"])
    return {"dir": incidents_dir(log_dir), "removed": removed,
            "staging_removed": staging_removed,
            "kept": len(list_incidents(log_dir))}


# -------------------------------------------- supervisor-side collection


def collect_from_children(run_dir: str) -> int:
    """Sweep committed incident bundles out of depth-1 child process
    dirs (the fleet's `replica-N/`) into the run root's incidents/,
    renamed `<child>--<id>` and annotated with their origin: one
    `incidents list` at the run root sees the whole drill, bundles a
    SIGKILLed replica left behind included.
    Move (atomic same-fs rename), not copy: a bundle is counted once.
    Returns the number collected; best-effort (a vanishing child dir is
    a race, not an error)."""
    moved = 0
    try:
        names = sorted(os.listdir(run_dir))
    except OSError:
        return 0
    dest_root = os.path.join(run_dir, INCIDENTS_DIRNAME)
    for name in names:
        if name == INCIDENTS_DIRNAME:
            continue
        src_root = os.path.join(run_dir, name, INCIDENTS_DIRNAME)
        if not os.path.isdir(src_root):
            continue
        try:
            bids = sorted(os.listdir(src_root))
        except OSError:
            continue
        for bid in bids:
            if bid.startswith(STAGING_PREFIX):
                continue  # torn or mid-capture: never collect those
            src = os.path.join(src_root, bid)
            if not os.path.isfile(os.path.join(src, MANIFEST_NAME)):
                continue
            dst = os.path.join(dest_root, f"{name}--{bid}")
            if os.path.exists(dst):
                continue
            os.makedirs(dest_root, exist_ok=True)
            try:
                os.rename(src, dst)
            except OSError:
                continue
            moved += 1
            _annotate_origin(dst, name)
    return moved


def _annotate_origin(bundle_dir: str, origin: str) -> None:
    """Best-effort `origin` stamp after collection (atomic replace, so
    a concurrent reader still sees valid JSON)."""
    mpath = os.path.join(bundle_dir, MANIFEST_NAME)
    try:
        with open(mpath) as f:
            man = json.load(f)
        man["origin"] = origin
        tmp = mpath + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(man, f, indent=2, default=str)
        os.replace(tmp, mpath)
    except (OSError, ValueError):
        pass
