"""Scrapeable metrics: fixed latency histograms, Prometheus text, and the
SLO arithmetic (a copy of `deepof_tpu/obs/export.py`; stdlib only).

  LatencyHistogram / ValueHistogram: fixed log-spaced buckets
      (`LATENCY_BUCKETS_MS`, powers of two from 0.5 ms to ~16 s), so two
      snapshots merge exactly (`merge_hists`, a bucket-wise sum) and a
      percentile read off them (`percentile_ms`: the upper bound of the
      bucket holding the rank) is the same at every level of merging.
  render_prometheus / parse_prometheus: the Prometheus text exposition
      format over a stats dict (numbers as gauges, maps as labelled
      gauges, histogram snapshots as cumulative `_bucket` series with
      `_sum` and `_count`) and its read-back.
  validate_slo / slo_state: the latency/error-budget state of a
      histogram: the target rounds up to a bucket bound, breaches plus
      server-side failures burn the budget, `exhausted` at burn >= 1.
  start_metrics_server: GET /metrics and /healthz over a stats function,
      for a process with no HTTP front end of its own.

The serving engine (`serve/engine.py`) keeps its latencies in these
histograms and `serve/server.py` renders its `/metrics` with them.
"""

from __future__ import annotations

import json
import re
import threading
from bisect import bisect_left
from typing import Callable

#: Fixed log-spaced latency bucket upper bounds, in milliseconds
#: (powers of two, 0.5 ms .. 16.4 s; one implicit +Inf bucket past the
#: end). FIXED means: never derived from config or observed data — two
#: histograms anywhere in the fleet always share these bounds, so
#: merging is an exact bucket-wise sum.
LATENCY_BUCKETS_MS: tuple[float, ...] = tuple(0.5 * 2 ** i
                                              for i in range(16))

#: Fixed log-spaced bounds for the label-free flow-QUALITY proxies
#: (obs/quality.py): dimensionless Charbonnier/census/smoothness values,
#: powers of two from ~0.001 to 1024. Same contract as the latency
#: bounds: never config-derived, so replica quality histograms merge
#: EXACTLY at the router. NOTE: quality snapshots reuse the histogram
#: snapshot schema ("buckets_ms"/"sum_ms" keys) for merge/percentile
#: machinery compatibility — the bounds are raw proxy units, not
#: milliseconds (the Prometheus renderer drops the _ms suffix for any
#: non-latency bounds).
QUALITY_BUCKETS: tuple[float, ...] = tuple(2.0 ** i for i in range(-10, 11))


class ValueHistogram:
    """Thread-safe fixed-bucket histogram over arbitrary nonnegative
    values. The bounds are fixed BY THE CALLER'S CONTRACT (a shared
    module constant, never config/data-derived), which is what makes two
    processes' snapshots merge exactly. O(1) observe."""

    def __init__(self, bounds: tuple[float, ...] = LATENCY_BUCKETS_MS,
                 sum_digits: int = 6):
        self._bounds = tuple(float(b) for b in bounds)
        self._sum_digits = int(sum_digits)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self._bounds) + 1)  # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = max(float(value), 0.0)
        idx = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> dict:
        """JSON-ready state: {"buckets_ms", "counts", "sum_ms",
        "count"}. `counts` are per-bucket (NOT cumulative) so snapshots
        merge by element-wise addition; the Prometheus renderer
        cumulates at render time. Key names carry "_ms" for schema
        stability across every consumer — for non-latency bounds the
        values are raw units (see QUALITY_BUCKETS note)."""
        with self._lock:
            return {"buckets_ms": list(self._bounds),
                    "counts": list(self._counts),
                    "sum_ms": round(self._sum, self._sum_digits),
                    "count": self._count}


class LatencyHistogram(ValueHistogram):
    """Thread-safe fixed-bucket latency histogram (see module docstring).

    `observe` takes seconds (every latency in this repo is monotonic
    seconds); the snapshot reports milliseconds (the unit the serve
    percentiles already use)."""

    def __init__(self):
        super().__init__(LATENCY_BUCKETS_MS, sum_digits=3)

    def observe(self, seconds: float) -> None:
        super().observe(max(float(seconds), 0.0) * 1e3)


def percentile_ms(hist: dict | None, frac: float) -> float | None:
    """Approximate percentile from a fixed-bucket snapshot: the upper
    bound of the bucket holding the quantile rank (the same answer at
    every aggregation level, because the buckets are fixed by contract —
    unlike a deque-based percentile, this one survives an exact merge).
    None on an empty/absent histogram; observations in the +Inf bucket
    report the largest finite bound (the histogram cannot say more)."""
    if not is_hist_snapshot(hist):
        return None
    total = sum(int(c) for c in hist["counts"])
    if total <= 0:
        return None
    rank = max(min(float(frac), 1.0), 0.0) * (total - 1)
    cum = 0
    for i, c in enumerate(hist["counts"]):
        cum += int(c)
        if cum > rank:
            bounds = hist["buckets_ms"]
            return float(bounds[min(i, len(bounds) - 1)])
    return float(hist["buckets_ms"][-1])


def is_hist_snapshot(value) -> bool:
    return (isinstance(value, dict) and "counts" in value
            and "buckets_ms" in value)


def merge_hists(snapshots: list[dict]) -> dict:
    """Element-wise EXACT merge of histogram snapshots — the fleet
    aggregation primitive. Every snapshot in the set must share one
    internally consistent bound layout (the latency buckets, the quality
    buckets — any fixed-by-contract set); a mismatch within the set, or
    a bounds/counts length mismatch, raises ValueError — a foreign
    histogram must fail loudly, not merge approximately."""
    if not snapshots:
        raise ValueError("merge_hists: empty snapshot list")
    first = snapshots[0]
    if not is_hist_snapshot(first):
        raise ValueError(f"not a histogram snapshot: {first!r}")
    buckets = list(first["buckets_ms"])
    counts = [0] * (len(buckets) + 1)
    sum_ms = 0.0
    count = 0
    for s in snapshots:
        if not is_hist_snapshot(s):
            raise ValueError(f"not a histogram snapshot: {s!r}")
        if list(s["buckets_ms"]) != buckets or len(s["counts"]) != len(counts):
            raise ValueError(
                "histogram bucket bounds differ — cannot merge exactly "
                f"(got {s['buckets_ms']!r})")
        for i, c in enumerate(s["counts"]):
            counts[i] += int(c)
        sum_ms += float(s["sum_ms"])
        count += int(s["count"])
    return {"buckets_ms": buckets, "counts": counts,
            # 6 digits, not 3: quality-proxy sums are dimensionless and
            # can sit at 1e-4 scale per sample (ValueHistogram's
            # sum_digits=6) — a 3-digit merge would zero them fleet-wide
            "sum_ms": round(sum_ms, 6), "count": count}


# ------------------------------------------------------------------ SLO


def validate_slo(obs_cfg) -> None:
    """Loud config validation (the config_from_dict philosophy: a knob
    that cannot work must fail at construction, not silently no-op).
    A latency target past the largest histogram bound could never count
    a breach — the fixed buckets cannot distinguish 17 s from 60 s —
    so the serve engine and the fleet router reject it up front."""
    target = float(obs_cfg.slo_latency_ms)
    if target > LATENCY_BUCKETS_MS[-1]:
        raise ValueError(
            f"obs.slo_latency_ms={target:g} exceeds the largest fixed "
            f"histogram bound ({LATENCY_BUCKETS_MS[-1]:g} ms) — breaches "
            "past it are indistinguishable in the bucket layout and the "
            "SLO would silently never burn; pick a target <= the bound "
            "(or 0 to disable the SLO layer)")
    if float(obs_cfg.slo_error_budget) <= 0:
        raise ValueError(
            f"obs.slo_error_budget={obs_cfg.slo_error_budget!r} must be "
            "> 0 (the fraction of requests allowed to breach)")


def slo_state(hist: dict | None, requests: int, failures: int,
              latency_ms: float, error_budget: float) -> dict:
    """Latency/error-budget state from one histogram snapshot.

    hist: a LatencyHistogram snapshot (None = no latency data yet).
    requests: total admitted requests (the budget's denominator).
    failures: server-side failures (shed/unavailable/dispatch — CLIENT
        errors deliberately excluded: a caller's bad input must not burn
        the operator's budget).
    latency_ms: the SLO latency target; rounded UP to the nearest
        histogram bucket bound ("bucket_ms" reports the effective
        threshold) so burn computed from merged histograms at any
        aggregation level is identical.
    error_budget: allowed bad fraction (breaches + failures over
        requests); burn = bad_fraction / budget, exhausted at >= 1.
    """
    latency_ms = float(latency_ms)
    idx = bisect_left(LATENCY_BUCKETS_MS, latency_ms)
    bucket_ms = (LATENCY_BUCKETS_MS[idx] if idx < len(LATENCY_BUCKETS_MS)
                 else None)  # None: the target exceeds every bound (+Inf)
    breaches = 0
    if is_hist_snapshot(hist):
        # observations STRICTLY above the effective bound: everything in
        # buckets past idx (bucket idx holds obs <= its bound)
        breaches = sum(int(c) for c in hist["counts"][idx + 1:])
    requests = max(int(requests), 0)
    failures = max(int(failures), 0)
    bad = breaches + failures
    budget = max(float(error_budget), 1e-9)
    bad_fraction = (bad / requests) if requests else 0.0
    burn = bad_fraction / budget
    return {
        "latency_ms": latency_ms,
        "bucket_ms": bucket_ms,
        "error_budget": round(budget, 6),
        "requests": requests,
        "breaches": breaches,
        "failures": failures,
        "bad_fraction": round(bad_fraction, 6),
        "burn": round(burn, 4),
        "exhausted": bool(requests and bad_fraction >= budget),
    }


# ----------------------------------------------------------- prometheus

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")
#: /metrics Content-Type (the exposition-format version Prometheus pins)
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _sanitize(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    return f"_{name}" if name[:1].isdigit() else name


def _escape_label(value) -> str:
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _fmt(value) -> str:
    if isinstance(value, bool):
        return "1" if value else "0"
    f = float(value)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(stats: dict, namespace: str = "deepof") -> str:
    """Render a flat stats dict (the serve_*/fleet_*/elastic_* blocks)
    as Prometheus text exposition format. Rules:

      number/bool          -> gauge `ns_key value`
      dict of numbers      -> labeled gauge `ns_key{key="sub"} value`
      dict of strings      -> state sample `ns_key{key="sub",value="s"} 1`
      histogram snapshot   -> `ns_base_bucket{le=...}` CUMULATIVE counts
                              (+Inf last) + `ns_base_sum` + `ns_base_count`,
                              where base strips a trailing `_hist` and
                              appends `_ms` for latency-bounded
                              histograms (quality histograms keep raw
                              dimensionless names)
      None / other         -> skipped

    Deterministic output ordering (sorted keys) so scrapes diff cleanly.
    """
    lines: list[str] = []
    for key in sorted(stats):
        value = stats[key]
        if value is None or isinstance(value, str):
            continue
        name = f"{_sanitize(namespace)}_{_sanitize(key)}"
        if is_hist_snapshot(value):
            base = key[:-len("_hist")] if key.endswith("_hist") else key
            # the "_ms" unit suffix belongs only to latency histograms;
            # quality histograms (QUALITY_BUCKETS bounds) carry raw
            # dimensionless proxy values despite the snapshot's schema
            # key names (see QUALITY_BUCKETS note)
            unit = ("_ms" if list(value["buckets_ms"])
                    == list(LATENCY_BUCKETS_MS) else "")
            base = f"{_sanitize(namespace)}_{_sanitize(base)}{unit}"
            lines.append(f"# TYPE {base} histogram")
            cum = 0
            for bound, c in zip(value["buckets_ms"], value["counts"]):
                cum += int(c)
                lines.append(f'{base}_bucket{{le="{_fmt(bound)}"}} {cum}')
            cum += int(value["counts"][len(value["buckets_ms"])])
            lines.append(f'{base}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{base}_sum {_fmt(value['sum_ms'])}")
            lines.append(f"{base}_count {_fmt(value['count'])}")
        elif isinstance(value, dict):
            numeric = {k: v for k, v in value.items()
                       if isinstance(v, (int, float)) and v is not None}
            stringy = {k: v for k, v in value.items() if isinstance(v, str)}
            if numeric:
                lines.append(f"# TYPE {name} gauge")
                for sub in sorted(numeric):
                    lines.append(
                        f'{name}{{key="{_escape_label(sub)}"}} '
                        f"{_fmt(numeric[sub])}")
            if stringy:
                lines.append(f"# TYPE {name} gauge")
                for sub in sorted(stringy):
                    lines.append(
                        f'{name}{{key="{_escape_label(sub)}",'
                        f'value="{_escape_label(stringy[sub])}"}} 1')
        elif isinstance(value, (int, float)):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_fmt(value)}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)\s*$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict[str, float]:
    """Inverse of render_prometheus for the test suite and the bench
    scrape path: {"name" or 'name{a="b",...}' (labels sorted): value}.
    Unparseable lines are skipped (a scrape must not crash the reader)."""
    out: dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, labels, raw = m.groups()
        try:
            value = float(raw)
        except ValueError:
            continue
        if labels:
            pairs = sorted(
                (k, v.encode().decode("unicode_escape"))
                for k, v in _LABEL_RE.findall(labels))
            name += "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"
        out[name] = value
    return out


# -------------------------------------------------------- metrics server


def start_metrics_server(stats_fn: Callable[[], dict],
                         host: str = "127.0.0.1", port: int = 0):
    """A minimal daemon-threaded HTTP server exposing GET /metrics
    (Prometheus text over `stats_fn()`) and GET /healthz (the same dict
    as JSON) — for processes with no frontend of their own (the elastic
    coordinator). Returns the already-serving HTTPServer; callers read
    `server_address` for the bound port and call shutdown()/
    server_close() on exit. `stats_fn` failures become a 500, never a
    crashed serving thread."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        daemon_threads = True

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # obs owns visibility
            pass

        def _reply(self, status: int, body: bytes, ctype: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler contract
            if self.path not in ("/metrics", "/healthz", "/stats"):
                self._reply(404, b'{"error": "not_found"}',
                            "application/json")
                return
            try:
                stats = stats_fn() or {}
            except Exception as e:  # noqa: BLE001 - scrape must not kill
                self._reply(500, json.dumps(
                    {"error": "stats_failed",
                     "message": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")
                return
            if self.path == "/metrics":
                self._reply(200, render_prometheus(stats).encode(),
                            PROM_CONTENT_TYPE)
            else:
                self._reply(200, json.dumps(stats).encode(),
                            "application/json")

    httpd = Server((host, port), Handler)
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="obs-metrics").start()
    return httpd
