"""Front-of-fleet router: health-gated, bucket-affine, failover-retrying
(port of `deepof_tpu/serve/router.py`).

The fleet's public face (`python -m deepof_tpu_torch serve --replicas
N`) is one stdlib HTTP endpoint with the same API as a single replica
(`POST /v1/flow`, `POST /v1/flow/stream`, `GET /healthz`, `GET
/metrics`); behind it, `serve/fleet.py` supervises N replica processes
and this router decides, per request, which of them serves. Three
policies, in order:

  Bucket affinity. Scattering a bucket's requests across replicas
  splits its batches (every dispatch is padded to serve.max_batch rows)
  and spreads cuDNN's per-shape state over every replica. The router
  probes the request's image dimensions (header-only PNG/JPEG/BMP/PPM
  parse — no decode at the front), maps them to the resolution
  ladder's bucket, and prefers replica `ladder_index % N` — a fixed
  affinity map, so bucket b's traffic concentrates on one replica while
  every replica can still serve any bucket. Precision tiers
  (serve/quant.py) fold into the same map: the ladder is the FLATTENED
  (bucket x tier) grid and the body's `precision` field joins the
  image-dimension probe.

  Load spill + shedding. Affinity yields when the preferred replica
  already has `fleet.spill_in_flight` requests in flight (default: one
  full batch) — below that bound affinity keeps batches full, above it
  spreading wins. When EVERY healthy replica is at
  `fleet.max_in_flight`, the request is shed with a structured 503
  (`overloaded`) instead of queuing unboundedly at the front; no ready
  replica at all is a 503 `unavailable`. Shedding is the router-side
  face of the engine's queue backpressure: the per-replica in-flight
  caps bound what a replica's bounded queue would otherwise absorb.

  Failover replay. Engine requests are pure functions of their payload,
  so replaying one is idempotent by construction. A transport error
  (crashed replica: connection refused/reset), a proxy timeout (wedged
  replica), or a replica-side 5xx replays the request on the next
  healthy sibling, up to `fleet.failover_retries` times; transport
  failures also poke the supervisor so eviction doesn't wait out a full
  poll period. A request that exhausts its candidates gets a structured
  502 — every admitted request resolves to a response or a structured
  error, never silence.

  Session affinity (the one deliberate exception to statelessness).
  `POST /v1/flow/stream` frames (serve/session.py) are pinned: a sticky
  session -> replica map routes every frame of a session to the replica
  holding its cached previous frame (new sessions fall back to the
  bucket-affinity ladder, probing the body's "frame" image, and are
  pinned where their first frame lands). Sticky steps do NOT failover —
  a sibling has no cached frame, so replaying there would silently
  re-prime mid-stream. Instead, a lost pinned replica (transport error
  or 5xx) demotes to a structured 410 `session_lost` the client
  re-primes from: requests stay pure at the fleet level, there is no
  cross-replica session-state migration. The sticky map is bounded
  (serve.session.max_sessions x fleet size, LRU) and TTL-aged like the
  replica stores it mirrors; `fleet_session_*` counters surface the
  whole axis.

The live brownout level (serve/degrade.py) rides every proxied request
as `X-Degrade-Level` and folds into the affinity key the same way the
replica's engine folds it; at L3 the router itself sheds `X-Priority:
low` requests. With the supervisor's incident recorder set
(`incidents`, `obs/incident.py`), an exhausted fleet SLO commits a
critical `slo_exhausted` bundle and the `incident_*` block joins
`stats()`. The replicas' `serve_quality_*` blocks merge in the scrape by
their registered kinds: histograms bucket-wise, the per-key maps
key-wise.
"""

from __future__ import annotations

import base64
import http.client
import itertools
import json
import os
import struct
import threading
import time
from collections import OrderedDict, defaultdict
from typing import Callable

from ..core.config import ExperimentConfig
from ..obs import trace as obs_trace
from ..obs.export import (LatencyHistogram, render_prometheus, slo_state,
                          validate_slo)
from ..obs.registry import merge_stats_blocks
from .buckets import next_smaller_bucket, pick_bucket, resolve_buckets
from .quant import resolve_precisions

#: load-trend window: how many FULL seconds of per-second completion
#: buckets feed fleet_load_rps / fleet_load_slope (the predictive
#: autoscaler's signal) — long enough for a least-squares slope to ride
#: out one noisy second, short enough to see a burst inside the
#: autoscaler's up_after_s sustain window
LOAD_WINDOW_S = 10

#: JPEG start-of-frame markers that carry the image dimensions (all SOF
#: variants; C4/C8/CC are huffman/arithmetic tables, not frames).
_JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}
#: JPEG markers with no length field.
_JPEG_BARE = frozenset(range(0xD0, 0xD9)) | {0x01}


def _ppm_hw(data: bytes) -> tuple[int, int] | None:
    """(H, W) from a binary or ASCII PPM/PGM header ("P6 <w> <h> <max>",
    fields separated by whitespace, `#` comments to the end of a line);
    None when the header is short or malformed."""
    fields: list[bytes] = []
    i, n = 2, len(data)
    while len(fields) < 2 and i < n:
        c = data[i:i + 1]
        if c == b"#":
            j = data.find(b"\n", i)
            if j < 0:
                return None
            i = j + 1
        elif c.isspace():
            i += 1
        else:
            j = i
            while j < n and data[j:j + 1].isdigit():
                j += 1
            if j == i or j == n:  # not a number, or a torn one
                return None
            fields.append(data[i:j])
            i = j
    if len(fields) < 2:
        return None
    w, h = int(fields[0]), int(fields[1])
    return (h, w) if h > 0 and w > 0 else None


def probe_image_hw(data: bytes) -> tuple[int, int] | None:
    """(H, W) from PNG/JPEG/BMP/PPM header bytes — no decoder. None
    when the format is unknown or the header is short/torn: affinity is
    an optimization, so the caller falls back to unaffinitized routing
    and lets the replica produce the real decode error. PNG, JPEG and
    BMP are parsed as the JAX router parses them; PPM (the format the
    port's decoder reads on every host) is this package's own."""
    try:
        if data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) >= 24:
            w, h = struct.unpack(">II", data[16:24])
            return (int(h), int(w))
        if data[:2] == b"\xff\xd8":  # JPEG: scan segments for a SOF
            i = 2
            while i + 9 < len(data):
                if data[i] != 0xFF:
                    return None  # lost sync: not a segment boundary
                marker = data[i + 1]
                if marker == 0xFF:  # fill byte
                    i += 1
                    continue
                if marker in _JPEG_BARE:
                    i += 2
                    continue
                if marker in _JPEG_SOF:
                    h, w = struct.unpack(">HH", data[i + 5:i + 9])
                    return (int(h), int(w))
                (seg_len,) = struct.unpack(">H", data[i + 2:i + 4])
                i += 2 + seg_len
            return None
        if data[:2] == b"BM" and len(data) >= 26:
            w, h = struct.unpack("<ii", data[18:26])
            return (abs(int(h)), abs(int(w)))  # h < 0 = top-down rows
        if data[:2] in (b"P3", b"P5", b"P6"):
            return _ppm_hw(data)
    except (struct.error, IndexError):
        return None
    return None


class Router:
    """See module docstring. Thread-safe: every HTTP handler thread
    routes through one Router; the fleet's monitor mutates replica
    state under the fleet lock and the router reads immutable
    (idx, port) snapshots. Creates no CUDA context: it only proxies."""

    def __init__(self, cfg: ExperimentConfig, fleet):
        fc = cfg.serve.fleet
        self.cfg = cfg
        self.fleet = fleet
        self.buckets = resolve_buckets(cfg)
        # precision tiers fold into the affinity map: the ladder the
        # replicas serve is (bucket, tier) pairs, so the router
        # spreads that FLATTENED ladder across the fleet — bucket b at
        # tier t concentrates on replica (b_idx * n_tiers + t_idx) % N
        self.tiers = resolve_precisions(cfg)
        if float(cfg.obs.slo_latency_ms) > 0:
            validate_slo(cfg.obs)  # an unmeasurable SLO target fails HERE
        self.retries = max(int(fc.failover_retries), 0)
        self.max_in_flight = max(int(fc.max_in_flight), 1)
        # spill is a preference bound INSIDE the hard cap — past the cap
        # the only correct answer is shedding, never admission
        self.spill = min(int(fc.spill_in_flight)
                         or max(int(cfg.serve.max_batch), 1),
                         self.max_in_flight)
        self.timeout_s = max(float(fc.proxy_timeout_s), 0.1)
        self.draining = False
        # called with the cumulative response count after each success —
        # the fleet heartbeat's beat() (run_fleet wires it)
        self.beat_hook: Callable[[int], None] | None = None
        # the autoscaler's fleet_autoscale_* block (run_fleet wires
        # Autoscaler.stats when fleet.autoscale): merged into stats()
        # so scale counters ride /healthz, /metrics and the heartbeat
        # exactly like every other fleet_* counter
        self.autoscale_stats: Callable[[], dict] | None = None
        # brownout plane (serve/degrade.py; run_fleet wires both when
        # serve.degrade.enabled): degrade_level is the live level the
        # router folds into every routing decision, degrade_stats the
        # controller's degrade_* block merged into stats()
        self.degrade_stats: Callable[[], dict] | None = None
        self.degrade_level: Callable[[], int] | None = None
        self._lock = threading.Lock()
        self._in_flight: dict[int, int] = defaultdict(int)
        self._routed: dict[int, int] = defaultdict(int)
        # per-replica routed counts folded here when a slot retires
        # (autoscale scale-down, Fleet.on_retired -> retire_slot): the
        # per-index map stays bounded by the ACTIVE pool however many
        # scale events a long-lived fleet sees, and the total stays
        # monotonic
        self._routed_retired = 0
        # per-second completion buckets (unix second -> 200s landed that
        # second), the load-trend source for fleet_load_rps /
        # fleet_load_slope — the predictive autoscaler's slope signal
        # (serve/autoscale.py, fleet.autoscale_up_slope). Bounded: pruned
        # past LOAD_WINDOW_S on every insert.
        self._done_per_s: dict[int, int] = defaultdict(int)
        self._requests = 0
        self._responses = 0
        self._errors = 0
        self._failovers = 0   # replays that ultimately produced a reply
        self._retries = 0     # individual replay attempts
        self._shed = 0        # 503 overloaded (all replicas saturated)
        self._unavailable = 0  # 503 no ready replica at all
        # requests the FLEET failed (shed + unavailable + exhausted
        # failover): the SLO error budget's failure count — relayed
        # client 4xx deliberately excluded
        self._server_errors = 0
        self._rr = itertools.count()  # unaffinitized round-robin cursor
        # front-door latency histogram (obs/export.py fixed buckets):
        # admission -> reply, including failover replays — the number a
        # client actually experiences, distinct from the per-replica
        # engine histograms /metrics aggregates alongside it
        self._hist = LatencyHistogram()
        # the supervisor's incident recorder (run_fleet sets it under
        # obs.incidents): the fleet-SLO exhaustion trigger
        self.incidents = None
        # X-Request-Id sequence: globally unique enough (router pid +
        # counter) to chain one request's spans across processes in the
        # merged fleet trace
        self._rid_seq = itertools.count(1)
        # sticky session -> (replica idx, last monotonic) map
        # (serve/session.py): bounded LRU mirroring the replicas' own
        # session stores — per-replica capacity x CURRENT fleet size
        # (recomputed per put: the autoscaler changes the pool), aged by
        # the same TTL, so the front can never pin more sessions than
        # the fleet can hold
        self._sticky: OrderedDict[str, tuple[int, float]] = OrderedDict()
        self._session_cap = max(int(cfg.serve.session.max_sessions), 1)
        self._sticky_ttl = float(cfg.serve.session.ttl_s)
        self._session_primes = 0   # sessions pinned (first frame routed)
        self._session_steps = 0    # frames routed via the sticky map
        self._sessions_lost = 0    # pinned replica gone -> 410 session_lost
        self._session_evicted = 0  # sticky-map LRU drops
        self._session_expired = 0  # sticky-map TTL drops
        # deadline/brownout admission ledger: budgets that expired
        # before any replica was tried (the caller's fault, counted
        # apart from fleet_server_errors), and low-priority requests
        # shed at L3 (deliberate brownout refusals, counted apart from
        # fleet_shed so saturation sheds stay a clean overload signal)
        self._deadline_admission_expired = 0
        self._degrade_shed_low = 0

    # ---------------------------------------------------------- routing
    def _preferred(self, key) -> int:
        """Affinity replica for a (bucket, tier) key: the flattened
        (bucket x tier) ladder index modulo the CURRENT fleet size, so
        each replica's batches cover its slice of the full ladder. With
        one tier this reduces to the bucket map.
        Under autoscale the modulus tracks the live pool and slot
        indices are monotonic (a retired index is never reused), so the
        preferred index may not name a live slot — _acquire's
        ring-distance sort over the READY set still concentrates each
        key on one deterministic replica; affinity is an optimization,
        never a correctness dependency."""
        bucket, tier = key if key is not None else (None, None)
        if bucket is None or bucket not in self.buckets:
            # probe failed / unknown shape: round-robin, not replica 0 —
            # an unprobeable workload must still spread across the fleet
            return next(self._rr) % max(self.fleet.size, 1)
        t_idx = self.tiers.index(tier) if tier in self.tiers else 0
        flat = self.buckets.index(bucket) * len(self.tiers) + t_idx
        return flat % max(self.fleet.size, 1)

    def _acquire(self, key, tried: set):
        """Reserve an in-flight slot on the best candidate for a
        (bucket, tier) key. Returns (replica_snapshot, None) or
        (None, reason) where reason is 'unavailable' (no ready
        replica), 'overloaded' (all ready ones saturated), or
        'exhausted' (every ready replica already tried — failover has
        nowhere left to replay)."""
        ready = self.fleet.ready_replicas()
        if not ready:
            return None, "unavailable"
        cand = [r for r in ready if r.idx not in tried]
        if not cand:
            return None, "exhausted"
        pref = self._preferred(key)
        n = max(self.fleet.size, 1)
        cand.sort(key=lambda r: (r.idx - pref) % n)
        with self._lock:
            pick = None
            for r in cand:  # affinity order while under the spill bound
                if self._in_flight[r.idx] < self.spill:
                    pick = r
                    break
            if pick is None:  # all past spill: least-loaded wins
                pick = min(cand, key=lambda r: self._in_flight[r.idx])
                if self._in_flight[pick.idx] >= self.max_in_flight:
                    return None, "overloaded"
            self._in_flight[pick.idx] += 1
            self._routed[pick.idx] += 1
        return pick, None

    def _release(self, idx: int) -> None:
        with self._lock:
            if idx in self._in_flight:  # retire_slot may have aged it out
                self._in_flight[idx] -= 1

    def _proxy(self, replica, path: str, body: bytes, ctype: str,
               request_id: str | None = None, method: str = "POST",
               deadline: float | None = None, level: int = 0):
        conn = http.client.HTTPConnection(self.fleet.host, replica.port,
                                          timeout=self.timeout_s)
        headers = {"Content-Type": ctype or "application/json"}
        if request_id is not None:
            # the replica stamps this id on its engine spans: the merged
            # fleet trace chains router -> replica per request
            headers["X-Request-Id"] = request_id
        if deadline is not None:
            # propagate the REMAINING budget (not the original): queue
            # and failover time already spent at the front is gone —
            # the replica's enqueue/flush/wait gates see the truth
            rem_ms = max((deadline - time.monotonic()) * 1e3, 0.0)
            headers["X-Deadline-Ms"] = f"{rem_ms:.3f}"
        if level > 0:
            # the live brownout level rides per-request: the replica
            # folds it at submit (tier/bucket downgrade), keeping every
            # degradation decision on the pairs engine.warm() ran
            headers["X-Degrade-Level"] = str(int(level))
        try:
            conn.request(method, path, body, headers)
            resp = conn.getresponse()
            return (resp.status, resp.read(),
                    resp.getheader("Content-Type") or "application/json")
        finally:
            conn.close()

    # ---------------------------------------------------- sticky sessions
    def _sticky_get(self, sid: str) -> int | None:
        """The session's pinned replica index, refreshing its LRU/TTL
        standing; None when unpinned (or aged out — counted)."""
        now = time.monotonic()
        with self._lock:
            entry = self._sticky.get(sid)
            if entry is None:
                return None
            idx, last = entry
            if self._sticky_ttl > 0 and now - last > self._sticky_ttl:
                # the replica's own store expired it too (same TTL):
                # route fresh, let the replica answer with its tombstone
                del self._sticky[sid]
                self._session_expired += 1
                return None
            self._sticky[sid] = (idx, now)
            self._sticky.move_to_end(sid)
            return idx

    def _sticky_put(self, sid: str, idx: int) -> None:
        # cap from the CURRENT pool size — a lock-free cached counter
        # on the fleet, read before our lock only to keep the critical
        # section minimal (no lock-ordering concern either way)
        cap = self._session_cap * max(self.fleet.size, 1)
        with self._lock:
            fresh = sid not in self._sticky
            self._sticky[sid] = (idx, time.monotonic())
            self._sticky.move_to_end(sid)
            if fresh:
                self._session_primes += 1
            while len(self._sticky) > cap:
                self._sticky.popitem(last=False)
                self._session_evicted += 1

    def _sticky_drop(self, sid: str) -> None:
        with self._lock:
            self._sticky.pop(sid, None)

    @staticmethod
    def _is_stream(path: str) -> bool:
        return path.rstrip("/").endswith("/stream")

    @staticmethod
    def _body_json(body: bytes) -> dict | None:
        try:
            req = json.loads(body)
        except Exception:  # noqa: BLE001 - the replica owns the 400
            return None
        return req if isinstance(req, dict) else None

    def _key_from(self, req: dict | None, image_field: str = "prev",
                  level: int = 0):
        """Best-effort affinity (bucket, tier) from a parsed body:
        header-probe the image's dimensions without decoding it, and
        read the declared `precision` (an unknown tier routes as the
        default — the replica produces the structured 400, not the
        front). The live brownout level folds in the SAME downgrades the
        replica engine will apply (L1+: default tier -> cheapest; L2+:
        one bucket down the ladder), so affinity keeps pointing at the
        replica that batches the degraded (bucket, tier)."""
        if req is None:
            return None
        bucket = None
        tier = self.tiers[0]
        try:
            p = req.get("precision")
            if p in self.tiers:
                tier = p
            elif level >= 1 and len(self.tiers) > 1:
                tier = self.tiers[-1]  # mirror engine._resolve_tier
            img_b64 = req.get(image_field, "")
            if img_b64:
                # the first ~KB of image bytes holds every header we
                # parse; 4096 is 4-aligned, so a truncated prefix still
                # decodes
                raw = base64.b64decode(img_b64[:4096])
                hw = probe_image_hw(raw)
                if hw:
                    bucket = pick_bucket(hw, self.buckets)
                    if level >= 2:
                        bucket = next_smaller_bucket(bucket, self.buckets)
        except Exception:  # noqa: BLE001 - affinity is best-effort
            return None
        return (bucket, tier) if bucket is not None else None

    def _level(self) -> int:
        """The live brownout level (0 with no controller wired)."""
        hook = self.degrade_level
        if hook is None:
            return 0
        try:
            return max(int(hook()), 0)
        except Exception:  # noqa: BLE001 - degrade never kills routing
            return 0

    @staticmethod
    def _request_meta(req: dict | None, headers,
                      t0: float) -> tuple[float | None, str]:
        """(absolute monotonic deadline | None, priority) from the
        request's headers/body: `X-Deadline-Ms` (header wins) or body
        `deadline_ms` = the caller's REMAINING budget in ms;
        `X-Priority` or body `priority` in {default, low}. Malformed
        values raise ValueError — admission answers 400, not "ignored".
        """
        raw = None
        if headers is not None:
            raw = headers.get("X-Deadline-Ms")
        if raw is None and req is not None:
            raw = req.get("deadline_ms")
        deadline = None
        if raw is not None:
            try:
                deadline = t0 + float(raw) / 1e3
            except (TypeError, ValueError):
                raise ValueError(f"deadline_ms must be a number, "
                                 f"got {raw!r}")
        prio = None
        if headers is not None:
            prio = headers.get("X-Priority")
        if prio is None and req is not None:
            prio = req.get("priority")
        if prio is None:
            prio = "default"
        if prio not in ("default", "low"):
            raise ValueError(f"priority must be default|low, got {prio!r}")
        return deadline, prio

    def route_key(self, body: bytes):
        """Best-effort affinity (bucket, tier) for a /v1/flow body (the
        pre-session entry point; _route parses once and calls _key_from
        directly)."""
        return self._key_from(self._body_json(body))

    def handle_flow(self, path: str, body: bytes, ctype: str,
                    headers=None) -> tuple[int, bytes, str]:
        """Route one POST /v1/flow or /v1/flow/stream: returns (status,
        payload, ctype) — always; a request admitted here cannot be
        silently dropped. Stream frames with a pinned session route
        sticky (no failover — see _route_pinned); everything else walks
        the affinity ladder with failover replay.
        Every admitted request gets an X-Request-Id (router pid + seq)
        stamped downstream, a `route` span on the router's tracer, and
        a front-door latency observation on success. `headers` (the
        inbound request headers, when the frontend passes them) carries
        the deadline/priority plane: X-Deadline-Ms and X-Priority."""
        rid = f"r{os.getpid():x}-{next(self._rid_seq)}"
        t0 = time.monotonic()
        with self._lock:
            self._requests += 1
        with obs_trace.span("route", request_id=rid) as span:
            status, payload, rtype = self._route(path, body, ctype, rid,
                                                 t0, span, headers)
        return status, payload, rtype

    def _route(self, path: str, body: bytes, ctype: str, rid: str,
               t0: float, span, headers=None) -> tuple[int, bytes, str]:
        req = self._body_json(body)
        try:
            deadline, priority = self._request_meta(req, headers, t0)
        except ValueError as e:
            with self._lock:
                self._errors += 1  # client error: no SLO budget burned
            span.set(outcome="bad_request")
            return (400, json.dumps({"error": "bad_request",
                                     "message": str(e),
                                     "request_id": rid}).encode(),
                    "application/json")
        # admission gates, BEFORE any replica slot is considered: an
        # already-expired budget fails fast (the caller abandoned the
        # reply), and at L3 the brownout controller sheds low-priority
        # work so remaining capacity serves the default class
        if deadline is not None and deadline <= time.monotonic():
            with self._lock:
                self._errors += 1
                self._deadline_admission_expired += 1
            span.set(outcome="deadline_exceeded")
            return (504, json.dumps({
                "error": "deadline_exceeded",
                "message": "deadline expired at admission",
                "request_id": rid}).encode(), "application/json")
        level = self._level()
        if level >= 3 and priority == "low":
            with self._lock:
                self._errors += 1
                self._server_errors += 1
                self._degrade_shed_low += 1
            span.set(outcome="shed_low_priority")
            return (503, json.dumps({
                "error": "shed_low_priority",
                "message": "brownout L3: low-priority requests are shed "
                           "— retry later or raise priority",
                "request_id": rid}).encode(), "application/json")
        sid = None
        if self._is_stream(path) and req is not None:
            s = req.get("session")
            if isinstance(s, str) and s:
                sid = s
                pinned = self._sticky_get(sid)
                if pinned is not None:
                    # a pinned session's cached frame lives on exactly
                    # one replica: route there or demote to session_lost
                    # — never replay on a sibling (it has no state)
                    return self._route_pinned(path, body, ctype, rid, t0,
                                              span, sid, pinned,
                                              deadline, level)
        key = self._key_from(req, "frame" if sid is not None else "prev",
                             level=level)
        tried: set[int] = set()
        last_error = None
        for attempt in range(self.retries + 1):
            if deadline is not None and deadline <= time.monotonic():
                # the budget died between attempts: stop burning
                # sibling replicas on a reply nobody is waiting for
                with self._lock:
                    self._errors += 1
                    self._deadline_admission_expired += 1
                span.set(outcome="deadline_exceeded", attempts=attempt)
                return (504, json.dumps({
                    "error": "deadline_exceeded",
                    "message": "deadline expired during failover",
                    "request_id": rid}).encode(), "application/json")
            replica, reason = self._acquire(key, tried)
            if replica is None:
                if reason == "exhausted":
                    break  # fall through to the structured 502
                with self._lock:
                    self._errors += 1
                    self._server_errors += 1
                    if reason == "overloaded":
                        self._shed += 1
                    else:
                        self._unavailable += 1
                span.set(outcome=reason)
                msg = ("every replica is saturated — retry later"
                       if reason == "overloaded"
                       else "no healthy replica available")
                return (503,
                        json.dumps({"error": reason, "message": msg}).encode(),
                        "application/json")
            try:
                status, payload, rtype = self._proxy(replica, path, body,
                                                     ctype, request_id=rid,
                                                     deadline=deadline,
                                                     level=level)
            except Exception as e:  # noqa: BLE001 - transport = failover
                self._release(replica.idx)
                last_error = f"{type(e).__name__}: {e}"
                tried.add(replica.idx)
                with self._lock:
                    self._retries += 1
                # a dead/wedged replica shouldn't wait out a poll period
                self.fleet.note_failure(replica.idx)
                continue
            self._release(replica.idx)
            if (status == 504 and b"deadline_exceeded" in payload):
                # the CALLER's budget died on the replica — relaying is
                # correct and replaying on a sibling would waste its
                # slot on the same expired budget; not a replica fault
                with self._lock:
                    self._errors += 1
                span.set(replica=replica.idx, status=status,
                         outcome="deadline_exceeded", attempts=attempt + 1)
                return status, payload, rtype
            if status >= 500:  # replica-level failure: replay on a sibling
                last_error = payload.decode("utf-8", "replace")[:200]
                tried.add(replica.idx)
                with self._lock:
                    self._retries += 1
                self.fleet.note_failure(replica.idx)
                continue
            with self._lock:
                if attempt > 0:
                    self._failovers += 1
                if status < 400:
                    self._responses += 1
                    total = self._responses
                    self._note_done()
                else:
                    self._errors += 1  # structured client error, relayed
                    total = None
            if status < 400:
                self._hist.observe(time.monotonic() - t0)
            if sid is not None and (status < 400 or status == 410):
                # pin the session where its frame actually landed (410
                # included: the session's tombstone lives THERE, so the
                # client's re-prime must return to the same replica to
                # count as a resume). A plain 4xx primed nothing — do
                # not pin an id the replica rejected
                self._sticky_put(sid, replica.idx)
            span.set(replica=replica.idx, status=status,
                     attempts=attempt + 1)
            hook = self.beat_hook
            if total is not None and hook is not None:
                try:
                    hook(total)
                except Exception:  # noqa: BLE001 - obs never kills routing
                    pass
            return status, payload, rtype
        with self._lock:
            self._errors += 1
            self._server_errors += 1
        span.set(outcome="replica_failed", attempts=max(len(tried), 1))
        return (502, json.dumps({
            "error": "replica_failed",
            "message": f"request failed on {max(len(tried), 1)} replica(s); "
                       f"last: {last_error}",
            "attempts": max(len(tried), 1),
        }).encode(), "application/json")

    def _route_pinned(self, path: str, body: bytes, ctype: str, rid: str,
                      t0: float, span, sid: str, pinned: int,
                      deadline: float | None = None,
                      level: int = 0) -> tuple[int, bytes, str]:
        """One attempt against a session's pinned replica — no failover
        (a sibling has no cached frame; replaying there would silently
        re-prime mid-stream). A gone/failing pinned replica demotes to a
        structured 410 `session_lost` the client re-primes from.
        The deadline and brownout level ride through like the unpinned
        path (the replica folds L1's tier downgrade; L2's bucket
        downgrade deliberately does not apply to streaming steps —
        engine.submit_next documents why)."""
        replica = next((r for r in self.fleet.ready_replicas()
                        if r.idx == pinned), None)
        if replica is None:
            return self._session_lost_reply(sid, span,
                                            "replica not ready")
        with self._lock:
            if self._in_flight[replica.idx] >= self.max_in_flight:
                # the hard cap still holds for pinned traffic: shedding
                # keeps the session alive (retry-able), unlike demotion
                self._errors += 1
                self._server_errors += 1
                self._shed += 1
                span.set(outcome="overloaded", session=sid)
                return (503, json.dumps(
                    {"error": "overloaded", "session": sid,
                     "message": "the session's replica is saturated — "
                                "retry later"}).encode(),
                    "application/json")
            self._in_flight[replica.idx] += 1
            self._routed[replica.idx] += 1
        try:
            status, payload, rtype = self._proxy(replica, path, body,
                                                 ctype, request_id=rid,
                                                 deadline=deadline,
                                                 level=level)
        except Exception as e:  # noqa: BLE001 - transport = session lost
            self._release(replica.idx)
            self.fleet.note_failure(replica.idx)
            return self._session_lost_reply(sid, span,
                                            f"{type(e).__name__}: {e}")
        self._release(replica.idx)
        if status == 504 and b"deadline_exceeded" in payload:
            # the caller's budget, not the replica's health — relay;
            # the session (and its pin) stays alive for the next frame
            with self._lock:
                self._errors += 1
            span.set(replica=replica.idx, status=status, session=sid,
                     outcome="deadline_exceeded", attempts=1)
            return status, payload, rtype
        if status >= 500:
            self.fleet.note_failure(replica.idx)
            return self._session_lost_reply(
                sid, span, payload.decode("utf-8", "replace")[:200])
        with self._lock:
            if status == 200:
                # only a frame that produced flow is a STEP — a 202
                # re-prime (rebucket) or a relayed 4xx must not drift
                # this above the sum of replica serve_sessions_steps
                self._session_steps += 1
            if status < 400:
                self._responses += 1
                total = self._responses
                self._note_done()
            else:
                self._errors += 1  # structured client error, relayed
                total = None
        if status < 400:
            self._hist.observe(time.monotonic() - t0)
        span.set(replica=replica.idx, status=status, session=sid,
                 attempts=1)
        hook = self.beat_hook
        if total is not None and hook is not None:
            try:
                hook(total)
            except Exception:  # noqa: BLE001 - obs never kills routing
                pass
        return status, payload, rtype

    def _session_lost_reply(self, sid: str, span,
                            detail: str) -> tuple[int, bytes, str]:
        self._sticky_drop(sid)
        with self._lock:
            self._errors += 1
            self._server_errors += 1
            self._sessions_lost += 1
        span.set(outcome="session_lost", session=sid)
        return (410, json.dumps({
            "error": "session_lost", "session": sid,
            "message": f"the session's replica is gone ({detail}); "
                       "resend the frame to re-prime",
        }).encode(), "application/json")

    def handle_session_delete(self, path: str) -> tuple[int, bytes, str]:
        """Route DELETE /v1/flow/stream/<id>: proxy to the pinned
        replica (dropping the sticky entry either way). An unpinned id
        is a structured 404; a dead pinned replica still counts as
        deleted — its state died with it."""
        # the id is the FULL suffix after the stream prefix (the same
        # parse server.py uses, so the two frontends cannot disagree;
        # slash-bearing ids are rejected at POST, this is the backstop)
        sid = ""
        for prefix in ("/v1/flow/stream/", "/flow/stream/"):
            if path.startswith(prefix):
                sid = path[len(prefix):]
                break
        if not sid:  # bare /v1/flow/stream or an unknown path shape
            return (404, json.dumps({"error": "not_found",
                                     "message": path}).encode(),
                    "application/json")
        pinned = self._sticky_get(sid)
        if pinned is None:
            return (404, json.dumps({"error": "session_unknown",
                                     "session": sid}).encode(),
                    "application/json")
        self._sticky_drop(sid)
        replica = next((r for r in self.fleet.ready_replicas()
                        if r.idx == pinned), None)
        if replica is not None:
            try:
                return self._proxy(replica, path, b"", "application/json",
                                   method="DELETE")
            except Exception:  # noqa: BLE001 - replica gone: state gone too
                self.fleet.note_failure(replica.idx)
        return (200, json.dumps({"session": sid, "deleted": True,
                                 "note": "replica gone; session state "
                                         "died with it"}).encode(),
                "application/json")

    # --------------------------------------------------- scale-down aging
    def in_flight_of(self, idx: int) -> int:
        """Requests this router currently has proxied to one replica —
        the drain gate `Fleet.retire_one` waits out before SIGTERMing a
        retiring slot."""
        with self._lock:
            return self._in_flight.get(idx, 0)

    def retire_slot(self, idx: int) -> None:
        """Age a retired replica slot out of the per-index maps
        (`Fleet.on_retired` — called AFTER the replica is drained,
        stopped and reaped). The slot's routed count folds into the
        retained `fleet_routed_retired` total (bounded map, monotonic
        total); its in-flight entry — zero after the drain — is
        dropped. Sticky sessions pinned to the slot deliberately KEEP
        their entries: the next frame must demote to the structured 410
        `session_lost` (silently dropping the pin would re-prime
        mid-stream with no signal to the client), which
        drops the entry; abandoned pins age out via the same TTL the
        replica stores use."""
        with self._lock:
            self._in_flight.pop(idx, None)
            self._routed_retired += self._routed.pop(idx, 0)

    # ------------------------------------------------------------ stats
    def _note_done(self) -> None:
        """Bucket one completed (status < 400) request into the current
        unix second and prune the window. Caller holds self._lock."""
        s = int(time.time())
        self._done_per_s[s] += 1
        if len(self._done_per_s) > LOAD_WINDOW_S + 2:
            cutoff = s - LOAD_WINDOW_S - 1
            for k in [k for k in self._done_per_s if k < cutoff]:
                del self._done_per_s[k]

    def _load_trend(self, now: float) -> tuple[float, float]:
        """(recent requests/s, req/s-per-second slope) over the last
        LOAD_WINDOW_S FULL seconds of completion buckets. The current
        partial second is excluded (its count is still rising and would
        bias the slope down); absent seconds are zero traffic, so the
        window zero-fills — a burst arriving after idle slopes steeply,
        which is exactly the signal the predictive autoscaler wants.
        Caller holds self._lock."""
        end = int(now)
        ys = [float(self._done_per_s.get(s, 0))
              for s in range(end - LOAD_WINDOW_S, end)]
        n = len(ys)
        rps = sum(ys) / n
        mx = (n - 1) / 2.0
        denom = sum((i - mx) ** 2 for i in range(n))
        slope = sum((i - mx) * (y - rps) for i, y in enumerate(ys)) / denom
        return rps, slope

    def in_flight_total(self) -> int:
        with self._lock:
            return sum(self._in_flight.values())

    def stats(self) -> dict:
        """The router's half of the fleet_* counter block (the fleet
        heartbeat merges it with Fleet.stats()), including the
        front-door latency histogram and — when cfg.obs.slo_latency_ms
        is set — the fleet SLO state the error budget burns against."""
        hist = self._hist.snapshot()
        with self._lock:
            rps, slope = self._load_trend(time.time())
            out = {
                "fleet_load_rps": round(rps, 3),
                "fleet_load_slope": round(slope, 4),
                "fleet_requests": self._requests,
                "fleet_responses": self._responses,
                "fleet_errors": self._errors,
                "fleet_server_errors": self._server_errors,
                "fleet_failovers": self._failovers,
                "fleet_retries": self._retries,
                "fleet_shed": self._shed,
                "fleet_unavailable": self._unavailable,
                "fleet_in_flight": sum(self._in_flight.values()),
                "fleet_routed": {f"replica-{i}": n
                                 for i, n in sorted(self._routed.items())},
                "fleet_routed_retired": self._routed_retired,
                "fleet_draining": self.draining,
                # session-affinity axis (serve/session.py): sticky-map
                # size + the pin/step/lost ledger `tail` surfaces
                "fleet_sessions_sticky": len(self._sticky),
                "fleet_session_primes": self._session_primes,
                "fleet_session_steps": self._session_steps,
                "fleet_session_lost": self._sessions_lost,
                "fleet_session_evicted": self._session_evicted,
                "fleet_session_expired": self._session_expired,
                # deadline/brownout admission ledger (router-owned; the
                # engines' deadline_*/degrade_* stage counters arrive
                # via the replica scrape, names disjoint by design)
                "deadline_admission_expired":
                    self._deadline_admission_expired,
                "degrade_shed_low": self._degrade_shed_low,
            }
            requests, failures = self._requests, self._server_errors
        out["fleet_latency_hist"] = hist
        scaler = self.autoscale_stats
        if scaler is not None:
            try:
                out.update(scaler())
            except Exception:  # noqa: BLE001 - obs never kills routing
                pass
        degr = self.degrade_stats
        if degr is not None:
            try:
                out.update(degr())
            except Exception:  # noqa: BLE001 - obs never kills routing
                pass
        if float(self.cfg.obs.slo_latency_ms) > 0:
            # the router's own histogram IS the burn source: it sees
            # every admitted request, including ones no replica answered
            out["fleet_slo"] = slo_state(hist, requests, failures,
                                         self.cfg.obs.slo_latency_ms,
                                         self.cfg.obs.slo_error_budget)
        rec = self.incidents
        if rec is not None:
            slo = out.get("fleet_slo")
            if slo and slo.get("exhausted"):
                # the fleet's contract: a supervisor-level incident (the
                # dedup window absorbs the heartbeat's re-checks)
                rec.record("slo_exhausted", "critical",
                           trigger={"slo": slo})
            out.update(rec.stats())
        return out

    # ---------------------------------------------------------- /metrics
    def scrape_replicas(self, timeout_s: float = 2.0) -> dict:
        """Fleet-aggregated serve_* block: GET /healthz on every ready
        replica (concurrently — one wedged-but-still-ready replica must
        cost at most ONE timeout, not one per scrape position) and
        merge by each key's DECLARED kind (obs/registry.py, the schema
        owner): additive counters sum, per-tier maps sum by key,
        high-water marks take the max, per-replica gauges/bools/derived
        values are dropped, and the latency histograms merge EXACTLY
        (fixed shared buckets, obs/export.py) so the fleet-wide bucket
        counts equal the sum of the replicas' at scrape time. A counter
        registered in the schema joins this scrape with no edit here.
        Replicas that fail the scrape are skipped and counted."""
        def fetch(replica):
            conn = http.client.HTTPConnection(
                self.fleet.host, replica.port,
                timeout=max(float(timeout_s), 0.1))
            try:
                conn.request("GET", "/healthz")
                return json.loads(conn.getresponse().read())
            finally:
                conn.close()

        replicas = self.fleet.ready_replicas()
        results: list[dict | None] = []
        if replicas:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=len(replicas)) as pool:
                futures = [pool.submit(fetch, r) for r in replicas]
                for fut in futures:
                    try:
                        results.append(fut.result())
                    except Exception:  # noqa: BLE001 - sick replica: skip
                        results.append(None)
        blocks = [{k: v for k, v in stats.items()
                   if k.startswith(("serve_", "deadline_", "degrade_"))}
                  for stats in results if stats is not None]
        out = merge_stats_blocks(blocks)
        out["serve_replicas_scraped"] = len(blocks)
        out["serve_replicas_scrape_failed"] = len(results) - len(blocks)
        return out

    def metrics_text(self) -> str:
        """GET /metrics body: supervisor + router + fleet-aggregated
        replica blocks in Prometheus text format."""
        return render_prometheus({**self.fleet.stats(), **self.stats(),
                                  **self.scrape_replicas()})


def build_router_server(cfg: ExperimentConfig, router: Router):
    """The fleet's front HTTP server (same stdlib stack and API shape as
    `serve/server.py`), bound to cfg.serve.host:port; returned unstarted
    so callers drive serve_forever themselves."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Server(ThreadingHTTPServer):
        daemon_threads = True

        def handle_error(self, request, client_address):
            import sys

            exc = sys.exc_info()[1]
            if isinstance(exc, (ConnectionError, TimeoutError)):
                return
            super().handle_error(request, client_address)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # obs owns visibility
            pass

        def _reply(self, status: int, body: bytes,
                   ctype: str = "application/json") -> None:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_json(self, status: int, payload: dict) -> None:
            self._reply(status, json.dumps(payload).encode())

        def do_GET(self):  # noqa: N802
            if self.path in ("/healthz", "/stats"):
                payload = {**router.fleet.stats(), **router.stats(),
                           "replicas": router.fleet.describe(),
                           "time": time.time()}
                ok = payload.get("fleet_ready", 0) > 0 and not router.draining
                self._reply(200 if ok else 503,
                            json.dumps(payload).encode())
            elif self.path == "/metrics":
                from ..obs.export import PROM_CONTENT_TYPE

                # fleet-aggregated Prometheus scrape: fleet_* + router
                # counters + the replicas' serve_* blocks merged live
                # (histogram bucket counts = exact sum of the replicas')
                self._reply(200, router.metrics_text().encode(),
                            PROM_CONTENT_TYPE)
            else:
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/flow", "/flow",
                                 "/v1/flow/stream", "/flow/stream"):
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})
                return
            if router.draining:
                self._reply_json(503, {"error": "draining",
                                       "message": "fleet is shutting down"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
            except (ValueError, OSError) as e:
                self._reply_json(400, {"error": "bad_request",
                                       "message": f"{type(e).__name__}: {e}"})
                return
            status, payload, ctype = router.handle_flow(
                self.path, body, self.headers.get("Content-Type", ""),
                headers=self.headers)
            self._reply(status, payload, ctype)

        def do_DELETE(self):  # noqa: N802
            if not self.path.startswith(("/v1/flow/stream/",
                                         "/flow/stream/")):
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})
                return
            if router.draining:
                self._reply_json(503, {"error": "draining",
                                       "message": "fleet is shutting down"})
                return
            status, payload, ctype = router.handle_session_delete(self.path)
            self._reply(status, payload, ctype)

    return Server((cfg.serve.host, cfg.serve.port), Handler)
