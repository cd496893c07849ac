"""Flow serving over HTTP and over a directory of frames (port of
`deepof_tpu/serve/server.py`), behind `python -m deepof_tpu_torch serve`.

  HTTP server: the standard library's `ThreadingHTTPServer` (a thread a
  request, so concurrent clients coalesce in the engine's micro-batcher).
  JSON in; JSON, `.flo` or PNG out. A serve heartbeat (`obs/heartbeat.py`)
  rewrites `<log_dir>/heartbeat.json` with the engine's serve_* block;
  its watchdog dumps the thread stacks if the batcher wedges while work
  is in flight. SIGTERM stops admission, answers what is in flight
  within `serve.fleet.drain_timeout_s` and exits 0.

  Offline mode: the consecutive pairs of a directory of frames, decoded
  and preprocessed by the `data/pipeline.py` worker pool
  (`serve.workers`), staged through a `data/prefetch.py` Prefetcher and
  batched through the engine, with the `.flo` / PNG writes overlapping
  the next batches.

API (the JAX package's):
  GET  /healthz           -> 200, the engine's serve_* stats as JSON
  GET  /metrics           -> the same in Prometheus text (obs/export.py)
  POST /v1/flow           -> body {"prev": <b64 image>, "next": <b64>,
                             "format": "json"|"flo"|"png",
                             "precision": a tier of serve.precisions
                             (optional), "deadline_ms" (optional)}
    json: {"flow_b64": <b64 little-endian float32 (H, W, 2)>, "shape",
           "bucket", "precision", "native_hw", "latency_ms",
           "request_id"}
    flo:  application/octet-stream Middlebury .flo bytes
    png:  image/png, the flow's colours (utils/flowviz.py)
  POST /v1/flow/stream    -> body {"session": <id>, "frame": <b64 image>,
                             "format"/"precision" as above}: one frame of
                             a streaming session (serve/session.py)
    202 {"primed": true, "session", "bucket", "native_hw", "frames",
         "request_id"}: the frame opened (or re-opened) the session
    200 the /v1/flow payload for the (previous, this) pair, with
        "session", "frame_index" and, under serve.session.warm_start,
        "warm"
    410 {"error": "session_expired"}: resend the frame to re-prime
  DELETE /v1/flow/stream/<id> -> 200 {"session", "deleted": true} |
                             404 {"error": "session_unknown"}
  Headers: X-Request-Id (echoed, stamped on the engine's spans),
  X-Deadline-Ms (or the body's "deadline_ms": the caller's budget; 504
  when it lapses) and X-Degrade-Level (the brownout fold).
  Errors are structured ({"error": code, "message"}): 400 for a bad
  request or input, 410 for an expired session, 504 for a lapsed
  deadline or the blanket `serve.request_timeout_s`, 500 otherwise.

Images are decoded from the request's bytes by
`data/datasets.py::decode_image_bytes` (the native decoder, or the
Python PNG and PPM readers): a codec the build lacks is a 400
`bad_input` naming the codecs it has.

As a replica of the fleet (`serve/fleet.py` spawns it with
`DEEPOF_TPU_REPLICA=<index>` and `--config-json`), the server traces and
beats as role "replica", arms the replica fault sites
(`install_replica_faults`), and its final kind="serve" record carries
the kernels' launches while it served (`kernel_launches`, counted from
the end of `engine.warm()`). Its announce line stays the first line on
stdout: the fleet reads the bound port from it.

A server that builds its own engine splits its boot (`boot`, in the
announce line and the final record; seconds, None where a part does
not apply): `process_to_main_s` (the interpreter's start and the
package's imports, from the process's start time in /proc),
`torch_import_s` (timed by `cli.main`), `cuda_context_s` (the first
allocation on the card), `library_load_s` (the CUDA libraries the
engine launches, `engine.serve_libraries`, fetched from the artifact
store under `serve.artifacts_dir` and loaded, built first where
absent; the fetch's verdicts in `library_fetch`),
`restore_s` (the model built and the newest checkpoint verified and
read), `engine_s` (the engine's tiers and stages), `warm_s`
(`engine.warm()`, the ledger's traces included) and `ready_s` (the
process's age at the announce line).

Under `obs.incidents` the server installs the process's incident
recorder (`obs/incident.py`, role "serve" or "replica") on the engine,
which records `slo_exhausted` and `quality_drift` bundles from its
verdicts; the heartbeat's samples feed the recorder's ring and alert
rules, and a watchdog wedge commits a critical `watchdog_wedge` bundle
with the stack dump. Not ported (ROADMAP item 8.4): a video file as
offline input (the JAX package reads it with cv2.VideoCapture).
"""

from __future__ import annotations

import base64
import json
import os
import signal
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout

import numpy as np

from ..core.config import ExperimentConfig, raise_unported
from ..core.supervise import process_age_s
from ..io.flo import flo_bytes
from ..io.png import png_bytes
from ..obs import incident
from ..obs import trace as obs_trace
from ..obs.export import PROM_CONTENT_TYPE, render_prometheus
from ..utils.flowviz import flow_to_color
from .artifacts import store_for_config
from .engine import InferenceEngine, ServeError, serve_libraries

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp")
_VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")

#: Replica identity exported by the fleet supervisor (serve/fleet.py) to
#: each spawned serving subprocess — the index the replica-level fault
#: sites key on, and the tag in the replica's announce line.
REPLICA_ENV = "DEEPOF_TPU_REPLICA"


def replica_index() -> int:
    """This serving process's replica index (0 outside a fleet)."""
    try:
        return int(os.environ.get(REPLICA_ENV, "0"))
    except ValueError:
        return 0


def _role() -> str:
    return "replica" if os.environ.get(REPLICA_ENV) else "serve"


def install_replica_faults(engine: InferenceEngine,
                           cfg: ExperimentConfig) -> None:
    """Arm the replica-level chaos sites (resilience/faults.py) inside
    THIS serving process: once the engine has completed
    `replica_fault_after` responses, a scheduled `replica_crash` SIGKILLs
    the process mid-load and a scheduled `replica_wedge` blocks the next
    dispatch forever (a hung device call — the serve watchdog's target);
    a scheduled `replica_degrade` adds 25.0 to every later flow (damaged
    weights as a steady state). The site index is the replica index, so
    one fleet-wide fault config deterministically picks which replicas
    get sick; a respawned replica rebuilds the injector and re-arms the
    same schedule. No-op when injection is disabled."""
    from ..resilience.faults import build_injector

    inj = build_injector(cfg.resilience.faults)
    if inj is None:
        return
    idx = replica_index()
    after = max(int(cfg.resilience.faults.replica_fault_after), 0)
    # replica_degrade is a PERSISTENT condition, not a one-shot event:
    # scheduled-ness is read once (pure in config); the consume-once
    # hit() only counts the arming
    degrade = inj.scheduled("replica_degrade", idx)
    inner = engine._forward

    def forward(key, x, *args, **kw):
        # signature-transparent: the engine calls _forward(key, x, prior)
        with engine._stats_lock:
            done = engine._responses
        if done >= after:
            if inj.hit("replica_crash", idx):
                os.kill(os.getpid(), signal.SIGKILL)
            if inj.hit("replica_wedge", idx):
                threading.Event().wait()  # never returns: wedged dispatch
        out = inner(key, x, *args, **kw)
        if degrade and done >= after:
            inj.hit("replica_degrade", idx)  # count the arming, once
            out = np.asarray(out) + np.float32(25.0)
        return out

    engine._forward = forward


def _decode_b64_image(b64, field: str) -> np.ndarray:
    from ..data.datasets import decode_image_bytes

    try:
        raw = base64.b64decode(b64, validate=True)
    except Exception as e:  # noqa: BLE001 - a client error, answered 400
        raise ServeError("bad_request", f"{field}: invalid base64: {e}")
    try:
        return decode_image_bytes(raw)
    except ValueError as e:
        raise ServeError("bad_input", f"{field}: {e}")


def _error_status(code: str) -> int:
    return (400 if code in ("bad_input", "bad_request")
            else 410 if code == "session_expired"
            else 504 if code == "deadline_exceeded"
            else 500)


def build_server(cfg: ExperimentConfig, engine: InferenceEngine):
    """A ThreadingHTTPServer bound to serve.host:serve.port serving the
    engine; returned unstarted (call serve_forever, or run it on a
    thread), so tests drive it on port 0."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    timeout_s = max(float(cfg.serve.request_timeout_s), 0.1)

    class Server(ThreadingHTTPServer):
        daemon_threads = True  # a stuck client never blocks shutdown

        def handle_error(self, request, client_address):
            # a client that drops the connection mid-reply is routine
            import sys

            if isinstance(sys.exc_info()[1], (ConnectionError,
                                              TimeoutError)):
                return
            super().handle_error(request, client_address)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive; Content-Length always

        def log_message(self, fmt, *args):  # the stats and spans tell
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

        def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler's name
            if self.path in ("/healthz", "/stats"):
                self._reply_json(200, engine.stats())
            elif self.path == "/metrics":
                self._reply(200, render_prometheus(engine.stats()).encode(),
                            PROM_CONTENT_TYPE)
            else:
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})

        def do_POST(self):  # noqa: N802
            stream = self.path in ("/v1/flow/stream", "/flow/stream")
            if not stream and self.path not in ("/v1/flow", "/flow"):
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})
                return
            request_id = self.headers.get("X-Request-Id")
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                fmt = req.get("format", "json")
                if fmt not in ("json", "flo", "png"):
                    raise ServeError("bad_request", f"format must be "
                                     f"json|flo|png, got {fmt!r}")
                precision = req.get("precision")
                raw_deadline = self.headers.get("X-Deadline-Ms",
                                                req.get("deadline_ms"))
                deadline_s = None
                if raw_deadline is not None:
                    try:
                        deadline_s = float(raw_deadline) / 1e3
                    except (TypeError, ValueError):
                        raise ServeError("bad_request",
                                         f"deadline_ms must be a number, "
                                         f"got {raw_deadline!r}")
                try:  # lenient: a malformed level serves at level 0
                    degrade_level = int(self.headers.get("X-Degrade-Level",
                                                         0))
                except (TypeError, ValueError):
                    degrade_level = 0
                if stream:
                    sid = req.get("session")
                    if not isinstance(sid, str) or not sid:
                        raise ServeError("bad_request",
                                         "stream body needs a non-empty "
                                         "string \"session\" id")
                    if "/" in sid:  # ids ride in the DELETE path
                        raise ServeError("bad_request", f"session id "
                                         f"{sid!r} must not contain '/'")
                    frame = _decode_b64_image(req.get("frame", ""), "frame")
                else:
                    prev = _decode_b64_image(req.get("prev", ""), "prev")
                    nxt = _decode_b64_image(req.get("next", ""), "next")
            except ServeError as e:
                self._reply_json(400, e.payload())
                return
            except Exception as e:  # noqa: BLE001 - a malformed body
                self._reply_json(400, {"error": "bad_request",
                                       "message": f"{type(e).__name__}: {e}"})
                return
            kw = dict(precision=precision, request_id=request_id,
                      deadline_s=deadline_s, degrade_level=degrade_level)
            fut = (engine.submit_next(sid, frame, **kw) if stream
                   else engine.submit(prev, nxt, **kw))
            # the wait is capped at the caller's own budget, so a doomed
            # request frees its handler when its deadline lapses
            wait_s = timeout_s
            if deadline_s is not None:
                wait_s = min(timeout_s, max(deadline_s, 0.0))
            try:
                res = fut.result(timeout=wait_s)
            except ServeError as e:
                self._reply_json(_error_status(e.code), e.payload())
                return
            except FuturesTimeout:
                if wait_s < timeout_s:
                    engine.note_wait_expired()
                    self._reply_json(504, {
                        "error": "deadline_exceeded",
                        "message": f"deadline lapsed after {wait_s}s "
                                   f"waiting for dispatch",
                        **({"request_id": request_id}
                           if request_id is not None else {})})
                    return
                self._reply_json(504, {"error": "timeout",
                                       "message": f"no response within "
                                                  f"{timeout_s}s"})
                return
            if stream and res.get("primed"):
                self._reply_json(202, {
                    "primed": True, "session": res["session"],
                    "bucket": list(res["bucket"]),
                    "native_hw": list(res["native_hw"]),
                    "frames": res["frames"],
                    "request_id": res["request_id"]})
                return
            flow = res["flow"]
            if fmt == "flo":
                self._reply(200, flo_bytes(flow), "application/octet-stream")
            elif fmt == "png":
                self._reply(200, png_bytes(flow_to_color(flow)), "image/png")
            else:
                payload = {
                    "shape": list(flow.shape),
                    "bucket": list(res["bucket"]),
                    "precision": res["precision"],
                    "native_hw": list(res["native_hw"]),
                    "latency_ms": round(res["latency_s"] * 1e3, 3),
                    "request_id": res["request_id"],
                    "flow_b64": base64.b64encode(np.ascontiguousarray(
                        flow, "<f4").tobytes()).decode()}
                if stream:
                    payload["session"] = res["session"]
                    payload["frame_index"] = res["frame_index"]
                    if "warm" in res:
                        payload["warm"] = res["warm"]
                self._reply_json(200, payload)

        def do_DELETE(self):  # noqa: N802
            for prefix in ("/v1/flow/stream/", "/flow/stream/"):
                if self.path.startswith(prefix):
                    sid = self.path[len(prefix):]
                    break
            else:
                self._reply_json(404, {"error": "not_found",
                                       "message": self.path})
                return
            if engine.sessions.delete(sid):
                self._reply_json(200, {"session": sid, "deleted": True})
            else:
                self._reply_json(404, {"error": "session_unknown",
                                       "session": sid})

    return Server((cfg.serve.host, cfg.serve.port), Handler)


def drain_engine(engine: InferenceEngine, timeout_s: float) -> bool:
    """Wait, at most `timeout_s`, until every submitted request has its
    response or its error (admission has already stopped). False on the
    timeout: a wedged batcher."""
    deadline = time.monotonic() + max(float(timeout_s), 0.0)
    while True:
        s = engine.stats()
        if s["serve_requests"] <= s["serve_responses"] + s["serve_errors"]:
            return True
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.05)


def _timed(fn) -> tuple[object, float]:
    t0 = time.monotonic()
    out = fn()
    return out, round(time.monotonic() - t0, 4)


def _engine_for(cfg: ExperimentConfig, model, device,
                boot: dict | None = None) -> InferenceEngine:
    """The serving engine of `cfg`: the model given, else the newest
    checkpoint under `train.log_dir` that verifies; none with
    `serve.fake_exec_ms`. The boot's parts are timed into `boot`: the
    CUDA context and the libraries the engine launches first (on the
    card, for a model), then the restore and the engine."""
    import torch

    boot = {} if boot is None else boot
    cuda = (torch.device(device).type == "cuda"
            and cfg.serve.fake_exec_ms is None)
    boot["cuda_context_s"] = boot["library_load_s"] = None
    fetched = None
    if cuda:
        from ..ops.cuda import build

        def context():
            torch.empty(1, device=device)
            torch.cuda.synchronize(device)

        def libraries():
            # from the artifact store first (serve.artifacts_dir), then
            # built from source where it has none that passes its gates
            store = store_for_config(cfg, device)
            got = (store.fetch_libraries(serve_libraries(cfg))
                   if store is not None else None)
            for n in serve_libraries(cfg):
                build.load(n)
            return got

        _, boot["cuda_context_s"] = _timed(context)
        fetched, boot["library_load_s"] = _timed(libraries)
        if fetched is not None:
            boot["library_fetch"] = fetched
    boot["restore_s"] = None
    if model is None and cfg.serve.fake_exec_ms is None:
        from ..predict import restore_params

        model, boot["restore_s"] = _timed(
            lambda: restore_params(cfg, device=device))
    engine, boot["engine_s"] = _timed(
        lambda: InferenceEngine(cfg, model=model, device=device,
                                ledger_dir=cfg.train.log_dir,
                                library_fetch=fetched))
    return engine


def run_server(cfg: ExperimentConfig, engine: InferenceEngine | None = None,
               model=None, device="cuda", boot: dict | None = None) -> int:
    """`serve` in HTTP mode: engine, heartbeat, and serve_forever until
    SIGTERM (or ^C); returns the exit code. The first SIGTERM stops
    admission and drains the requests in flight within
    `serve.fleet.drain_timeout_s`; a second takes the default action, so
    a wedged drain stays killable. Prints one JSON line {"serving":
    "http://host:port", ...} once it listens, and appends a kind="serve"
    record of the final stats to `<log_dir>/metrics.jsonl`. `boot` holds
    the boot's parts timed before the call (`cli.main`'s torch import);
    a server that builds its engine adds the rest (module docstring)."""
    from ..obs.heartbeat import Heartbeat
    from ..ops.cuda.build import launch_counts

    tracer = None
    if cfg.obs.trace:
        tracer = obs_trace.Tracer(
            path=os.path.join(cfg.train.log_dir, "trace.json"),
            ring_size=cfg.obs.trace_ring, role=_role(),
            index=replica_index())
    own_engine = engine is None
    boot = dict(boot or {}) if own_engine else None
    with obs_trace.installed(tracer):
        if own_engine:
            engine = _engine_for(cfg, model, device, boot)
        install_replica_faults(engine, cfg)
        # the process's incident recorder (None unless obs.incidents):
        # the engine records its SLO and quality verdicts through it
        incidents = incident.install(cfg, cfg.train.log_dir, _role())
        engine.incidents = incidents
        warm, warm_s = _timed(engine.warm)
        if boot is not None:
            boot["warm_s"] = warm_s
        warm_launches = launch_counts()
        # the heartbeat's steps are flushes; with no work in flight the
        # clock is touched, so an idle endpoint is never a wedge
        hb_ref: dict = {}
        role = {"role": _role(), "replica": replica_index()}

        def sample() -> dict:
            s = engine.heartbeat_sample()
            if (s["serve_requests"] - s["serve_responses"]
                    - s["serve_errors"]) <= 0 and "hb" in hb_ref:
                hb_ref["hb"].touch()
            return {**role, **s}

        if incidents is not None:
            # the samples feed the recorder's ring and alert rules; a
            # wedge becomes a critical bundle with the stack dump
            sample = incidents.wrap_sample(sample)
        hb = Heartbeat(os.path.join(cfg.train.log_dir, "heartbeat.json"),
                       period_s=cfg.obs.heartbeat_period_s,
                       watchdog_factor=cfg.obs.watchdog_factor,
                       watchdog_min_s=cfg.obs.watchdog_min_s,
                       sample=sample, tracer=tracer,
                       on_wedge=(None if incidents is None else
                                 lambda dump: incidents.record(
                                     "watchdog_wedge", "critical",
                                     text_files={"stacks.txt": dump})),
                       device=None if engine._forward_custom
                       else engine.device)
        hb_ref["hb"] = hb
        engine.flush_hook = hb.beat
        try:
            httpd = build_server(cfg, engine)
        except BaseException:
            hb.close()  # a bind failure must not leak the heartbeat
            raise
        host, port = httpd.server_address[:2]
        if threading.current_thread() is threading.main_thread():
            def _on_term(signum, frame):
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                # shutdown() waits for serve_forever: from another thread
                threading.Thread(target=httpd.shutdown, daemon=True,
                                 name="serve-drain").start()

            signal.signal(signal.SIGTERM, _on_term)
        if boot is not None:
            age = process_age_s()
            boot["ready_s"] = None if age is None else round(age, 4)
        print(json.dumps({"serving": f"http://{host}:{port}",
                          "pid": os.getpid(),
                          "replica": replica_index(),
                          "buckets": [list(b) for b in engine.buckets],
                          "precisions": list(engine.tiers),
                          "max_batch": engine.max_batch,
                          "warm_s": round(sum(w["seconds"]
                                              for w in warm["buckets"]), 3),
                          **({"boot": boot} if boot is not None else {})}),
              flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()  # admission stopped
            drain_engine(engine, cfg.serve.fleet.drain_timeout_s)
            if own_engine:
                engine.close()
            now = launch_counts()
            _log_serve_summary(cfg, engine, kernel_launches={
                k: n - warm_launches.get(k, 0) for k, n in now.items()},
                **({"boot": boot} if boot is not None else {}))
            hb.close()
    return 0


def _log_serve_summary(cfg: ExperimentConfig, engine: InferenceEngine,
                       **extra) -> None:
    """Append one kind="serve" record (the final stats, and `extra`) to
    the run's metrics.jsonl."""
    try:
        os.makedirs(cfg.train.log_dir, exist_ok=True)
        rec = {"kind": "serve", "step": 0, "time": time.time(),
               "replica": replica_index(), **extra}
        rec.update(engine.stats())
        with open(os.path.join(cfg.train.log_dir, "metrics.jsonl"),
                  "a") as f:
            f.write(json.dumps(rec, allow_nan=False) + "\n")
    except OSError:
        pass  # a read-only log tree must not fail the serve exit


def _enumerate_pairs(input_path: str) -> list[tuple[str, str]]:
    """Consecutive pairs of a directory's frames, sorted by name."""
    names = sorted(n for n in os.listdir(input_path)
                   if n.lower().endswith(_IMAGE_EXTS))
    paths = [os.path.join(input_path, n) for n in names]
    if len(paths) < 2:
        raise SystemExit(f"offline serve: need >= 2 frames in "
                         f"{input_path!r}, found {len(paths)}")
    return list(zip(paths, paths[1:]))


def run_offline(cfg: ExperimentConfig, input_path: str, out_dir: str,
                write_png: bool = True, engine: InferenceEngine | None = None,
                model=None, device="cuda") -> dict:
    """`serve --input DIR --out OUT`: flow for every consecutive pair of
    the directory's frames, written as `<stem>_flow.flo` (and its PNG
    unless `write_png` is False). A frame that does not decode fails its
    pairs alone (a structured error line on stdout). Returns the summary
    the command prints."""
    from collections import deque

    from ..predict import write_outputs

    if os.path.isfile(input_path) \
            and input_path.lower().endswith(_VIDEO_EXTS):
        raise_unported([(f"serve --input {input_path!r} (a video file: "
                         "the JAX package decodes it with cv2."
                         "VideoCapture)", "8.4 (serving)")])
    pairs = _enumerate_pairs(input_path)
    os.makedirs(out_dir, exist_ok=True)
    own_engine = engine is None
    if own_engine:
        engine = _engine_for(cfg, model, device)
    t0 = time.perf_counter()
    written: list[str] = []
    n_pairs = n_err = 0
    try:
        engine.warm()
        submissions = _submit_directory(cfg, engine, pairs)
        # a bounded window of futures (a resolved one holds a native-size
        # flow): writes overlap the inference in flight
        window = max(4 * engine.max_batch, 16)
        buf: deque = deque()

        def drain_one() -> None:
            nonlocal n_err
            stem, fut = buf.popleft()
            try:
                flow = fut.result()["flow"]
            except ServeError as e:
                n_err += 1
                print(json.dumps({"request": stem, **e.payload()}),
                      flush=True)
                return
            written.extend(write_outputs(out_dir, stem, flow,
                                         write_png=write_png))

        try:
            for sub in submissions:
                n_pairs += 1
                buf.append(sub)
                if len(buf) >= window:
                    drain_one()
            while buf:
                drain_one()
        finally:
            submissions.close()  # releases the generator's pipeline
    finally:
        if own_engine:
            engine.close()
        _log_serve_summary(cfg, engine)
    wall = time.perf_counter() - t0
    stats = engine.stats()
    return {"pairs": n_pairs, "errors": n_err, "written": len(written),
            "wall_s": round(wall, 3),
            "pairs_per_s": (round((n_pairs - n_err) / wall, 3)
                            if wall > 0 else None),
            **{k: stats[k] for k in ("serve_batches", "serve_occupancy_mean",
                                     "serve_latency_p50_ms",
                                     "serve_latency_p99_ms")}}


def _submit_directory(cfg: ExperimentConfig, engine: InferenceEngine,
                      pairs: list[tuple[str, str]]):
    """Yield (stem, future) for the pairs: `data/pipeline.py` workers
    decode and preprocess rows (delivered in order), a Prefetcher keeps
    some ready ahead of the submit loop, and the engine batches them. A
    pair whose decode fails becomes a structured error of its own."""
    from ..data.datasets import _imread_bgr
    from ..data.pipeline import InputPipeline
    from ..data.prefetch import Prefetcher
    from ..predict import output_stem
    from .buckets import pick_bucket, prepare_pair

    def make_row(i: int) -> dict:
        # workers run ahead of the delivery cursor: indices past the
        # pairs are cheap padding, staged and never read
        if i >= len(pairs):
            return {"pad": True}
        src, tgt = pairs[i]
        try:
            prev = _imread_bgr(src)
            nxt = _imread_bgr(tgt)
            native_hw = (prev.shape[0], prev.shape[1])
            bucket = pick_bucket(native_hw, engine.buckets)
            return {"x": prepare_pair(prev, nxt, bucket, engine.mean),
                    "bucket": bucket, "native_hw": native_hw}
        except Exception as e:  # noqa: BLE001 - one pair's failure
            return {"error": f"{type(e).__name__}: {e}"}

    pipeline = InputPipeline(make_row, num_workers=max(int(cfg.serve.workers),
                                                       0),
                             retries=cfg.resilience.pipeline_retries)
    prefetch = Prefetcher(pipeline.get, depth=max(cfg.data.prefetch, 1))
    try:
        for i, (src, _) in enumerate(pairs):
            row = prefetch.get()
            stem = output_stem(src, i, True)
            if "error" in row:
                fut: Future = Future()
                fut.set_exception(ServeError("bad_input", row["error"], i))
                yield stem, fut
                continue
            yield stem, engine.submit_prepared(row["x"], row["bucket"],
                                               row["native_hw"])
    finally:
        # the pipeline first: the prefetch thread may wait in its get()
        pipeline.close()
        prefetch.close()
