"""The port's HTTP server (`serve/server.py`) against the JAX package's
`build_server`, side by side on port 0, and the engine's serving plane
(deadlines, the brownout fold, the stats) against the JAX engine's.

Two pairs of engines:
  - the same small FlowNet-C (width 0.25, correlation 4 / 1) in each
    package, from the same weights carried over by `convert.py`: PNG
    pairs at the bucket's size (written by the port's `io/png.py`, read
    by cv2 on the JAX side and by the port's decoder) give flows within
    atol 1e-4 and rtol 1e-4, `test_torch_serve.py`'s tolerance (float32
    convolutions sum in another order in XLA and in PyTorch);
  - each package's timed stand-in executor (`make_fake_forward`: the
    flow is the pair's channel differences), for everything that
    compares no model: at the bucket's size both prepare and postprocess
    the same bits, so the `.flo` bytes are compared exactly, as are the
    status codes, the stream protocol, the deadline and fold counters,
    the /healthz keys and the offline mode's files.
"""

import base64
import dataclasses
import http.client
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")  # the JAX server's decode

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.serve import server as jax_server
from deepof_tpu.serve.engine import InferenceEngine as JaxEngine
from deepof_tpu.serve.engine import make_fake_forward as jax_fake
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.io.png import png_bytes, write_png
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.obs.export import parse_prometheus
from deepof_tpu_torch.serve import server
from deepof_tpu_torch.serve.engine import InferenceEngine, ServeError

BUCKET = (64, 128)
#: the stats block of the JAX plane the port does not have (the ledger)
ABSENT = ("exec_",)


def _jax_cfg(log_dir, fake=None, max_batch=4, timeout_ms=50.0, **serve_kw):
    cfg = JaxConfig()
    session = dataclasses.replace(cfg.serve.session,
                                  **serve_kw.pop("session", {}))
    return cfg.replace(
        model="flownet_c", width_mult=0.25, corr_max_disp=4, corr_stride=1,
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 image_size=BUCKET, gt_size=BUCKET),
        serve=dataclasses.replace(cfg.serve, max_batch=max_batch,
                                  batch_timeout_ms=timeout_ms,
                                  host="127.0.0.1", port=0,
                                  fake_exec_ms=fake, session=session,
                                  **serve_kw),
        train=dataclasses.replace(cfg.train, log_dir=str(log_dir)))


def _port_cfg(jcfg):
    with pytest.warns(UserWarning, match="ignored keys"):
        return config_from_dict(dataclasses.asdict(jcfg))


def _img(rs, hw=BUCKET):
    return rs.randint(0, 256, (*hw, 3), dtype=np.uint8)


def _b64(img):
    return base64.b64encode(png_bytes(img)).decode()


def _start(build, cfg, engine):
    httpd = build(cfg, engine)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


class _Client:
    """A connection a request: a server that answers an unknown path
    leaves its body unread, which ends a kept-alive connection."""

    def __init__(self, httpd):
        self.address = httpd.server_address[:2]

    def __call__(self, method, path, body=None, headers=None):
        conn = http.client.HTTPConnection(*self.address, timeout=60)
        conn.request(method, path, None if body is None else json.dumps(body),
                     headers or {})
        resp = conn.getresponse()
        data = resp.read()
        conn.close()
        ctype = resp.getheader("Content-Type")
        if ctype == "application/json":
            data = json.loads(data)
        return resp.status, ctype, data


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX server, port server) over engines of each kind: "model" (the
    same small FlowNet-C) and "fake" (the stand-in executors)."""
    root = tmp_path_factory.mktemp("server")
    rs = np.random.RandomState(2)
    jm = jax_build_model("flownet_c", width_mult=0.25, corr_max_disp=4,
                         corr_stride=1)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, *BUCKET, 6)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * (0.1 if a.ndim == 1 else
                   1.0 / np.sqrt(np.prod(a.shape[:-1])))).astype(np.float32),
        params)
    model = build_model("flownet_c", width_mult=0.25, corr_max_disp=4,
                        corr_stride=1, device="cpu")
    load_flax_params(model, params)
    out, engines, httpds = {}, [], []
    for kind in ("model", "fake"):
        jcfg = _jax_cfg(root / kind, fake=0.0 if kind == "fake" else None,
                        session={"ttl_s": 1.0, "sweep_s": 0.0,
                                 "warm_start": kind == "fake"})
        cfg = _port_cfg(jcfg)
        if kind == "model":
            jeng = JaxEngine(jcfg, model_params=(jm, params))
            eng = InferenceEngine(cfg, model=model, device="cpu")
        else:
            jeng = JaxEngine(jcfg)
            eng = InferenceEngine(cfg, device="cpu")
        engines += [jeng, eng]
        pair = (_start(jax_server.build_server, jcfg, jeng),
                _start(server.build_server, cfg, eng))
        httpds += pair
        out[kind] = {"clients": tuple(_Client(h) for h in pair),
                     "engines": (jeng, eng), "cfg": (jcfg, cfg)}
    yield out
    for h in httpds:
        h.shutdown()
        h.server_close()
    for e in engines:
        e.close()


def test_flows_over_http_match_the_jax_server(servers):
    want_c, got_c = servers["model"]["clients"]
    rs = np.random.RandomState(3)
    for _ in range(3):
        body = {"prev": _b64(_img(rs)), "next": _b64(_img(rs))}
        (ws, _, w), (gs, _, g) = want_c("POST", "/v1/flow", body), \
            got_c("POST", "/v1/flow", body)
        assert ws == gs == 200
        for key in ("shape", "bucket", "precision", "native_hw"):
            assert g[key] == w[key], key
        flow = lambda p: np.frombuffer(  # noqa: E731
            base64.b64decode(p["flow_b64"]), "<f4").reshape(p["shape"])
        np.testing.assert_allclose(flow(g), flow(w), atol=1e-4, rtol=1e-4)


def test_flo_bytes_png_pixels_and_status_codes_equal_jax(servers):
    want_c, got_c = servers["fake"]["clients"]
    rs = np.random.RandomState(4)
    pair = {"prev": _b64(_img(rs)), "next": _b64(_img(rs))}
    w, g = (want_c("POST", "/v1/flow", {**pair, "format": "flo"}),
            got_c("POST", "/v1/flow", {**pair, "format": "flo"}))
    assert w[:2] == g[:2] == (200, "application/octet-stream")
    assert g[2] == w[2]  # the same .flo bytes
    w, g = (want_c("POST", "/v1/flow", {**pair, "format": "png"}),
            got_c("POST", "/v1/flow", {**pair, "format": "png"}))
    assert w[:2] == g[:2] == (200, "image/png")
    decode = lambda b: cv2.imdecode(np.frombuffer(b, np.uint8),  # noqa: E731
                                    cv2.IMREAD_COLOR)
    assert np.array_equal(decode(g[2]), decode(w[2]))
    for method, path, body, want in (
            ("POST", "/v1/flow", {"prev": "!!!", "next": "!!!"}, 400),
            ("POST", "/v1/flow", {**pair, "format": "gif"}, 400),
            ("POST", "/v1/flow", {**pair, "precision": "int4"}, 400),
            ("POST", "/v1/flow", {"prev": base64.b64encode(
                b"not an image").decode(), "next": pair["next"]}, 400),
            ("POST", "/v1/nothing", pair, 404),
            ("GET", "/nothing", None, 404),
            ("POST", "/v1/flow/stream", {"frame": pair["prev"]}, 400),
            ("POST", "/v1/flow/stream", {"session": "a/b",
                                         "frame": pair["prev"]}, 400)):
        (ws, _, wb), (gs, _, gb) = (want_c(method, path, body),
                                    got_c(method, path, body))
        assert ws == gs == want, (path, body and list(body))
        assert gb["error"] == wb["error"], (path, wb, gb)


def test_the_stream_protocol_equals_jax(servers):
    want_c, got_c = servers["fake"]["clients"]
    rs = np.random.RandomState(5)
    frames = [_b64(_img(rs)) for _ in range(4)]

    def walk(client):
        out = []
        for i, f in enumerate(frames):
            s, _, body = client("POST", "/v1/flow/stream",
                                {"session": "v1", "frame": f})
            out.append((s, body.get("frame_index"), body.get("warm"),
                        body.get("flow_b64")))
        out.append(client("DELETE", "/v1/flow/stream/v1")[0])
        out.append(client("DELETE", "/v1/flow/stream/v1")[0])
        # idle past the TTL (1 s, checked on access): 410, then re-primed
        client("POST", "/v1/flow/stream", {"session": "v2",
                                           "frame": frames[0]})
        time.sleep(1.3)
        out.append(client("POST", "/v1/flow/stream",
                          {"session": "v2", "frame": frames[1]})[0])
        out.append(client("POST", "/v1/flow/stream",
                          {"session": "v2", "frame": frames[1]})[0])
        return out

    got, want = walk(got_c), walk(want_c)
    assert got == want
    assert [g[0] for g in got[:4]] == [202, 200, 200, 200]
    assert [g[2] for g in got[1:4]] == [False, True, True]  # warm after one
    assert got[4:] == [200, 404, 410, 202]


def test_deadlines_fail_at_the_enqueue_and_the_flush_as_in_jax(tmp_path):
    """As `tests/test_degrade.py`: a budget that lapses in the batch
    window fails at the flush and takes no slot; one that lapses waiting
    for a queue slot fails at the enqueue. Neither burns the SLO's error
    budget."""
    rs = np.random.RandomState(6)
    out = {}
    for name, make in (("jax", JaxEngine), ("port", InferenceEngine)):
        for gate in ("flush", "enqueue"):
            # budgets far above a request's preprocessing on a loaded
            # host, so each lapses at the gate it is meant to
            kw = ({"max_batch": 4, "timeout_ms": 600.0} if gate == "flush"
                  else {"max_batch": 1, "timeout_ms": 1.0, "queue_depth": 1})
            jcfg = _jax_cfg(tmp_path, **kw)
            cfg = jcfg if name == "jax" else _port_cfg(jcfg)
            calls = []

            def fwd(bucket, x, _f=jax_fake(500.0 if gate == "enqueue"
                                           else 0.0)):
                calls.append(1)
                return _f(bucket, x)

            dev = {} if name == "jax" else {"device": "cpu"}
            with make(cfg, forward_fn=fwd, **dev) as eng:
                a, b = _img(rs), _img(rs)
                if gate == "flush":
                    fut = eng.submit(a, b, deadline_s=0.1)
                else:
                    first = eng.submit(a, b)  # dispatched, executor busy
                    time.sleep(0.1)
                    second = eng.submit(a, b)  # fills the queue
                    fut = eng.submit(a, b, deadline_s=0.1)
                with pytest.raises(ServeError if name == "port"
                                   else Exception) as ei:
                    fut.result(timeout=10)
                assert ei.value.code == "deadline_exceeded"
                if gate == "enqueue":
                    first.result(timeout=10)
                    second.result(timeout=10)
                s = eng.stats()
                out[name, gate] = ({k: s[k] for k in s
                                    if k.startswith("deadline_")},
                                   s["serve_server_errors"],
                                   len(calls) if gate == "flush" else None)
    for gate in ("flush", "enqueue"):
        assert out["port", gate] == out["jax", gate], gate
    assert out["port", "flush"][0]["deadline_flush_expired"] == 1
    assert out["port", "flush"][2] == 0  # no dispatch for it
    assert out["port", "enqueue"][0]["deadline_enqueue_expired"] == 1
    assert out["port", "flush"][1] == out["port", "enqueue"][1] == 0


def test_a_lapsed_deadline_over_http_is_a_504_as_in_jax(tmp_path):
    rs = np.random.RandomState(7)
    jcfg = _jax_cfg(tmp_path, timeout_ms=600.0)
    got = []
    for build, make, cfg, dev in (
            (jax_server.build_server, JaxEngine, jcfg, {}),
            (server.build_server, InferenceEngine, _port_cfg(jcfg),
             {"device": "cpu"})):
        with make(cfg, forward_fn=jax_fake(0.0), **dev) as eng:
            httpd = _start(build, cfg, eng)
            try:
                status, _, body = _Client(httpd)(
                    "POST", "/v1/flow", {"prev": _b64(_img(rs)),
                                         "next": _b64(_img(rs))},
                    {"X-Deadline-Ms": "100", "X-Request-Id": "r-1"})
                time.sleep(1.0)  # the batch window closes: the flush gate
                s = eng.stats()
            finally:
                httpd.shutdown()
                httpd.server_close()
        got.append((status, body["error"], body.get("request_id"),
                    s["deadline_wait_expired"], s["deadline_flush_expired"],
                    s["serve_server_errors"]))
    assert got[0] == got[1] == (504, "deadline_exceeded", "r-1", 1, 1, 0)


def test_the_degrade_level_folds_tier_and_bucket_as_in_jax(tmp_path):
    rs = np.random.RandomState(8)
    jcfg = _jax_cfg(tmp_path, max_batch=1, timeout_ms=5.0,
                    buckets=((16, 32), (32, 64)), precisions=("f32", "bf16"))
    a, b = _img(rs, (30, 60)), _img(rs, (30, 60))
    got = []
    for make, cfg, dev in ((JaxEngine, jcfg, {}),
                           (InferenceEngine, _port_cfg(jcfg),
                            {"device": "cpu"})):
        with make(cfg, forward_fn=jax_fake(0.0), **dev) as eng:
            rows = [eng.submit(a, b, degrade_level=lvl).result(timeout=10)
                    for lvl in (0, 1, 2)]
            rows.append(eng.submit(a, b, precision="f32",
                                   degrade_level=2).result(timeout=10))
            s = eng.stats()
        got.append(([(r["precision"], tuple(r["bucket"])) for r in rows],
                    s["degrade_tier_downgrades"],
                    s["degrade_bucket_downgrades"]))
    assert got[0] == got[1]
    assert got[1] == ([("f32", (32, 64)), ("bf16", (32, 64)),
                           ("bf16", (16, 32)), ("f32", (16, 32))], 2, 2)


def test_healthz_and_metrics_carry_the_jax_keys(servers):
    want_c, got_c = servers["fake"]["clients"]
    (ws, _, w), (gs, _, g) = want_c("GET", "/healthz"), got_c("GET",
                                                             "/healthz")
    assert ws == gs == 200
    want = {k for k in w if not k.startswith(ABSENT)}
    assert set(g) == want
    (_, wt, wm), (_, gt, gm) = want_c("GET", "/metrics"), got_c("GET",
                                                               "/metrics")
    assert gt == wt
    names = lambda text: {k.split("{")[0]  # noqa: E731
                          for k in parse_prometheus(text.decode())}
    assert names(gm) == {n for n in names(wm)
                         if not n.startswith(tuple(f"deepof_{a}"
                                                   for a in ABSENT))}
    assert "deepof_serve_latency_ms_count" in names(gm)


def test_the_slo_state_rides_the_stats(tmp_path):
    jcfg = _jax_cfg(tmp_path, max_batch=1, timeout_ms=1.0)
    jcfg = jcfg.replace(obs=dataclasses.replace(jcfg.obs, slo_latency_ms=1.0,
                                                slo_error_budget=0.5))
    with InferenceEngine(_port_cfg(jcfg), forward_fn=jax_fake(5.0),
                         device="cpu") as eng:
        rs = np.random.RandomState(9)
        for _ in range(3):
            eng.submit(_img(rs), _img(rs)).result(timeout=10)
        s = eng.stats()
    assert s["serve_slo"]["requests"] == 3
    assert s["serve_slo"]["breaches"] == 3 and s["serve_slo"]["exhausted"]
    assert s["serve_latency_p50_ms"] >= 4.0  # read off the buckets
    with pytest.raises(ValueError, match="slo_latency_ms"):
        InferenceEngine(_port_cfg(jcfg.replace(obs=dataclasses.replace(
            jcfg.obs, slo_latency_ms=1e6))), forward_fn=jax_fake(0.0),
            device="cpu")


def test_offline_mode_with_a_corrupt_frame_equals_jax(tmp_path, capsys):
    """As `tests/test_serve.py`: the consecutive pairs of a directory
    through the worker pool; a corrupt frame fails only its two pairs,
    and the other pairs' `.flo` files equal the JAX server's."""
    rs = np.random.RandomState(10)
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(5):
        write_png(frames / f"f{i:03d}.png", _img(rs))  # the bucket's size
    (frames / "f002.png").write_bytes(b"garbage bytes")
    jcfg = _jax_cfg(tmp_path / "jax", workers=2)
    results = {}
    for name, run, make, cfg, dev in (
            ("jax", jax_server.run_offline, JaxEngine, jcfg, {}),
            ("port", server.run_offline, InferenceEngine,
             _port_cfg(jcfg.replace(train=dataclasses.replace(
                 jcfg.train, log_dir=str(tmp_path / "port")))),
             {"device": "cpu"})):
        out = tmp_path / f"out_{name}"
        with make(cfg, forward_fn=jax_fake(0.0), **dev) as eng:
            res = run(cfg, str(frames), str(out), write_png=False,
                      engine=eng)
        files = sorted(os.listdir(out))
        results[name] = (res["pairs"], res["errors"], res["written"], files,
                         [(out / f).read_bytes() for f in files])
        lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
                 if "bad_input" in ln]
        assert len(lines) == 2
        recs = [json.loads(ln) for ln in open(
            os.path.join(cfg.train.log_dir, "metrics.jsonl"))]
        assert any(r.get("kind") == "serve" for r in recs)
    assert results["port"] == results["jax"]
    assert results["port"][:4] == (4, 2, 2, ["0000_f000_flow.flo",
                                             "0003_f003_flow.flo"])
    with pytest.raises(NotImplementedError, match="VideoCapture"):
        video = tmp_path / "clip.mp4"
        video.write_bytes(b"")
        server.run_offline(_port_cfg(jcfg), str(video), str(tmp_path / "v"),
                           engine=object())


def test_a_codec_the_build_lacks_is_a_400_naming_its_codecs(
        servers, monkeypatch):
    """The card's machine links PPM only: there a JPEG request is a 400
    `bad_input` naming the codecs, and a PNG still decodes (through
    `io/png.py`), the same pixels as the native decoder's."""
    from deepof_tpu_torch import native

    _, got_c = servers["fake"]["clients"]
    rs = np.random.RandomState(11)
    a, b = _img(rs), _img(rs)
    pair = {"prev": _b64(a), "next": _b64(b)}
    want = got_c("POST", "/v1/flow", {**pair, "format": "flo"})
    monkeypatch.setattr(native, "codecs", lambda: frozenset({"ppm"}))
    ok, jpg = cv2.imencode(".jpg", a)
    status, _, body = got_c("POST", "/v1/flow", {
        "prev": base64.b64encode(jpg.tobytes()).decode(),
        "next": pair["next"]})
    assert status == 400 and body["error"] == "bad_input"
    assert "jpeg" in body["message"] and "['ppm']" in body["message"]
    assert got_c("POST", "/v1/flow", {**pair, "format": "flo"}) == want


def test_the_serving_keys_are_carried_and_the_fleet_refused(tmp_path):
    """F7 for the serving keys: the server's, the SLO's, the fleet's,
    the brownout controller's and the artifact store's are carried with
    the JAX defaults (the fleet and the store are ported), and so is
    `obs.metrics_port` (the elastic coordinator's); no fleet or store
    setting is refused by `check_servable` or the engine."""
    from deepof_tpu_torch.core.config import check_servable

    jcfg = _jax_cfg(tmp_path)
    with pytest.warns(UserWarning, match="ignored keys") as rec:
        cfg = config_from_dict(dataclasses.asdict(JaxConfig()))
    ignored = str(rec[0].message)
    for key in ("serve.host", "serve.port", "serve.request_timeout_s",
                "serve.workers", "serve.fake_exec_ms", "obs.slo_latency_ms",
                "obs.slo_error_budget", "serve.fleet.drain_timeout_s",
                "serve.fleet.replicas", "serve.fleet.autoscale",
                "serve.fleet.max_in_flight", "serve.degrade",
                "serve.artifacts_dir", "serve.artifacts_index",
                "serve.artifacts_deep_verify", "serve.deep_verify_interval_s",
                "serve.fleet.artifacts_gc_days"):
        assert f"'{key}" not in ignored, key
    assert "'obs.metrics_port'" not in ignored
    assert cfg.obs.metrics_port is None
    want = JaxConfig()
    assert (cfg.serve.artifacts_dir, cfg.serve.artifacts_index,
            cfg.serve.artifacts_deep_verify, cfg.serve.deep_verify_interval_s,
            cfg.serve.fleet.artifacts_gc_days) == (
        want.serve.artifacts_dir, want.serve.artifacts_index,
        want.serve.artifacts_deep_verify, want.serve.deep_verify_interval_s,
        want.serve.fleet.artifacts_gc_days)
    assert (cfg.serve.host, cfg.serve.port, cfg.serve.request_timeout_s,
            cfg.serve.workers, cfg.serve.fake_exec_ms) == (
        want.serve.host, want.serve.port, want.serve.request_timeout_s,
        want.serve.workers, want.serve.fake_exec_ms)
    assert (cfg.obs.slo_latency_ms, cfg.obs.slo_error_budget,
            cfg.serve.fleet.drain_timeout_s) == (
        want.obs.slo_latency_ms, want.obs.slo_error_budget,
        want.serve.fleet.drain_timeout_s)
    assert dataclasses.asdict(cfg.serve.degrade) \
        == dataclasses.asdict(want.serve.degrade)
    for fleet_kw, serve_kw in (({"replicas": 2}, {}),
                               ({"autoscale": True}, {}),
                               ({"artifacts_gc_days": 3.0},
                                {"artifacts_dir": str(tmp_path / "exec")})):
        cfg = _port_cfg(jcfg.replace(serve=dataclasses.replace(
            jcfg.serve, fleet=dataclasses.replace(jcfg.serve.fleet,
                                                  **fleet_kw),
            **serve_kw)))
        check_servable(cfg)
        InferenceEngine(cfg, forward_fn=jax_fake(0.0), device="cpu").close()
