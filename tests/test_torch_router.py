"""The port's fleet router (`serve/router.py`) against the JAX package's
`Router`, on the same inputs: the header probe, the (bucket x tier)
affinity map and the brownout fold of the affinity key, and each routing
policy driven against the same stub replica HTTP servers — spill and the
503 shed, failover replay and its structured 502/503, scale-down aging
with the sticky-session demotion, and the fleet scrape — with the same
statuses, error codes and stats blocks (the latency histogram and the
load trend left out: they read the clock). Then the router's own HTTP
front (`build_router_server`): /healthz, /metrics, POST and the drain."""

import http.client
import json
import threading
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")  # the JAX side's encoders

from deepof_tpu.serve import router as jax_router
from deepof_tpu_torch.io.png import png_bytes
from deepof_tpu_torch.io.ppm import write_ppm_bgr
from deepof_tpu_torch.obs.export import LatencyHistogram, parse_prometheus
from deepof_tpu_torch.serve import router
from torch_fleet_stubs import (StubFleet, both_configs, flow_body, stop,
                               stub_replica)

#: stats keys that read the clock (latency, load trend)
CLOCKED = ("fleet_latency_hist", "fleet_load_rps", "fleet_load_slope")


def _stats(r) -> dict:
    return {k: v for k, v in r.stats().items() if k not in CLOCKED}


# ------------------------------------------------------------ the probe


def _probe_cases():
    rs = np.random.RandomState(0)
    img = rs.randint(0, 255, (48, 96, 3), dtype=np.uint8)
    enc = {ext: cv2.imencode(ext, img)[1].tobytes()
           for ext in (".png", ".jpg", ".bmp")}
    return [
        ("png_port", png_bytes(img), (48, 96)),
        ("png_cv2", enc[".png"], (48, 96)),
        ("jpeg", enc[".jpg"], (48, 96)),
        ("bmp", enc[".bmp"], (48, 96)),
        # the router only ever reads a prefix of the payload
        ("png_prefix", enc[".png"][:64], (48, 96)),
        ("jpeg_torn", enc[".jpg"][:12], None),
        ("garbage", b"not an image", None),
        ("empty", b"", None),
    ]


@pytest.mark.parametrize("name,data,want", _probe_cases(),
                         ids=[c[0] for c in _probe_cases()])
def test_probe_image_hw_equals_jax(name, data, want):
    assert router.probe_image_hw(data) == jax_router.probe_image_hw(data) \
        == want


def test_probe_reads_ppm_headers(tmp_path):
    """PPM is the port's own addition (its decoder reads PPM on every
    host): the written header, a commented one, an ASCII P3 and torn
    ones."""
    img = np.zeros((7, 12, 3), np.uint8)
    write_ppm_bgr(tmp_path / "a.ppm", img)
    data = (tmp_path / "a.ppm").read_bytes()
    assert router.probe_image_hw(data) == (7, 12)
    assert router.probe_image_hw(b"P6\n# made here\n640 480\n255\n") \
        == (480, 640)
    assert router.probe_image_hw(b"P3 5 3 255 0 0 0") == (3, 5)
    for torn in (b"P6", b"P6 64", b"P6 64 4", b"P6 x 4 255 "):
        assert router.probe_image_hw(torn) is None, torn


# ------------------------------------------------------- affinity map


BUCKETS = ((32, 64), (64, 64), (96, 128))
TIERS = ("f32", "bf16", "int8")


def test_affinity_map_over_the_bucket_tier_ladder_equals_jax(tmp_path):
    jcfg, pcfg = both_configs(tmp_path, serve=dict(buckets=BUCKETS,
                                                   precisions=TIERS))
    for n in (1, 2, 3, 4, 5):
        fleet = StubFleet([None] * n)
        got = router.Router(pcfg, fleet)
        want = jax_router.Router(jcfg, fleet)
        keys = [(b, t) for b in BUCKETS for t in TIERS]
        assert [got._preferred(k) for k in keys] \
            == [want._preferred(k) for k in keys]
        # the flattened ladder spreads every replica's slice
        assert sorted({got._preferred(k) for k in keys}) == list(range(n))


def test_affinity_key_and_its_brownout_fold_equal_jax(tmp_path):
    jcfg, pcfg = both_configs(tmp_path, serve=dict(buckets=BUCKETS,
                                                   precisions=TIERS))
    fleet = StubFleet([None, None])
    got, want = router.Router(pcfg, fleet), jax_router.Router(jcfg, fleet)
    rs = np.random.RandomState(1)
    for hw in ((30, 60), (64, 64), (90, 120), (200, 300)):
        for extra in ({}, {"precision": "bf16"}, {"precision": "bogus"}):
            req = json.loads(flow_body(rs, hw, **extra))
            for level in (0, 1, 2, 3):
                assert got._key_from(req, level=level) \
                    == want._key_from(req, level=level), (hw, extra, level)
    assert got._key_from(None) is None and got._key_from({}) is None
    # L2 at the smallest bucket stays there; L1 names the cheapest tier
    req = json.loads(flow_body(rs, (30, 60)))
    assert got._key_from(req, level=2) == ((32, 64), "int8")


# ------------------------------------------------- routing scenarios


def _affinity(rcls, cfg, rs):
    """Bucket i of the ladder routes to replica i % N while idle."""
    s0, s1 = stub_replica(), stub_replica()
    try:
        fleet = StubFleet([s0.server_address[1], s1.server_address[1]])
        r = rcls(cfg, fleet)
        served = []
        for hw in [(30, 60)] * 3 + [(60, 60)] * 3:
            status, payload, _ = r.handle_flow(
                "/v1/flow", flow_body(rs, hw), "application/json")
            served.append((status, [s0, s1].index(next(
                s for s in (s0, s1) if s.server_address[1]
                == json.loads(payload)["served_by"]))))
        return served, _stats(r)
    finally:
        stop(s0, s1)


def _spill_and_shed(rcls, cfg, rs):
    """Every replica at max_in_flight: the third request is a structured
    503 overloaded, after the second spilled past the affinity
    replica."""
    slow = [stub_replica(delay_s=0.8), stub_replica(delay_s=0.8)]
    try:
        fleet = StubFleet([s.server_address[1] for s in slow])
        r = rcls(cfg, fleet)
        body = flow_body(rs)
        results = [None] * 3

        def call(i):
            results[i] = r.handle_flow("/v1/flow", body, "application/json")

        threads = []
        for i in range(3):
            t = threading.Thread(target=call, args=(i,))
            t.start()
            threads.append(t)
            time.sleep(0.2)
        for t in threads:
            t.join(timeout=30)
        return ([(s, json.loads(p).get("error")) for s, p, _ in results],
                _stats(r))
    finally:
        stop(*slow)


def _failover(rcls, cfg, rs):
    """A dead replica's request replays on the live sibling; every
    replica dead is a structured 502 after bounded retries; none ready is
    a 503 unavailable."""
    from conftest import free_port

    live = stub_replica()
    try:
        out = []
        fleet = StubFleet([free_port(), live.server_address[1]])
        r = rcls(cfg, fleet)
        status, payload, _ = r.handle_flow("/v1/flow", flow_body(rs),
                                           "application/json")
        out.append((status, json.loads(payload)["served_by"]
                    == live.server_address[1], fleet.failures))
        dead = rcls(cfg, StubFleet([free_port(), free_port()]))
        status, payload, _ = dead.handle_flow("/v1/flow", flow_body(rs),
                                              "application/json")
        err = json.loads(payload)
        out.append((status, err["error"], err["attempts"]))
        none = rcls(cfg, StubFleet([None, None]))
        status, payload, _ = none.handle_flow("/v1/flow", flow_body(rs),
                                              "application/json")
        out.append((status, json.loads(payload)["error"]))
        return out, [_stats(r), _stats(dead), _stats(none)]
    finally:
        stop(live)


def _replica_5xx_replays(rcls, cfg, rs):
    """A replica's 500 replays on the sibling and pokes the supervisor."""
    bad = stub_replica(status=500, payload={"error": "dispatch_failed"})
    good = stub_replica()
    try:
        fleet = StubFleet([bad.server_address[1], good.server_address[1]])
        r = rcls(cfg, fleet)
        status, _, _ = r.handle_flow("/v1/flow", flow_body(rs),
                                     "application/json")
        return (status, fleet.failures), _stats(r)
    finally:
        stop(bad, good)


def _retire_slot(rcls, cfg, rs):
    """Scale-down aging: the retired slot leaves the per-index maps (its
    routed count folds into fleet_routed_retired), and a session pinned
    there demotes to 410 session_lost on its next frame, then re-primes
    on the survivor."""
    stub = stub_replica()
    try:
        port = stub.server_address[1]
        fleet = StubFleet([port, port])
        r = rcls(cfg, fleet)
        frame = json.dumps({"session": "s1", "frame": ""}).encode()
        out = [r.handle_flow("/v1/flow/stream", frame,
                             "application/json")[0]]
        pinned = next(int(k.split("-")[1]) for k, n
                      in r.stats()["fleet_routed"].items() if n)
        fleet.retire(pinned)
        r.retire_slot(pinned)
        r._release(pinned)  # a late release must not resurrect the slot
        before = _stats(r)
        status, payload, _ = r.handle_flow("/v1/flow/stream", frame,
                                           "application/json")
        out += [status, json.loads(payload)["error"]]
        out.append(r.handle_flow("/v1/flow/stream", frame,
                                 "application/json")[0])
        out.append(r.handle_session_delete("/v1/flow/stream/s1")[0])
        out.append(r.handle_session_delete("/v1/flow/stream/s1")[0])
        return out, [before, _stats(r)]
    finally:
        stop(stub)


SCENARIOS = {
    "affinity": (_affinity, dict(serve=dict(buckets=((32, 64), (64, 64))))),
    "spill_and_shed": (_spill_and_shed,
                       dict(fleet=dict(max_in_flight=1, spill_in_flight=1))),
    "failover": (_failover, dict(fleet=dict(proxy_timeout_s=2.0))),
    "replica_5xx": (_replica_5xx_replays, {}),
    "retire_slot": (_retire_slot, {}),
}
WANT = {
    "affinity": [(200, 0)] * 3 + [(200, 1)] * 3,
    "spill_and_shed": [(200, None), (200, None), (503, "overloaded")],
    "failover": [(200, True, [0]), (502, "replica_failed", 2),
                 (503, "unavailable")],
    "replica_5xx": (200, [0]),
    "retire_slot": [200, 410, "session_lost", 200, 200, 404],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_routing_scenario_equals_jax(name, tmp_path):
    fn, kw = SCENARIOS[name]
    jcfg, pcfg = both_configs(tmp_path, **kw)
    got, got_stats = fn(router.Router, pcfg, np.random.RandomState(2))
    want, want_stats = fn(jax_router.Router, jcfg,
                          np.random.RandomState(2))
    if name == "spill_and_shed":  # thread arrival order, not policy
        got, want = sorted(got, key=str), sorted(want, key=str)
    assert got == want
    assert got == (sorted(WANT[name], key=str)
                   if name == "spill_and_shed" else WANT[name])
    assert got_stats == want_stats


# -------------------------------------------------------- the scrape


def _healthz(rs, n):
    h = LatencyHistogram()
    for v in rs.uniform(0.001, 0.5, n):
        h.observe(float(v))
    return {"serve_requests": n, "serve_responses": n - 1,
            "serve_max_queue_depth": int(n), "serve_max_batch": 8,
            "serve_responses_by_tier": {"f32": n - 1},
            "serve_latency_hist": h.snapshot(),
            "serve_latency_p50_ms": 3.0, "deadline_requests": 2,
            "degrade_tier_downgrades": 1, "fleet_ignored": 5,
            "serve_some_new_counter": 4}


def test_scrape_merges_by_declared_kind_as_jax(tmp_path):
    rs = np.random.RandomState(3)
    reps = [stub_replica(healthz=_healthz(rs, n)) for n in (5, 9)]
    jcfg, pcfg = both_configs(tmp_path)
    try:
        fleet = StubFleet([s.server_address[1] for s in reps])
        got = router.Router(pcfg, fleet).scrape_replicas()
        want = jax_router.Router(jcfg, fleet).scrape_replicas()
    finally:
        stop(*reps)
    assert got == want
    assert got["serve_requests"] == 14 and got["serve_max_queue_depth"] == 9
    assert got["serve_replicas_scraped"] == 2
    assert "serve_max_batch" not in got  # a gauge is never summed
    assert got["serve_latency_hist"]["count"] == 14


# ------------------------------------------------ the router's own front


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post(port, body, path="/v1/flow"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body, {"Content-Type":
                                          "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_router_server_healthz_metrics_post_and_drain(tmp_path):
    rs = np.random.RandomState(4)
    stub = stub_replica(healthz=_healthz(rs, 3))
    _, pcfg = both_configs(tmp_path)
    fleet = StubFleet([stub.server_address[1]])
    r = router.Router(pcfg, fleet)
    httpd = router.build_router_server(pcfg, r)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    port = httpd.server_address[1]
    try:
        assert _post(port, flow_body(rs))[0] == 200
        assert _post(port, flow_body(rs), "/nope")[0] == 404
        status, body = _get(port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["fleet_responses"] == 1
        assert health["fleet_ready"] == 1 and health["replicas"] == []
        status, body = _get(port, "/metrics")
        parsed = parse_prometheus(body.decode())
        assert status == 200
        assert parsed["deepof_fleet_responses"] == 1
        assert parsed["deepof_serve_requests"] == 3  # the replica scrape
        r.draining = True
        status, payload = _post(port, flow_body(rs))
        assert status == 503 and payload["error"] == "draining"
        assert _get(port, "/healthz")[0] == 503
    finally:
        httpd.shutdown()
        httpd.server_close()
        stop(stub)
