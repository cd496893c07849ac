"""The port's serving fleet (`serve/fleet.py`) on the CPU.

  - The replica handoff against the JAX package's `Fleet`: for the same
    fleet settings both write a replica config.json with the same
    `train.log_dir`, `serve.port=0`, `fleet.replicas=0` and every other
    key the port reads; the port's replica command names its device.
  - The command line: `serve --replicas 2` and `serve --autoscale` run a
    fleet of fake-executor replicas (`--device cpu`, `serve.fake_exec_ms`)
    that answers, reports, and drains on SIGTERM to exit code 0 with no
    replica left; offline mode refuses the fleet flags; the model fleet on
    "cuda" without a toolkit raises before it spawns anything.
  - Chaos (marked): a seeded SIGKILL and a seeded wedge healed by
    failover, eviction and respawn with >= 99% of requests answered and
    none dropped; and the crash-loop circuit breaker.
"""

import dataclasses
import http.client
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from deepof_tpu.core import supervise as jax_supervise
from deepof_tpu.serve.fleet import Fleet as JaxFleet
from deepof_tpu_torch import cli
from deepof_tpu_torch.core import supervise
from deepof_tpu_torch.serve.fleet import Fleet
from deepof_tpu_torch.serve.router import Router, build_router_server
from torch_fleet_stubs import b64png, both_configs, flow_body

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: fast health cadence for fake-executor replicas
FAST = dict(poll_s=0.1, stale_after_s=5.0, stall_after_s=2.0,
            spawn_timeout_s=90.0, term_grace_s=1.0, backoff_s=0.1,
            backoff_max_s=0.5, healthy_after_s=30.0, proxy_timeout_s=2.0,
            max_in_flight=64, drain_timeout_s=2.0)


class _FakeProc:
    """What a spawned replica looks like to the fleet before it runs:
    its announce line on stdout."""

    def __init__(self, argv, env):
        self.argv, self.env = argv, env
        self.pid = 999_999
        self.stdout = io.StringIO(
            '{"serving": "http://127.0.0.1:5555", "pid": 1}\n')
        self.returncode = None

    def poll(self):
        return None


def _spawned(fleet_cls, sup, cfg, monkeypatch, **kw):
    seen = []

    def spawn_child(argv, env, stdout, stderr, **popen_kw):
        seen.append(_FakeProc(argv, env))
        return seen[-1]

    monkeypatch.setattr(sup, "spawn_child", spawn_child)
    fleet = fleet_cls(cfg, 2, **kw)
    with fleet._lock:
        fleet._replicas[1].state = "spawning"
    fleet._spawn(fleet._replicas[1])
    deadline = time.monotonic() + 10
    while fleet._replicas[1].port is None and time.monotonic() < deadline:
        time.sleep(0.01)  # the stdout reader parses the announce line
    with open(os.path.join(cfg.train.log_dir, "replica-1",
                           "config.json")) as f:
        written = json.load(f)
    return seen[0], fleet._replicas[1].port, written


def _same_keys(port_tree, jax_tree, path=""):
    """Every key of the port's tree has the JAX tree's value."""
    for k, v in port_tree.items():
        if isinstance(v, dict):
            _same_keys(v, jax_tree[k], f"{path}{k}.")
        else:
            assert v == jax_tree[k], f"{path}{k}: {v!r} != {jax_tree[k]!r}"


def test_the_replica_config_equals_the_jax_fleets(tmp_path, monkeypatch):
    settings = dict(
        serve=dict(buckets=((32, 64), (64, 64)), precisions=("f32", "bf16"),
                   fake_exec_ms=3.0),
        fleet=dict(FAST, replicas=2, autoscale=True, max_replicas=3),
        degrade=dict(enabled=True, max_level=2),
        faults=dict(enabled=True, replica_crash_at=(1,),
                    replica_fault_after=4))
    jcfg, pcfg = both_configs(tmp_path, **settings)
    jproc, jport, jwritten = _spawned(JaxFleet, jax_supervise, jcfg,
                                      monkeypatch)
    proc, port, written = _spawned(Fleet, supervise, pcfg, monkeypatch,
                                   device="cpu")
    _same_keys(written, jwritten)
    assert written["train"]["log_dir"] == jwritten["train"]["log_dir"] \
        == os.path.join(str(tmp_path), "replica-1")
    assert written["serve"]["port"] == 0
    assert written["serve"]["fleet"]["replicas"] == 0
    assert written["serve"]["fleet"]["autoscale"] is False
    assert written["serve"]["degrade"]["max_level"] == 2
    assert port == jport == 5555
    assert proc.argv[1:] == ["-m", "deepof_tpu_torch", "serve",
                             "--config-json",
                             os.path.join(str(tmp_path), "replica-1",
                                          "config.json"),
                             "--device", "cpu"]
    assert proc.env["DEEPOF_TPU_REPLICA"] == jproc.env[
        "DEEPOF_TPU_REPLICA"] == "1"


def test_offline_mode_refuses_the_fleet_flags(tmp_path):
    for flags in (["--replicas", "2"], ["--autoscale"]):
        with pytest.raises(SystemExit, match="HTTP-fleet only"):
            cli.main(["serve", "--input", str(tmp_path), "--out",
                      str(tmp_path / "o"), "--device", "cpu", "--set",
                      "serve.fake_exec_ms=1", *flags])


def test_a_model_fleet_on_cuda_without_a_toolkit_raises_first(tmp_path):
    import torch
    from deepof_tpu_torch.ops.cuda import build

    try:
        build.nvcc()
        pytest.skip("a CUDA toolkit is present: the build would run")
    except RuntimeError:
        pass
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="nvcc"):
        cli.main(["serve", "--replicas", "2", "--model", "flownet_c",
                  "--log-dir", str(tmp_path)])
    assert not (tmp_path / "replica-0").exists()  # nothing spawned


def _call(port, method, path, body=None, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _stop_fleet(proc, log_dir) -> None:
    """After a failure: SIGTERM the supervisor (it reaps its replicas),
    SIGKILL it if that hangs, then any replica its heartbeat names that
    is still alive (replicas run in sessions of their own)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    for d in log_dir.glob("replica-*"):
        pid = (supervise.read_heartbeat(str(d)) or {}).get("pid")
        if pid and _alive(pid):
            os.kill(pid, signal.SIGKILL)


@pytest.mark.parametrize("flags,replicas", [
    (["--replicas", "2"], 2),
    (["--autoscale", "--min-replicas", "1", "--max-replicas", "2"], 1)],
    ids=["replicas", "autoscale"])
def test_serve_fleet_answers_and_drains_on_sigterm(flags, replicas,
                                                   tmp_path):
    """`python -m deepof_tpu_torch serve --replicas 2 | --autoscale` on
    fake-executor replicas: the announce line, a flow and a stream frame
    through the router, /healthz and /metrics with the fleet's blocks,
    then SIGTERM: exit code 0 within the drain, the summary record
    written, and no replica process left."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepof_tpu_torch", "serve", *flags,
         "--device", "cpu", "--set", "serve.fake_exec_ms=5", "--set",
         "serve.port=0", "--set", "data.image_size=[32,64]", "--set",
         "obs.heartbeat_period_s=0.1", "--set",
         "serve.fleet.poll_s=0.1", "--log-dir", str(tmp_path)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    drained = False
    try:
        line = json.loads(proc.stdout.readline() or "{}")
        assert line.get("mode") == "fleet", proc.stderr.read()
        assert line["replicas"] == replicas
        port = int(line["serving"].rsplit(":", 1)[1])
        rs = np.random.RandomState(0)
        status, flow = _call(port, "POST", "/v1/flow", flow_body(rs))
        assert status == 200 and flow["shape"] == [30, 60, 2]
        status, primed = _call(port, "POST", "/v1/flow/stream", json.dumps(
            {"session": "v", "frame": b64png(rs)}))
        assert status == 202 and primed["primed"]
        # the router announces once one replica is ready
        deadline = time.monotonic() + 60
        while True:
            status, health = _call(port, "GET", "/healthz")
            if (health["fleet_ready"] == replicas
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
        assert status == 200 and health["fleet_responses"] == 2
        assert health["fleet_ready"] == replicas
        assert health.get("fleet_autoscale_enabled", False) \
            == ("--autoscale" in flags)
        pids = [r["pid"] for r in health["replicas"]]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        assert "deepof_fleet_responses 2" in text
        assert "deepof_serve_replicas_scraped" in text
        t0 = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert time.monotonic() - t0 < 2.0 + 1.0 + 5.0  # drain + grace
        drained = True
    finally:
        if not drained:
            _stop_fleet(proc, tmp_path)
    assert not [p for p in pids if _alive(p)]
    with open(tmp_path / "metrics.jsonl") as f:
        summary = [json.loads(ln) for ln in f][-1]
    assert summary["kind"] == "serve" and summary["fleet_responses"] == 2
    assert summary["fleet_evictions"] == 0
    recs = []
    for i in range(replicas):  # each replica's final record
        with open(tmp_path / f"replica-{i}" / "metrics.jsonl") as f:
            recs.append([json.loads(ln) for ln in f][-1])
    assert [r["replica"] for r in recs] == list(range(replicas))
    # the flow; the stream's first frame primes and dispatches nothing
    assert sum(r["serve_responses"] for r in recs) == 1
    assert all(set(r["kernel_launches"]) >= {"corr", "warp_fwd"}
               for r in recs)


# ------------------------------------------------ chaos (subprocesses)


def _fleet_cfg(log_dir, faults, **fleet_kw):
    _, cfg = both_configs(
        log_dir, serve=dict(max_batch=4, batch_timeout_ms=5.0,
                            fake_exec_ms=5.0),
        fleet=dict(FAST, **fleet_kw), faults=dict(enabled=True, **faults))
    return cfg.replace(obs=dataclasses.replace(
        cfg.obs, heartbeat_period_s=0.1, watchdog_min_s=0.5))


def _start_router(cfg, fleet):
    router = Router(cfg, fleet)
    httpd = build_router_server(cfg, router)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return router, httpd, httpd.server_address[1]


def _drive(port, bodies, total, clients, outcomes, stop=None):
    """Closed-loop clients; every request's outcome is recorded (a
    transport failure at the client would be a silent drop)."""
    import itertools

    counter = itertools.count()
    lock = threading.Lock()

    def worker():
        while True:
            n = next(counter)
            if n >= total or (stop is not None and stop.is_set()):
                return
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=30)
                conn.request("POST", "/v1/flow", bodies[n % len(bodies)])
                resp = conn.getresponse()
                out = (resp.status, resp.read())
                conn.close()
            except Exception as e:  # noqa: BLE001 - a drop is a failure
                out = (-1, str(e).encode())
            with lock:
                outcomes.append(out)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)


@pytest.mark.chaos
def test_crash_and_wedge_heal_via_failover(tmp_path):
    """Three replicas under sustained load, a seeded SIGKILL on replica 0
    and a seeded dispatch wedge on replica 1: >= 99% of requests
    succeed through failover, every failure is a structured error (none
    dropped), both sick replicas are evicted (the wedge through the
    replica's watchdog or the supervisor's stall detector) and
    respawned."""
    cfg = _fleet_cfg(tmp_path, dict(replica_crash_at=(0,),
                                    replica_wedge_at=(1,),
                                    replica_fault_after=20),
                     spill_in_flight=2)
    total, clients = 180, 6
    rs = np.random.RandomState(7)
    bodies = [flow_body(rs) for _ in range(4)]
    outcomes: list = []
    with Fleet(cfg, 3, device="cpu") as fleet:
        fleet.start()
        fleet.wait_ready(min_ready=3, timeout_s=120)
        router, httpd, port = _start_router(cfg, fleet)
        try:
            _drive(port, bodies, total, clients, outcomes)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                s = fleet.stats()
                if (s["fleet_crashes"] >= 1 and s["fleet_wedge_evictions"]
                        >= 1 and s["fleet_ready"] == 3):
                    break
                time.sleep(0.1)
            stats, rstats = fleet.stats(), router.stats()
        finally:
            router.draining = True
            httpd.shutdown()
            httpd.server_close()
    assert len(outcomes) == total
    ok = sum(s == 200 for s, _ in outcomes)
    failures = [(s, p[:200]) for s, p in outcomes if s != 200]
    assert ok >= int(0.99 * total), (ok, failures[:5])
    assert all(s > 0 and b"error" in p for s, p in failures), failures
    assert stats["fleet_crashes"] >= 1 and stats["fleet_respawns"] >= 2, \
        stats
    assert stats["fleet_wedge_evictions"] >= 1, stats
    assert stats["fleet_broken"] == 0 and stats["fleet_ready"] == 3, stats
    assert rstats["fleet_failovers"] >= 1, rstats
    # the respawned replicas re-armed nothing that fired again unseen:
    # every state is accounted for
    assert sorted(stats["fleet_states"].values()) == ["ready"] * 3


@pytest.mark.chaos
def test_the_circuit_breaker_stops_a_crash_loop(tmp_path):
    """A replica that dies on its first dispatch in every incarnation is
    respawned with backoff, then left broken after
    crash_loop_threshold fast failures, while its sibling answers every
    request; the sibling exits 0 on the fleet's SIGTERM."""
    cfg = _fleet_cfg(tmp_path, dict(replica_crash_at=(0,),
                                    replica_fault_after=0),
                     crash_loop_threshold=2, backoff_s=0.05,
                     backoff_max_s=0.2, term_grace_s=10.0,
                     drain_timeout_s=10.0)
    rs = np.random.RandomState(8)
    bodies = [flow_body(rs)]
    outcomes: list = []
    stop = threading.Event()
    with Fleet(cfg, 2, device="cpu") as fleet:
        fleet.start()
        fleet.wait_ready(min_ready=2, timeout_s=120)
        router, httpd, port = _start_router(cfg, fleet)
        loader = threading.Thread(target=_drive, args=(
            port, bodies, 10_000, 2, outcomes, stop), daemon=True)
        loader.start()
        try:
            deadline = time.monotonic() + 120
            while (fleet.stats()["fleet_broken"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            stop.set()
            loader.join(timeout=60)
            stats = fleet.stats()
            respawns = stats["fleet_respawns"]
            time.sleep(10 * cfg.serve.fleet.backoff_max_s)
            assert fleet.stats()["fleet_respawns"] == respawns  # stays open
            status, _ = _call(port, "POST", "/v1/flow", bodies[0])
        finally:
            stop.set()
            httpd.shutdown()
            httpd.server_close()
    assert stats["fleet_broken"] == 1, stats
    assert stats["fleet_states"]["replica-0"] == "broken", stats
    assert stats["fleet_crashes"] >= 2 and respawns >= 1, stats
    assert outcomes and all(s == 200 for s, _ in outcomes), \
        [o for o in outcomes if o[0] != 200][:5]
    assert status == 200
    assert fleet._replicas[1].last_exit == 0
