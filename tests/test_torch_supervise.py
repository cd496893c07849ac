"""The port's supervisor core (`core/supervise.py`) against the JAX
package's, on the same inputs: the pid-gated heartbeat verdict with its
stall gate, the crash-loop, backoff and breaker arithmetic, the
heartbeat read, and the effectful helpers (the child directory and its
config.json, the spawn environment, the TCP probes, the bounded reap);
and the parent -> replica config handoff, which round-trips with no
warning."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
import warnings

import pytest

from deepof_tpu.core import supervise as jax_supervise
from deepof_tpu_torch.core import supervise
from deepof_tpu_torch.core.config import (DegradeConfig, ExperimentConfig,
                                          FleetConfig, ServeConfig,
                                          config_from_dict)
from deepof_tpu_torch.resilience.faults import FaultConfig

NOW = 1_000_000.0


def _hb(pid=42, age=None, wedged=False, t=NOW, **extra):
    hb = {"pid": pid, "time": t, **extra}
    if age is not None:
        hb["last_step_age_s"] = age
    if wedged:
        hb["wedged"] = True
    return hb


def _in_flight(hb):
    return hb.get("serve_requests", 0) > hb.get("serve_responses", 0)


VERDICTS = [
    ("ok", _hb(age=0.1), 42, None, "ok"),
    ("no_heartbeat", None, 42, None, "no_heartbeat"),
    ("foreign_pid_wedged", _hb(pid=41, wedged=True), 42, None,
     "foreign_pid"),
    ("pid_field_absent", _hb(pid=None), 42, None, "ok"),
    ("no_current_pid", _hb(pid=41), None, None, "ok"),
    ("wedged", _hb(wedged=True, age=0.1), 42, None, "wedged"),
    ("stale", _hb(t=NOW - 6.0, age=0.1), 42, None, "stale"),
    ("stale_beats_stall", _hb(t=NOW - 6.0, age=9.0), 42, None, "stale"),
    ("wedged_beats_stale", _hb(t=NOW - 6.0, wedged=True), 42, None,
     "wedged"),
    ("stalled_ungated", _hb(age=3.0), 42, None, "stalled"),
    ("stalled_gate_open", _hb(age=3.0, serve_requests=2,
                              serve_responses=1), 42, _in_flight,
     "stalled"),
    ("stalled_gate_closed", _hb(age=3.0, serve_requests=2,
                                serve_responses=2), 42, _in_flight, "ok"),
    ("age_not_a_number", _hb(age="x"), 42, None, "ok"),
]


@pytest.mark.parametrize("name,hb,pid,gate,want", VERDICTS,
                         ids=[v[0] for v in VERDICTS])
@pytest.mark.parametrize("stall", [2.0, 0.0])
def test_heartbeat_verdict_equals_jax(name, hb, pid, gate, want, stall):
    got = supervise.heartbeat_verdict(hb, pid, NOW, 5.0, stall,
                                      stall_gate=gate)
    assert got == jax_supervise.heartbeat_verdict(hb, pid, NOW, 5.0, stall,
                                                  stall_gate=gate)
    # stall_after_s <= 0 disables the stall verdict
    assert got == (want if stall > 0 or want != "stalled" else "ok")


def test_pid_gate_equals_jax():
    for hb in (None, _hb(), _hb(pid=7), _hb(pid=None)):
        for pid in (None, 42, 7):
            assert supervise.pid_gated(hb, pid) \
                == jax_supervise.pid_gated(hb, pid)


def test_crash_loop_backoff_and_breaker_equal_jax():
    for n in range(6):
        for fast in (False, True):
            for clean in (False, True):
                assert supervise.crash_loop_update(n, fast, clean) \
                    == jax_supervise.crash_loop_update(n, fast, clean)
        for base, cap in ((0.5, 30.0), (0.1, 0.5), (2.0, 3.0)):
            assert supervise.backoff_delay(base, cap, n) \
                == jax_supervise.backoff_delay(base, cap, n)
        for threshold in (1, 2, 3):
            assert supervise.breaker_open(n, threshold) \
                == jax_supervise.breaker_open(n, threshold)
    # a slow death resets, a clean one never counts, a fast one counts
    assert [supervise.crash_loop_update(2, f, c) for f, c in
            ((False, False), (True, True), (True, False))] == [0, 2, 3]
    assert supervise.backoff_delay(0.5, 30.0, 0) == 0.25


def test_read_heartbeat_absent_torn_and_whole_equal_jax(tmp_path):
    d = str(tmp_path)
    seen = [supervise.read_heartbeat(d)]
    (tmp_path / "heartbeat.json").write_text('{"pid": 1, "ti')
    seen.append(supervise.read_heartbeat(d))
    (tmp_path / "heartbeat.json").write_text('{"pid": 1, "time": 2.0}')
    seen.append(supervise.read_heartbeat(d))
    assert seen == [None, None, {"pid": 1, "time": 2.0}]
    assert seen[-1] == jax_supervise.read_heartbeat(d)


def _fleet_cfg() -> ExperimentConfig:
    return ExperimentConfig(
        model="flownet_c",
        serve=ServeConfig(buckets=((384, 512), (192, 256)),
                          precisions=("f32", "bf16"), fake_exec_ms=3.0,
                          fleet=FleetConfig(replicas=3, backoff_s=0.25,
                                            autoscale=True),
                          degrade=DegradeConfig(enabled=True,
                                                max_level=2)),
        resilience=dataclasses.replace(
            ExperimentConfig().resilience, faults=FaultConfig(
                enabled=True, replica_crash_at=(0, 2), decode_at=(1, 5))))


def test_config_round_trips_through_json_with_no_warning():
    """The parent -> replica handoff: asdict -> JSON -> config_from_dict
    gives the same frozen tree, nested tuples included, and warns about
    nothing (every key written is one the port reads)."""
    cfg = _fleet_cfg()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        back = config_from_dict(json.loads(json.dumps(
            dataclasses.asdict(cfg))))
    assert back == cfg
    assert back.serve.buckets == ((384, 512), (192, 256))
    assert back.resilience.faults.replica_crash_at == (0, 2)


def test_prepare_child_dir_writes_the_config_and_drops_the_heartbeat(
        tmp_path):
    child = str(tmp_path / "replica-0")
    os.makedirs(child)
    with open(os.path.join(child, "heartbeat.json"), "w") as f:
        f.write('{"pid": 1, "wedged": true}')  # a dead incarnation's
    cfg = _fleet_cfg()
    path = supervise.prepare_child_dir(child, cfg)
    assert path == os.path.join(child, "config.json")
    assert supervise.read_heartbeat(child) is None
    with open(path) as f:
        assert config_from_dict(json.load(f)) == cfg


def test_child_env_names_the_repo_and_sets_no_platform(monkeypatch):
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    env = supervise.child_env(extra={"DEEPOF_TPU_REPLICA": "3"})
    assert env["PYTHONPATH"].split(os.pathsep)[0] == supervise.REPO_ROOT \
        == os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert env["DEEPOF_TPU_REPLICA"] == "3"
    # the device rides the child's argv; the card is never hidden
    assert "JAX_PLATFORMS" not in env and "CUDA_VISIBLE_DEVICES" not in env


def test_tcp_probes():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        assert not supervise.listening("127.0.0.1", port)
        with pytest.raises(TimeoutError):
            supervise.wait_for_listen("127.0.0.1", port, timeout_s=0.2)
        s.listen()
        assert supervise.listening("127.0.0.1", port)
        supervise.wait_for_listen("127.0.0.1", port, timeout_s=1.0)


def test_spawn_terminate_and_bounded_reap():
    """A detached child in its own session; SIGTERM reaps it within the
    deadline, and one that ignores SIGTERM is SIGKILLed at the deadline."""
    env = supervise.child_env()
    ignore = ("import signal, sys, time; "
              "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
              "print('up', flush=True); time.sleep(60)")
    for code, want in (("import time; print('up', flush=True); "
                        "time.sleep(60)", -15), (ignore, -9)):
        proc = supervise.spawn_child([sys.executable, "-c", code], env,
                                     subprocess.PIPE, subprocess.DEVNULL,
                                     text=True)
        assert proc.stdout.readline().strip() == "up"
        assert os.getsid(proc.pid) == proc.pid  # a session of its own
        supervise.terminate_quietly(proc)
        t0 = time.monotonic()
        assert supervise.reap_within(proc, time.monotonic() + 1.0) == want
        assert time.monotonic() - t0 < 10.0
        supervise.kill_quietly(proc)  # already dead: swallowed
    assert supervise.reap_within(None, 0.0) is None
