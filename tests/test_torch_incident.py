"""The incident plane (`obs/incident.py`) of the PyTorch port against the
JAX package's: the recorder's dedup window, token bucket, keep bound and
manifest under a patched clock and the same trigger sequence; alert
parsing and firing on the same specs and samples; the collection from a
fleet's replica dirs; the `incidents` verb's output and return codes on
the same directory. Then the port's triggers commit their bundles: the
engine's `quality_drift` and `slo_exhausted`, the fleet's eviction and
crash, brownout L3, and the trainer's NaN rollback. Every comparison is
exact: the two recorders are the same stdlib code on the same inputs.
"""

import json
import os
import shutil
import time

import numpy as np
import pytest

from deepof_tpu import cli as jax_cli
from deepof_tpu.obs import incident as jinc
from deepof_tpu_torch import cli
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          ObsConfig, ResilienceConfig,
                                          ServeConfig, TrainConfig)
from deepof_tpu_torch.obs import incident as tinc
from deepof_tpu_torch.resilience.faults import FaultConfig

#: manifest fields that name the process or the moment
VOLATILE = ("id", "pid", "seq", "time", "iso_time", "registry_digest")


def _record_sequence(mod, log_dir, monkeypatch):
    """The same triggers through a recorder of `mod` on a patched clock:
    a dedup inside and past the window, a burst past the token bucket and
    its refill, more bundles than the keep bound."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    rec = mod.IncidentRecorder(str(log_dir), "serve", rate_per_min=6.0,
                               burst=3, dedup_window_s=30.0, keep=3,
                               config_digest="abc")
    outcomes = []
    for t, kind, sev in ((0, "a", "critical"), (5, "a", "critical"),
                         (6, "b", "warn"), (7, "c", "warn"),
                         (8, "d", "warn"), (20, "d", "warn"),
                         (40, "a", "critical"), (41, "e", "warn"),
                         (60, "f", "critical"), (200, "g", "warn")):
        clock[0] = 1000.0 + t
        path = rec.record(kind, sev, trigger={"t": t})
        outcomes.append(None if path is None else os.path.basename(path)
                        .split("-")[1])
    mans = [{k: v for k, v in m.items() if k not in VOLATILE}
            for m in mod.list_incidents(str(log_dir))]
    return outcomes, rec.stats(), mans


def test_recorder_dedup_bucket_keep_and_manifests_equal_jax(tmp_path,
                                                            monkeypatch):
    got = _record_sequence(tinc, tmp_path / "port", monkeypatch)
    want = _record_sequence(jinc, tmp_path / "jax", monkeypatch)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert [m["files"].keys() for m in got[2]] \
        == [m["files"].keys() for m in want[2]]
    for g, w in zip(got[2], want[2]):
        g.pop("files"), w.pop("files")
        g["counters"].pop("incident_last_kind", None)
        w["counters"].pop("incident_last_kind", None)
    assert got[2] == want[2]
    outcomes, stats, mans = got
    assert outcomes[:6] == ["a", None, "b", "c", None, "d"]
    assert stats["incident_deduped"] >= 1
    assert stats["incident_rate_limited"] >= 1
    assert len(mans) == 3  # the keep bound
    assert set(want[2][0]) == {"schema", "kind", "severity", "role",
                               "trigger", "counters", "dedup_key",
                               "config_digest", "origin", "acked"}


SPECS = ["err_burst: rate(serve_errors) > 5 critical",
         "serve_queue_depth >= 64",
         "browned: degrade_level >= 2 warn",
         "evicted: fleet_evictions > 0 critical",
         "q: serve_quality_breaches >= 1.5e0",
         "incident_captured < 100"]
BAD = ["nonsense", "x: not_a_registered_key > 1", "serve_errors >> 2",
       "serve_errors > 1 fatal"]


def _rule(r):
    return (r.spec, r.name, r.counter, r.rate, r.op, r.threshold,
            r.severity)


def test_alert_rules_parse_and_fire_as_jax(tmp_path, monkeypatch):
    assert [_rule(r) for r in tinc.parse_alert_rules(SPECS)] \
        == [_rule(r) for r in jinc.parse_alert_rules(SPECS)]
    for spec in BAD + [[SPECS[0], SPECS[0]]]:
        specs = spec if isinstance(spec, list) else [spec]
        with pytest.raises(ValueError):
            jinc.parse_alert_rules(specs)
        with pytest.raises(ValueError):
            tinc.parse_alert_rules(specs)
    samples = [{"serve_errors": 0, "serve_queue_depth": 3,
                "degrade_level": 0, "fleet_evictions": 0},
               {"serve_errors": 40, "serve_queue_depth": 80,
                "degrade_level": 2, "fleet_evictions": 1,
                "serve_quality_breaches": 2}]
    out = []
    for mod, d in ((tinc, "port"), (jinc, "jax")):
        clock = [50.0]
        monkeypatch.setattr(time, "monotonic", lambda: clock[0])
        rec = mod.IncidentRecorder(str(tmp_path / d), "serve", burst=10,
                                   alerts=SPECS)
        wrapped = rec.wrap_sample(lambda: dict(samples[len(seen)]))
        seen = []
        for _ in samples:
            clock[0] += 2.0
            s = wrapped()
            seen.append(s)
        out.append((rec.stats(), [m["kind"] for m in
                                  mod.list_incidents(str(tmp_path / d))],
                    sorted(k for k in seen[-1] if k.startswith(
                        ("incident_", "alert_")))))
    assert out[0] == out[1]
    assert out[0][0]["alert_firings"] == 5


def test_collect_from_children_equals_jax(tmp_path):
    counts = []
    for mod, d in ((tinc, "port"), (jinc, "jax")):
        root = tmp_path / d
        for i in range(2):
            rec = mod.IncidentRecorder(str(root / f"replica-{i}"), "replica")
            rec.record("quality_drift", "critical", trigger={"i": i})
        os.makedirs(root / "replica-1" / "incidents" / ".tmp-1-1")  # torn
        n = mod.collect_from_children(str(root))
        mans = mod.list_incidents(str(root))
        counts.append((n, sorted(m["origin"] for m in mans),
                       sorted(m["id"].split("--")[0] for m in mans),
                       mod.incident_summary(str(root))["by_kind"]))
    assert counts[0] == counts[1]
    assert counts[0][0] == 2


def _verb(main, argv, capsys):
    """(return code, or the exception's type name; the JSON printed)."""
    try:
        rc = main(argv)
    except Exception as e:  # noqa: BLE001 - compared between the packages
        rc = type(e).__name__
    out = capsys.readouterr().out
    return rc, json.loads(out) if out.strip() else None


def test_incidents_verb_output_and_return_codes_equal_jax(tmp_path, capsys):
    """list / show / ack / gc on twin copies of one directory: the same
    JSON (the directory's name aside) and the same return codes: 2 with
    nothing recorded, 1 while a critical bundle is unacknowledged (and
    for an unknown id to `show`), 0 after `ack`."""
    base = tmp_path / "base"
    assert _verb(cli.main, ["incidents", "list", "--log-dir", str(base)],
                 capsys)[0] == _verb(jax_cli.main, [
                     "incidents", "list", "--log-dir", str(base)],
                     capsys)[0] == 2
    rec = tinc.IncidentRecorder(str(base), "serve")
    rec.record("brownout_l3", "warn")
    rec.record("quality_drift", "critical", trigger={"burn": 2.0})
    os.makedirs(base / "incidents" / ".tmp-9-9")  # a torn capture
    dirs = {}
    for name in ("port", "jax"):
        dirs[name] = str(tmp_path / name)
        shutil.copytree(base, dirs[name])
    bundle = tinc.list_incidents(str(base))[-1]["id"]
    steps = [["list"], ["show", "--id", bundle], ["show", "--id", "nope"],
             ["ack", "--id", "nope"], ["ack", "--id", bundle], ["list"],
             ["ack"], ["gc", "--acked"], ["list"]]
    rcs = []
    for step in steps:
        got = _verb(cli.main, ["incidents", *step, "--log-dir",
                               dirs["port"]], capsys)
        want = _verb(jax_cli.main, ["incidents", *step, "--log-dir",
                                    dirs["jax"]], capsys)
        assert got[0] == want[0], step
        g, w = (json.loads(json.dumps(r[1]).replace(d, "DIR"))
                for r, d in ((got, dirs["port"]), (want, dirs["jax"])))
        assert g == w, step
        rcs.append(got[0])
    # an unknown id: the JAX verb's `ack` raises, as the port's does
    assert rcs == [1, 0, 1, "FileNotFoundError", 0, 0, 0, 0, 2]
    rcs = [_verb(cli.main, ["incidents", *s, "--log-dir", str(base)],
                 capsys)[0] for s in (["list"], ["ack"], ["list"])]
    assert rcs == [1, 0, 0]


# ------------------------------------------------------ the port's triggers


def _fake_engine_cfg(log_dir, **obs):
    return ExperimentConfig(
        model="flownet_s", width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(32, 48),
                        gt_size=(32, 48)),
        serve=ServeConfig(max_batch=1, batch_timeout_ms=1.0,
                          fake_exec_ms=1.0),
        train=TrainConfig(log_dir=str(log_dir)),
        obs=ObsConfig(incidents=True, **obs))


def test_engine_records_quality_drift_and_slo_exhaustion(tmp_path):
    from deepof_tpu_torch.serve.engine import InferenceEngine

    cfg = _fake_engine_cfg(tmp_path, quality_sample_rate=1.0,
                           quality_ref_samples=2, quality_drift_factor=1.0,
                           quality_budget=0.1, slo_latency_ms=0.5,
                           slo_error_budget=0.01)
    rs = np.random.RandomState(0)
    calm = rs.randint(100, 120, (32, 48, 3), dtype=np.uint8)
    with InferenceEngine(cfg, device="cpu") as eng:
        eng.incidents = tinc.install(cfg, str(tmp_path), "serve")
        for _ in range(2):  # the reference: identical frames
            eng.submit(calm, calm).result(timeout=30)
        for _ in range(4):  # then noise
            eng.submit(calm, rs.randint(0, 256, (32, 48, 3),
                                        dtype=np.uint8)).result(timeout=30)
        assert eng._quality.drain(30.0)
        stats = eng.stats()
        eng.stats()  # the dedup window absorbs the re-evaluation
    assert stats["serve_quality"]["exhausted"]
    assert stats["serve_slo"]["exhausted"]
    kinds = sorted(m["kind"] for m in tinc.list_incidents(str(tmp_path)))
    assert kinds == ["quality_drift", "slo_exhausted"]
    assert stats["incident_captured"] == 2 and "alert_rules" in stats
    assert tinc.incident_summary(str(tmp_path))["unacked_critical"] == 2


def test_fleet_and_brownout_triggers_commit_bundles(tmp_path):
    from deepof_tpu_torch.serve import degrade
    from deepof_tpu_torch.serve.fleet import Fleet, _Replica

    cfg = _fake_engine_cfg(tmp_path)
    fleet = Fleet(cfg, 2, device="cpu")
    fleet.incidents = tinc.install(cfg, str(tmp_path), "fleet")
    r = _Replica(0)
    with fleet._lock:
        fleet._evict(r, "wedged", time.monotonic())
        r.proc = None
        fleet._on_death(_Replica(1), "crashed")
    # a replica's own bundle, collected into the run root
    tinc.IncidentRecorder(str(tmp_path / "replica-1"), "replica").record(
        "quality_drift", "critical")
    fleet._drain_incidents()
    c = degrade.DegradeController(cfg, fleet, None)
    c.incidents = fleet.incidents
    c._record = lambda *a: None  # the transition record is not the point
    c._level, c.max_level = 2, 3
    sig = {"occupancy": 1.0, "slo_burn": 0.0}
    c.evaluate = lambda *a: ("escalate", "test")
    c.signals = lambda: sig
    c._tick()
    kinds = sorted(m["kind"] for m in tinc.list_incidents(str(tmp_path)))
    assert kinds == ["brownout_l3", "fleet_eviction", "fleet_replica_crash",
                     "quality_drift"]
    assert fleet.incidents.stats()["incident_collected"] == 1


def test_trainer_records_a_nan_rollback(tmp_path):
    from deepof_tpu_torch.train.loop import Trainer

    cfg = ExperimentConfig(
        width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(32, 32),
                        batch_size=2),
        train=TrainConfig(log_every=1, eval_every=0, log_dir=str(tmp_path),
                          pipeline_depth=0),
        resilience=ResilienceConfig(
            max_consecutive_skips=1,
            faults=FaultConfig(enabled=True, dispatch_at=(2,))),
        obs=ObsConfig(incidents=True, heartbeat=False, flops=False))
    Trainer(cfg, device="cpu").fit(max_steps=4)
    mans = tinc.list_incidents(str(tmp_path))
    assert [m["kind"] for m in mans] == ["nan_rollback"]
    assert mans[0]["role"] == "trainer" and "metrics_tail.jsonl" in \
        mans[0]["files"]
