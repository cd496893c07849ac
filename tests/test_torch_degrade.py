"""The port's brownout controller (`serve/degrade.py`) and the router's
brownout and deadline admission against the JAX package's, on the same
inputs: scripted control ticks (stub fleet and router stats, the
module's clock swapped for a scripted one) walk the same levels with the
same reasons, kind="serve" transition records and degrade_* stats; the
pure decision core gives the same answers on the same sequences; and
both routers, against the same stub replicas, expire a lapsed deadline
at admission, shed low-priority work at L3 only, stamp the level on the
proxied hop, and relay a replica's deadline 504 without failover."""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from deepof_tpu.serve import degrade as jax_degrade
from deepof_tpu.serve import router as jax_router
from deepof_tpu_torch.obs.registry import lookup
from deepof_tpu_torch.serve import degrade, router
from torch_fleet_stubs import (StubFleet, both_configs, flow_body, stop,
                               stub_replica)

FAST = dict(enabled=True, period_s=0.1, escalate_after_s=0.5,
            recover_after_s=2.0, escalate_cooldown_s=0.5,
            recover_cooldown_s=1.0, up_occupancy=0.85, down_occupancy=0.5,
            up_slo_burn=0.7, max_level=3, l3_sustained_s=3.0)


class _Stub:
    def __init__(self):
        self.load = {}

    def stats(self):
        return dict(self.load)


def _script(seed: int, ticks: int) -> list[dict]:
    """A burst that saturates the pool (sheds, a burning budget), a band
    stretch, a calm stretch, a second burst and a calm stretch twice as
    long, long enough to walk down to L0; jittered from a seed."""
    rs = np.random.RandomState(seed)
    shed = 0
    out = []
    for t in range(ticks):
        phase = min((t * 6) // ticks, 4)
        occ = [1.0, 0.7, 0.1, 0.95, 0.0][phase] + rs.uniform(-0.05, 0.05)
        if phase == 0 and rs.rand() < 0.3:
            shed += 1
        out.append({"fleet_ready": 2, "fleet_shed": shed,
                    "fleet_unavailable": 0,
                    "fleet_in_flight": round(max(occ, 0.0) * 64),
                    "fleet_slo": {"burn": 0.9 if phase == 0 else 0.2}})
    return out


def _ticks(mod, cfg, script, period, log_dir):
    clock = [0.0]
    stub = _Stub()
    real = mod.time
    mod.time = SimpleNamespace(monotonic=lambda: clock[0],
                               time=lambda: 1e9 + clock[0])
    try:
        c = mod.DegradeController(cfg, stub, stub)
        levels = []
        for step in script:
            stub.load = step
            c._tick()
            levels.append(c.level())
            clock[0] += period
            if c.level() == c.max_level:
                top = c.stats()  # the stats at the ladder's top
        stats = c.stats()
    finally:
        mod.time = real
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [{k: v for k, v in json.loads(ln).items() if k != "time"}
                   for ln in f]
    return levels, records, stats, top


@pytest.mark.parametrize("max_level", [3, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_levels_records_and_stats_equal_jax(max_level, seed, tmp_path):
    kw = dict(FAST, max_level=max_level)
    fleet_kw = dict(max_in_flight=32)
    jcfg, _ = both_configs(tmp_path / "jax", degrade=kw, fleet=fleet_kw)
    _, pcfg = both_configs(tmp_path / "port", degrade=kw, fleet=fleet_kw)
    script = _script(seed, 300)
    got = _ticks(degrade, pcfg, script, 0.1, str(tmp_path / "port"))
    want = _ticks(jax_degrade, jcfg, script, 0.1, str(tmp_path / "jax"))
    assert got == want
    levels, records, stats, top = got
    # one level at a time, up to the ceiling and back to L0
    assert max(levels) == max_level and levels[-1] == 0
    assert all(abs(a - b) <= 1 for a, b in zip(levels, levels[1:]))
    assert stats["degrade_escalations"] == stats["degrade_recoveries"] \
        >= max_level
    assert [r["level_after"] for r in records][:max_level] \
        == list(range(1, max_level + 1))
    assert top["degrade_level_name"] == degrade.LEVELS[max_level]
    assert top["degrade_l3_sustained"] == (max_level == 3)
    assert all(lookup(k) is not None for k in stats)


def _sig(**kw):
    return {"ready": 2, "bad_total": 0, "occupancy": 0.6, "slo_burn": 0.0,
            **kw}


SEQUENCES = {
    "shed_sustained": (0, [(0.0, _sig(bad_total=5)),
                           (1.0, _sig(bad_total=9)),
                           (2.5, _sig(bad_total=14))]),
    "band_resets": (0, [(0.0, _sig(occupancy=0.9)),
                        (1.5, _sig(occupancy=0.6)),
                        (3.0, _sig(occupancy=0.9)),
                        (5.5, _sig(occupancy=0.9))]),
    "slo_burn": (0, [(0.0, _sig(slo_burn=0.8)), (2.5, _sig(slo_burn=0.8))]),
    "at_max_level": (3, [(0.0, _sig(occupancy=1.0)),
                         (2.5, _sig(occupancy=1.0))]),
    "recovery": (2, [(0.0, _sig(occupancy=0.3)), (5.0, _sig(occupancy=0.3)),
                     (10.5, _sig(occupancy=0.3))]),
    "calm_at_l0": (0, [(0.0, _sig(occupancy=0.3)),
                       (10.5, _sig(occupancy=0.3))]),
    "oscillating": (1, [(float(t), _sig(occupancy=0.95 if t % 2 else 0.2))
                        for t in range(20)]),
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_evaluate_decisions_equal_jax(name, tmp_path):
    kw = dict(FAST, escalate_after_s=2.0, recover_after_s=10.0,
              escalate_cooldown_s=5.0, recover_cooldown_s=5.0)
    jcfg, pcfg = both_configs(tmp_path, degrade=kw)
    level, seq = SEQUENCES[name]
    got = degrade.DegradeController(pcfg, None, None)
    want = jax_degrade.DegradeController(jcfg, None, None)
    got._level = want._level = level
    decisions = [got.evaluate(now, dict(s)) for now, s in seq]
    assert decisions == [want.evaluate(now, dict(s)) for now, s in seq]
    assert any(d[0] for d in decisions) \
        == (name in ("shed_sustained", "band_resets", "slo_burn",
                     "recovery"))


# ----------------------------------------- the router's admission gates


def _admission(rcls, cfg, rs):
    stub = stub_replica()
    try:
        fleet = StubFleet([stub.server_address[1]])
        r = rcls(cfg, fleet)
        body = flow_body(rs)
        out = []
        for headers, level in (({"X-Deadline-Ms": "0"}, 0),
                               ({"X-Deadline-Ms": "soon"}, 0),
                               ({"X-Priority": "urgent"}, 0),
                               ({"X-Priority": "low"}, 3),
                               ({}, 3), ({"X-Priority": "low"}, 2),
                               ({"X-Deadline-Ms": "30000"}, 1)):
            r.degrade_level = (lambda lv=level: lv)
            status, payload, _ = r.handle_flow("/v1/flow", body,
                                               "application/json",
                                               headers=headers)
            p = json.loads(payload)
            seen = p.get("deadline_ms_seen")
            out.append((status, p.get("error"), p.get("level_seen"),
                        seen is not None and 0 < float(seen) <= 30000))
        return out, {k: v for k, v in r.stats().items()
                     if k not in ("fleet_latency_hist", "fleet_load_rps",
                                  "fleet_load_slope")}
    finally:
        stop(stub)


def _relay_504(rcls, cfg, rs):
    expired = stub_replica(status=504, payload={
        "error": "deadline_exceeded", "message": "deadline expired"})
    healthy = stub_replica()
    try:
        fleet = StubFleet([expired.server_address[1],
                           healthy.server_address[1]])
        r = rcls(cfg, fleet)
        status, payload, _ = r.handle_flow(
            "/v1/flow", flow_body(rs), "application/json",
            headers={"X-Deadline-Ms": "5000"})
        return ((status, json.loads(payload)["error"], fleet.failures),
                r.stats()["fleet_failovers"])
    finally:
        stop(expired, healthy)


def test_admission_gates_equal_jax(tmp_path):
    jcfg, pcfg = both_configs(tmp_path)
    got = _admission(router.Router, pcfg, np.random.RandomState(5))
    want = _admission(jax_router.Router, jcfg, np.random.RandomState(5))
    assert got == want
    assert [o[:2] for o in got[0]] == [
        (504, "deadline_exceeded"), (400, "bad_request"),
        (400, "bad_request"), (503, "shed_low_priority"), (200, None),
        (200, None), (200, None)]
    assert [o[2] for o in got[0][4:]] == ["3", "2", "1"]
    assert got[0][-1][3]  # the remaining budget rides the hop
    assert got[1]["deadline_admission_expired"] == 1
    assert got[1]["degrade_shed_low"] == 1
    assert got[1]["fleet_routed"] == {"replica-0": 3}


def test_a_replica_deadline_504_is_relayed_without_failover_as_jax(
        tmp_path):
    jcfg, pcfg = both_configs(tmp_path)
    got = _relay_504(router.Router, pcfg, np.random.RandomState(6))
    assert got == _relay_504(jax_router.Router, jcfg,
                             np.random.RandomState(6))
    assert got == ((504, "deadline_exceeded", []), 0)


def test_the_controller_thread_feeds_the_router_level(tmp_path):
    """Live: the controller thread escalates on a saturated stub pool and
    the router's hook reads the level it set."""
    _, pcfg = both_configs(tmp_path, degrade=dict(FAST, period_s=0.05,
                                                  escalate_after_s=0.1,
                                                  escalate_cooldown_s=0.1),
                           fleet=dict(max_in_flight=4))
    stub = _Stub()
    stub.load = {"fleet_ready": 1, "fleet_in_flight": 4}
    r = router.Router(pcfg, StubFleet([None]))
    with degrade.DegradeController(pcfg, stub, stub) as c:
        r.degrade_level, r.degrade_stats = c.level, c.stats
        c.start()
        deadline = time.monotonic() + 10
        while r._level() < 2 and time.monotonic() < deadline:
            time.sleep(0.05)
    assert r._level() >= 2
    assert r.stats()["degrade_level"] == r._level()
