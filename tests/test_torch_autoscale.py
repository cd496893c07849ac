"""The port's autoscaler (`serve/autoscale.py`) against the JAX package's
`Autoscaler`, on the same scripted inputs: each control tick reads the
same stub fleet and router stats at the same fabricated clock (the
module's `time` swapped for a scripted one), and the two give the same
decisions and reasons, the same scale events and kind="fleet" records,
and the same fleet_autoscale_* stats block."""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

from deepof_tpu.serve import autoscale as jax_autoscale
from deepof_tpu_torch.obs.registry import lookup
from deepof_tpu_torch.serve import autoscale
from torch_fleet_stubs import both_configs

FAST = dict(autoscale=True, min_replicas=1, max_replicas=3,
            autoscale_period_s=0.5, autoscale_up_after_s=2.0,
            autoscale_down_after_s=6.0, autoscale_up_occupancy=0.75,
            autoscale_down_occupancy=0.15, autoscale_up_slo_burn=0.5,
            autoscale_up_cooldown_s=3.0, autoscale_down_cooldown_s=8.0,
            max_in_flight=8)


class _Pool:
    """A stub fleet and router in one: the pool size follows the scale
    events, the load comes from a script."""

    def __init__(self, size):
        self.size = size
        self.broken = 0
        self.next_idx = size
        self.load = {}

    def scale_up(self):
        self.size += 1
        self.next_idx += 1
        return self.next_idx - 1

    def retire_one(self, router=None):
        self.size -= 1
        return self.size

    def stats(self):  # the fleet's half and the router's half
        states = {f"replica-{i}": "broken" if i < self.broken else "ready"
                  for i in range(self.size)}
        return {"fleet_replicas": self.size,
                "fleet_ready": self.size - self.broken,
                "fleet_states": states, **self.load}


def _script(seed: int, ticks: int) -> list[dict]:
    """Router loads: a ramp, a saturated burst with sheds and SLO
    breaches, a broken replica, a calm stretch, a second burst and idle;
    jittered from a seed."""
    rs = np.random.RandomState(seed)
    shed = breaches = 0
    out = []
    for t in range(ticks):
        phase = (t * 6) // ticks
        occ = [0.5, 1.0, 0.6, 0.05, 0.9, 0.0][phase] + rs.uniform(-0.1, 0.1)
        if phase in (1, 4) and rs.rand() < 0.5:
            shed += int(rs.randint(1, 4))
        if phase == 1 and rs.rand() < 0.3:
            breaches += 1
        out.append({"in_flight_per_ready": max(occ, 0.0) * 8,
                    "fleet_shed": shed, "fleet_unavailable": 0,
                    "fleet_slo": {"breaches": breaches,
                                  "burn": 0.8 if phase == 1 else 0.1},
                    "fleet_load_slope": [0.5, 3.0, -1.0, -0.2, 2.0, 0.0]
                    [phase],
                    "broken": 1 if phase == 2 else 0})
    return out


def _ticks(mod, cfg, script, period, log_dir):
    """The control loop's own ticks (`_tick`) over the script."""
    clock = [0.0]
    pool = _Pool(1)
    real = mod.time
    mod.time = SimpleNamespace(monotonic=lambda: clock[0],
                               time=lambda: 1e9 + clock[0])
    try:
        a = mod.Autoscaler(cfg, pool, pool)
        sizes = []
        for step in script:
            pool.broken = min(step["broken"], pool.size - 1)
            ready = pool.size - pool.broken
            pool.load = {k: v for k, v in step.items()
                         if k.startswith("fleet_")}
            pool.load["fleet_in_flight"] = round(
                step["in_flight_per_ready"] * ready)
            a._tick()
            sizes.append(pool.size)
            clock[0] += period
        stats = a.stats()
    finally:
        mod.time = real
    path = os.path.join(log_dir, "metrics.jsonl")
    records = []
    if os.path.exists(path):
        with open(path) as f:
            records = [{k: v for k, v in json.loads(ln).items()
                        if k != "time"} for ln in f]
    return sizes, records, stats


VARIANTS = {
    "reactive": {},
    "predictive_slope": {"autoscale_up_slope": 1.0},
    "ceiling_two": {"max_replicas": 2, "autoscale_up_cooldown_s": 0.0},
    "floor_two": {"min_replicas": 2, "max_replicas": 4},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("seed", [0, 1])
def test_scale_events_records_and_stats_equal_jax(variant, seed, tmp_path):
    kw = {**FAST, **VARIANTS[variant]}
    jcfg, _ = both_configs(tmp_path / "jax", fleet=kw)
    _, pcfg = both_configs(tmp_path / "port", fleet=kw)
    script = _script(seed, 160)
    got = _ticks(autoscale, pcfg, script, 0.25, str(tmp_path / "port"))
    want = _ticks(jax_autoscale, jcfg, script, 0.25, str(tmp_path / "jax"))
    assert got == want
    sizes, records, stats = got
    events = [r["event"] for r in records]
    assert "scale_up" in events and "scale_down" in events, events
    assert max(sizes) <= kw["max_replicas"]
    assert min(sizes[1:]) >= min(kw["min_replicas"], 1)
    assert stats["fleet_autoscale_up"] == events.count("scale_up")
    assert all(lookup(k) is not None for k in stats)


def _sig(**kw):
    return {"size": 2, "ready": 2, "bad_total": 0, "occupancy": 0.4,
            "slo_breaches": 0, "slo_burn": 0.0, "load_slope": 0.0, **kw}


#: (clock, signals) sequences for the pure decision core
SEQUENCES = {
    "shed_sustained": [(0.0, _sig(bad_total=5)), (1.0, _sig(bad_total=9)),
                       (2.5, _sig(bad_total=14))],
    "band_resets": [(0.0, _sig(occupancy=0.9)), (1.5, _sig(occupancy=0.5)),
                    (3.0, _sig(occupancy=0.9)), (5.5, _sig(occupancy=0.9))],
    "slo_needs_breaches_and_burn": [
        (0.0, _sig(slo_breaches=1, slo_burn=0.9)),
        (2.5, _sig(slo_breaches=1, slo_burn=0.9)),
        (3.0, _sig(slo_breaches=2, slo_burn=0.2)),
        (5.5, _sig(slo_breaches=3, slo_burn=0.6)),
        (8.0, _sig(slo_breaches=4, slo_burn=0.6))],
    "at_max": [(0.0, _sig(size=3, occupancy=1.0)),
               (2.5, _sig(size=3, occupancy=1.0))],
    "idle_floor": [(0.0, _sig(occupancy=0.0)), (25.0, _sig(occupancy=0.0)),
                   (26.0, _sig(size=1, ready=1, occupancy=0.0))],
    "idle_needs_no_shed": [(0.0, _sig(occupancy=0.0)),
                           (10.0, _sig(occupancy=0.0, bad_total=1)),
                           (25.0, _sig(occupancy=0.0, bad_total=1))],
    "slope": [(0.0, _sig(load_slope=2.0)), (2.5, _sig(load_slope=2.0))],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_evaluate_decisions_equal_jax(name, tmp_path):
    kw = dict(FAST, max_replicas=3, autoscale_up_slope=1.0,
              autoscale_down_after_s=20.0, autoscale_down_cooldown_s=30.0)
    jcfg, pcfg = both_configs(tmp_path, fleet=kw)
    got = autoscale.Autoscaler(pcfg, None, None)
    want = jax_autoscale.Autoscaler(jcfg, None, None)
    for now, sig in SEQUENCES[name]:
        assert got.evaluate(now, dict(sig)) == want.evaluate(now, dict(sig))
    assert got.stats() == want.stats()


def test_unsatisfiable_bounds_are_refused(tmp_path):
    from deepof_tpu_torch.serve.fleet import Fleet

    _, pcfg = both_configs(tmp_path, fleet=dict(autoscale=True,
                                                min_replicas=4,
                                                max_replicas=2))
    with pytest.raises(ValueError, match="min_replicas"):
        autoscale.Autoscaler(pcfg, None, None)
    with pytest.raises(ValueError, match="min_replicas"):
        Fleet(pcfg, device="cpu")


def test_the_control_thread_starts_and_closes(tmp_path):
    _, pcfg = both_configs(tmp_path, fleet=dict(FAST,
                                                autoscale_period_s=0.05))
    pool = _Pool(1)
    pool.load = {"fleet_in_flight": 0}
    with autoscale.Autoscaler(pcfg, pool, pool) as a:
        a.start()
        time.sleep(0.3)
    assert not a._thread.is_alive()
    assert a.stats()["fleet_autoscale_idle_ticks"] >= 1
