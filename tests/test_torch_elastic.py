"""The port's elastic trainer pool (`train/elastic.py`,
`tools/elastic_drill.py`) against the JAX package's
(`tests/test_elastic.py`).

Fast tier: the pure decision functions held to the JAX functions on the
same inputs (the re-form's stream seeds, the heartbeat verdict, the host
chaos hook, the step-skew limiter), the config handoff to a child, the
shared checkpoint directory's single writer and the restore's logged
provenance, `tail`'s rc 5 on the `elastic_*` block, and one drill on the
CPU (2 virtual hosts, one SIGKILLed, ~15 s).

Slow tier (the JAX package's three acceptance drills, ported): 3 hosts
with host 1 SIGKILLed at step 4, the fault-free control, and a plain
fit's SIGTERM saving a verified checkpoint.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import config_from_dict as jax_config_from_dict
from deepof_tpu.parallel.mesh import elastic_stream_seed as jax_stream_seed
from deepof_tpu.resilience.faults import FaultConfig as JaxFaultConfig
from deepof_tpu.resilience.faults import build_injector as jax_injector
from deepof_tpu.train import elastic as JE
from deepof_tpu_torch.analyze import summarize
from deepof_tpu_torch.cli import main
from deepof_tpu_torch.core.config import (ExperimentConfig, OptimConfig,
                                          config_from_dict)
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.obs.heartbeat import Heartbeat
from deepof_tpu_torch.parallel.mesh import elastic_stream_seed
from deepof_tpu_torch.resilience import verify as ckpt_verify
from deepof_tpu_torch.resilience.faults import FaultConfig, build_injector
from deepof_tpu_torch.train import elastic as TE
from deepof_tpu_torch.train.checkpoint import CheckpointManager
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state

torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------- stream-seed re-shard


def test_elastic_stream_seed_deterministic_and_decorrelated():
    """The re-form's determinism contract, the JAX test's checks on the
    port's function, each seed equal to the JAX function's."""
    a = elastic_stream_seed(7, 0, 3, 0, 0)
    np.testing.assert_array_equal(a, elastic_stream_seed(7, 0, 3, 0, 0))
    seeds = set()
    for hosts in (2, 3):
        for host in range(hosts):
            for gen in (0, 1, 2):
                s = elastic_stream_seed(7, host, hosts, gen, 4)
                np.testing.assert_array_equal(
                    s, jax_stream_seed(7, host, hosts, gen, 4))
                seeds.add(tuple(s))
    assert len(seeds) == 2 * 3 + 3 * 3
    draws = {key: tuple(derive_batch_rng(np.array(key, np.uint32), 0)
                        .randint(0, 2**31, 4))
             for key in list(seeds)[:6]}
    assert len(set(draws.values())) == len(draws)
    assert tuple(elastic_stream_seed(2**40 + 5, 0, 2, 0, 0)) != \
        tuple(elastic_stream_seed(5, 0, 2, 0, 0))
    survivor = tuple(elastic_stream_seed(7, 2, 2, 1, 4))
    assert survivor not in seeds
    with pytest.raises(ValueError):
        elastic_stream_seed(0, -1, 3, 0, 0)


# ------------------------------------------------ heartbeat verdicts


def test_host_verdict_gating():
    """The lost-host decision from heartbeat content, held to the JAX
    `host_verdict` on every case of its test."""
    hb = {"pid": 7, "time": 1000.0, "wedged": False, "beats": 3,
          "last_step_age_s": 2.0}
    cases = [
        (hb, 7, 1001.0, 15.0, 45.0, "ok"),
        (None, 7, 1001.0, 15.0, 45.0, "no_heartbeat"),
        (hb, 8, 1001.0, 15.0, 45.0, "foreign_pid"),
        (dict(hb, wedged=True), 7, 1001.0, 15.0, 45.0, "wedged"),
        (hb, 7, 1020.0, 15.0, 45.0, "stale"),
        (dict(hb, last_step_age_s=60.0), 7, 1001.0, 15.0, 45.0, "stalled"),
        # a first call building kernels: zero steps is never a stall
        (dict(hb, beats=0, last_step_age_s=600.0), 7, 1001.0, 15.0, 45.0,
         "ok"),
        # wedge_after_s = 0 disables the content-stall verdict
        (dict(hb, last_step_age_s=600.0), 7, 1001.0, 15.0, 0.0, "ok")]
    for *args, want in cases:
        assert TE.host_verdict(*args) == JE.host_verdict(*args) == want


def test_host_verdict_eval_compile_window_with_pre_eval_flush(tmp_path):
    """The loop's touch(flush=True) at eval entry re-bases the frozen
    heartbeat at the sweep's start (the JAX test's timing, on the port's
    verdict and `Heartbeat`)."""
    stale_after, wedge_after = 15.0, 45.0
    t_eval = 1000.0
    unflushed = {"pid": 7, "time": t_eval - 5.0, "wedged": False,
                 "beats": 3, "last_step_age_s": 12.0}
    assert TE.host_verdict(unflushed, 7, t_eval + 10.1, stale_after,
                           wedge_after) == "stale"
    flushed = {"pid": 7, "time": t_eval, "wedged": False, "beats": 3,
               "last_step_age_s": 0.0}
    for now, want in ((t_eval + 10.1, "ok"),
                      (t_eval + stale_after - 0.1, "ok"),
                      (t_eval + stale_after + 0.1, "stale")):
        assert TE.host_verdict(flushed, 7, now, stale_after,
                               wedge_after) == want
    path = tmp_path / "heartbeat.json"
    hb = Heartbeat(str(path), period_s=3600.0)
    try:
        assert not os.path.exists(path)  # the writer parked for an hour
        hb.beat(4)
        hb.touch(flush=True)
        rec = json.loads(path.read_text())
        assert rec["step"] == 4 and rec["beats"] == 1
        assert rec["last_step_age_s"] < 1.0
    finally:
        hb.close()


# ------------------------------------------------- host chaos hook


@pytest.mark.chaos
def test_maybe_host_fault_arms_at_step_and_fires_once():
    """Host sites keyed by host index, armed at host_fault_step,
    consume-once: the port's hook and the JAX hook act alike on the same
    calls (host_loss SIGKILL, preempt_notice SIGTERM, host_wedge
    block)."""
    acts = {}
    for name, hook, make, cfg in (
            ("torch", TE.maybe_host_fault, build_injector, FaultConfig),
            ("jax", JE.maybe_host_fault, jax_injector, JaxFaultConfig)):
        kills, blocks, msgs = [], [], []
        act = dict(_kill=lambda pid, sig, k=kills: k.append(sig),
                   _block=lambda b=blocks: b.append(True))
        inj = make(cfg(enabled=True, host_loss_at=(1,), host_fault_step=5))
        hook(inj, 1, 4, 5, **act)  # below the arm step
        hook(inj, 0, 9, 5, **act)  # an unscheduled host
        hook(inj, 1, 5, 5, **act)
        hook(inj, 1, 6, 5, **act)  # consume-once
        inj2 = make(cfg(enabled=True, preempt_notice_at=(0,),
                        host_wedge_at=(2,)))
        hook(inj2, 0, 1, 0, log=msgs.append, **act)
        hook(inj2, 2, 1, 0, log=msgs.append, **act)
        hook(None, 1, 9, 0, **act)  # no injector, no elastic host
        hook(inj2, -1, 9, 0, **act)
        acts[name] = (kills, blocks, msgs)
    assert acts["torch"] == acts["jax"]
    kills, blocks, msgs = acts["torch"]
    assert kills == [signal.SIGKILL, signal.SIGTERM] and blocks == [True]
    assert any("preemption notice" in m for m in msgs)
    assert any("wedging" in m for m in msgs)


def test_pace_to_world_step_skew_limiter(tmp_path):
    """The pacing gate blocks only in the same generation and past floor
    + sync_ahead; a missing file, another generation, or the stop flag
    release it; each wait touches the heartbeat. The port's and the JAX
    gate return the same floors and sleep the same ticks."""
    wf = str(tmp_path / "elastic_world.json")

    def write(floor, gen=0, t=None):
        with open(wf, "w") as f:
            json.dump({"generation": gen, "floor": floor, "target": 100,
                       **({} if t is None else {"time": t})}, f)

    def run(fn, gstep, gen=0, stop=lambda: False, touches=None):
        sleeps = []
        got = fn(wf, gen, gstep, 2, should_stop=stop,
                 touch=None if touches is None
                 else lambda: touches.append(True),
                 _sleep=sleeps.append)
        return got, len(sleeps)

    for fn in (TE.pace_to_world, JE.pace_to_world):
        if os.path.exists(wf):
            os.remove(wf)
        assert run(fn, 10) == (None, 0)  # no file: never a dependency
        write(5)
        assert run(fn, 7) == (5, 0)  # at floor + sync_ahead: proceed
        assert run(fn, 8, gen=1) == (None, 0)  # another generation
        write(5, t=time.time() - 3600)
        assert run(fn, 8) == (None, 0)  # a coordinator gone silent
        write(5)
        state, touches = {"n": 0}, []

        def advance():
            state["n"] += 1
            if state["n"] == 3:
                write(9)
            return False

        floor, ticks = run(fn, 8, stop=advance, touches=touches)
        assert floor == 9 and ticks >= 1 and touches
        write(0)
        assert run(fn, 50, stop=lambda: True) == (None, 0)


# ----------------------------------------------------- config handoff


def test_elastic_config_round_trips_to_children():
    """The coordinator -> child config.json handoff carries the elastic
    identity exactly, and a JAX coordinator's child config loads here
    with the same values."""
    cfg = ExperimentConfig().replace(
        elastic=dataclasses.replace(
            ExperimentConfig().elastic, hosts=0, host_index=2, num_hosts=3,
            generation=4, primary_host=1, target_step=100,
            ckpt_dir="/tmp/x/ckpt", virtual_devices=2, wedge_after_s=7.5),
        resilience=dataclasses.replace(
            ExperimentConfig().resilience,
            faults=FaultConfig(enabled=True, host_loss_at=(1,),
                               host_fault_step=5)))
    back = config_from_dict(json.loads(json.dumps(dataclasses.asdict(cfg))))
    assert back == cfg
    assert back.elastic.host_index == 2 and back.elastic.generation == 4
    assert back.resilience.faults.host_loss_at == (1,)
    jcfg = jax_config_from_dict(json.loads(json.dumps(
        dataclasses.asdict(back))))
    assert dataclasses.asdict(jcfg.elastic) == dataclasses.asdict(
        back.elastic)
    with pytest.warns(UserWarning, match="compile_cache"):
        mine = config_from_dict(dataclasses.asdict(JaxConfig().replace(
            elastic=jcfg.elastic)))
    assert mine.elastic == back.elastic


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("virtual_devices", [0, 1])
def test_children_train_on_the_coordinators_device(
        tmp_path, monkeypatch, device, virtual_devices):
    """Every child is `train --device <the coordinator's device>`:
    `elastic.virtual_devices` (JAX's count of CPU devices, which changes
    no result) never moves a child off the card or onto it."""
    spawned = []

    class Proc:
        pid = 1

    monkeypatch.setattr(TE.supervise, "spawn_child",
                        lambda argv, env, out, err: spawned.append(argv)
                        or Proc())
    cfg = ExperimentConfig().replace(
        train=dataclasses.replace(ExperimentConfig().train,
                                  log_dir=str(tmp_path)),
        elastic=dataclasses.replace(ExperimentConfig().elastic,
                                    virtual_devices=virtual_devices))
    coord = TE.ElasticCoordinator(cfg, hosts=2, target_step=3,
                                  device=device)
    for h in coord.hosts.values():
        coord._spawn(h)
    assert [a[a.index("--device") + 1] for a in spawned] == [device] * 2
    assert [a[a.index("--host-index") + 1] for a in spawned] == ["0", "1"]


# ------------------------------- ckpt writer gating + restore provenance


def _state(step: int, val: float):
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    with torch.no_grad():
        for p in model.parameters():
            p.fill_(val)
    st = create_train_state(model, OptimConfig(),
                            step_decay_schedule(OptimConfig(), 1))
    st.step = step
    return st


def test_ckpt_writer_gating_shared_directory(tmp_path):
    """A non-primary host opens the shared directory restore-only: save
    is a no-op returning None, and restore reads the primary's
    commits."""
    primary = CheckpointManager(str(tmp_path / "ckpt"))
    reader = CheckpointManager(str(tmp_path / "ckpt"), writer=False)
    assert reader.save(_state(1, 1.0)) is None
    assert primary.all_steps() == []
    assert primary.save(_state(2, 2.0)) is not None
    got = reader.restore(_state(0, 0.0))
    assert got.step == 2
    assert float(got.model.weight.detach()[0, 0]) == 2.0
    assert reader.stats()["saves"] == 0


def test_restore_logs_provenance(tmp_path):
    """Every restore states which step and why (newest, or fallback after
    corruption), as the JAX manager's messages, so a re-formed run's
    provenance reads from metrics.jsonl alone."""
    msgs = []
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=5,
                            info_log=lambda s, m: msgs.append((s, m)))
    mgr.save(_state(1, 1.0))
    mgr.save(_state(2, 2.0))
    mgr.restore(_state(0, 0.0))
    assert msgs[-1] == (2, "checkpoint restore: step 2 (newest checkpoint)")
    d2 = str(tmp_path / "ckpt" / "step_0000000002")
    victim = max((os.path.getsize(os.path.join(r, f)), os.path.join(r, f))
                 for r, _, fs in os.walk(d2) for f in fs)[1]
    with open(victim, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))
    mgr.restore(_state(0, 0.0))
    assert msgs[-1] == (1, "checkpoint restore: step 1 (fallback after "
                           "corruption: 1 newer candidate(s) failed "
                           "verification/restore)")


# ----------------------------------------------- analyze/tail surfacing


def test_tail_exits_5_surfacing_elastic_reforms(tmp_path, capsys):
    """`tail` exits 5 when the elastic block shows the world re-formed,
    from the heartbeat or from kind="elastic" records."""
    block = {"elastic_hosts": 3, "elastic_live": 3, "elastic_generation": 0,
             "elastic_reforms": 0, "elastic_lost_hosts": 0,
             "elastic_steps_lost": 0, "elastic_resumed_step": 0}
    (tmp_path / "metrics.jsonl").write_text(json.dumps(
        {"kind": "elastic", "step": 5, "time": time.time(), **block}) + "\n")
    (tmp_path / "heartbeat.json").write_text(json.dumps(
        {"time": time.time(), "step": 5, "wedged": False, **block}))
    assert main(["tail", "--log-dir", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["elastic"]["hosts"] == 3
    hurt = dict(block, elastic_generation=1, elastic_reforms=1,
                elastic_lost_hosts=1, elastic_steps_lost=2,
                elastic_resumed_step=4)
    (tmp_path / "heartbeat.json").write_text(json.dumps(
        {"time": time.time(), "step": 9, "wedged": False, **hurt}))
    assert main(["tail", "--log-dir", str(tmp_path)]) == 5
    out = json.loads(capsys.readouterr().out)
    assert out["elastic"]["reforms"] == 1 and out["elastic"]["lost_hosts"] == 1
    (tmp_path / "heartbeat.json").unlink()
    (tmp_path / "metrics.jsonl").write_text(json.dumps(
        {"kind": "elastic", "step": 9, "time": time.time(), **hurt}) + "\n")
    assert main(["tail", "--log-dir", str(tmp_path)]) == 5
    capsys.readouterr()
    assert summarize([{"kind": "elastic", "step": 9, **hurt}])[
        "elastic"]["reforms"] == 1


# ---------------------------------------------------------- the drills


def _run_drill(log_dir, args, timeout=900):
    """The drill tool is the acceptance test: its configuration lives in
    one place (`deepof_tpu_torch/tools/elastic_drill.py`)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    res = subprocess.run(
        [sys.executable, "-m", "deepof_tpu_torch.tools.elastic_drill",
         "--device", "cpu", "--log-dir", str(log_dir), *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)
    out = json.loads(res.stdout) if res.stdout.strip() else {}
    return res.returncode, out, res


def _check_drill(d, out, hosts_done):
    assert out["completed"] is True
    assert out["generation"] == 1 and out["reforms"] == 1
    assert out["lost_hosts"] == 1
    assert out["ckpt_ok"] is True
    assert out["tail_rc"] == 5
    # the barrier save pins the survivors: only the killed host's
    # uncommitted tail is lost, within the checkpoint cadence
    assert 0 <= out["steps_lost"] <= 3, out
    assert out["resumed_step"] >= 1
    assert out["recovery_wall_s"] > 0
    hb = json.loads((d / "heartbeat.json").read_text())
    assert hb["elastic_states"] == {
        **{f"host-{i}": "done" for i in hosts_done}, "host-1": "lost"}
    text = (d / "metrics.jsonl").read_text()
    assert "LOST (crashed" in text and "re-forming" in text
    assert len([ln for ln in text.splitlines()
                if '"kind": "elastic"' in ln]) >= 2
    host_logs = "".join((d / f"host-{i}" / "metrics.jsonl").read_text()
                        for i in hosts_done)
    assert "checkpoint restore: step" in host_logs
    rep = ckpt_verify.verify_run(str(d))
    assert rep["ok"] and out["max_step"] in rep["valid_steps"], rep


@pytest.mark.chaos
def test_drill_of_two_hosts_survives_a_host_loss(tmp_path):
    """The CPU drill of the fast tier: 2 virtual hosts, host 1 SIGKILLed
    at step 3; the coordinator barriers host 0, re-forms on it alone,
    and it trains to step 6 from the shared checkpoint; with
    `obs.metrics_port` its /metrics endpoint comes up and goes down with
    it."""
    d = tmp_path / "drill"
    rc, out, res = _run_drill(
        d, ["--hosts", "2", "--target", "6", "--kill-host", "1",
            "--kill-step", "3", "--ckpt-every", "3", "--timeout", "240",
            "--set", "obs.metrics_port=0"],
        timeout=300)
    assert rc == 0, (res.stdout[-1500:], res.stderr[-3000:])
    assert out["max_step"] == 6 and out["device"] == "cpu"
    _check_drill(d, out, (0,))


@pytest.mark.slow
@pytest.mark.chaos
def test_elastic_drill_survives_host_loss(tmp_path):
    """The JAX acceptance drill: 3 virtual hosts, host 1 SIGKILLed at
    step 4, the run completes to step 10 with no operator."""
    d = tmp_path / "drill"
    rc, out, res = _run_drill(
        d, ["--hosts", "3", "--target", "10", "--kill-host", "1",
            "--kill-step", "4", "--ckpt-every", "3",
            "--fault", "host_loss"])
    assert rc == 0, (res.stdout[-1500:], res.stderr[-3000:])
    assert out["max_step"] == 10
    _check_drill(d, out, (0, 2))


@pytest.mark.slow
@pytest.mark.chaos
def test_elastic_fault_free_run_never_reforms(tmp_path):
    """The control: the same seed without faults reaches the target with
    reforms == 0 and tail rc 0."""
    d = tmp_path / "clean"
    rc, out, res = _run_drill(
        d, ["--hosts", "2", "--target", "6", "--fault", "none"])
    assert rc == 0, (res.stdout[-1500:], res.stderr[-3000:])
    assert out["completed"] is True
    assert (out["reforms"], out["lost_hosts"], out["generation"]) == (0, 0, 0)
    assert out["max_step"] == 6 and out["tail_rc"] == 0
    states = json.loads((d / "heartbeat.json").read_text())["elastic_states"]
    assert all(s == "done" for s in states.values())
    rep = ckpt_verify.verify_run(str(d))
    assert rep["ok"] and 6 in rep["valid_steps"], rep


@pytest.mark.slow
def test_plain_fit_sigterm_saves_verified_ckpt_and_exits_0(tmp_path):
    """Preemption grace for plain training: the first SIGTERM to a
    running fit stops at the next call, saves a verified checkpoint,
    flushes the records, and exits 0."""
    d = tmp_path / "preempt"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    p = subprocess.Popen(
        [sys.executable, "-m", "deepof_tpu_torch", "train", "--preset",
         "flyingchairs", "--synthetic", "--max-steps", "100000",
         "--device", "cpu", "--log-dir", str(d),
         "--set", "model=flownet_s", "--set", "width_mult=0.25",
         "--set", "train.log_every=1", "--set", "train.eval_every=0",
         "--set", "train.ckpt_every_epochs=1000000"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=REPO)
    try:
        deadline = time.monotonic() + 420
        metrics = d / "metrics.jsonl"
        while time.monotonic() < deadline:
            if metrics.exists() and '"kind": "train"' in metrics.read_text():
                break
            if p.poll() is not None:
                raise AssertionError(p.communicate()[1][-3000:])
            time.sleep(0.5)
        else:
            raise AssertionError("no train record within 420s")
        p.send_signal(signal.SIGTERM)
        stdout, stderr = p.communicate(timeout=180)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, (p.returncode, stderr[-3000:])
    text = metrics.read_text()
    assert "stopping after a clean final checkpoint" in text
    summary = json.loads(stdout.strip().splitlines()[-1])
    assert summary["steps_per_sec"] >= 0
    rep = ckpt_verify.verify_run(str(d))
    assert rep["ok"] and rep["valid_steps"], rep
    train_steps = [json.loads(ln)["step"] for ln in text.splitlines()
                   if '"kind": "train"' in ln]
    assert max(rep["valid_steps"]) >= max(train_steps) - 1
