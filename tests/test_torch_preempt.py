"""Preemption-graceful stop in the PyTorch port's `Trainer.fit`
(FlowNet-S, width 0.25, 64x64, batch 2, on the CPU, one intra-op
thread): a SIGTERM to a training subprocess saves a verified checkpoint
and exits 0, and the resumed run's losses equal those of a run stopped at
the same step without a signal, bit for bit; a second SIGTERM kills a
wedged run; a SIGTERM latched before `fit` stops it before its first
step.

A fit draws its batches from (seed, its start step), so a resumed run is
compared with a run segmented at the same step, not with one fit: the
signal must leave nothing behind that a clean stop would not (the
optimizer, the accumulator under grad_accum = 2, the step).

The subprocess half is this file run as a script:
    python tests/test_torch_preempt.py fit|wedge <log_dir>
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOTAL = 12
# the step after which the parent sends its signal
SIGNAL_AT = 3


def _cfg(log_dir):
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              ObsConfig, OptimConfig,
                                              TrainConfig)

    return ExperimentConfig(
        width_mult=0.25,
        optim=OptimConfig(learning_rate=1e-3, grad_accum=2),
        data=DataConfig(dataset="synthetic", image_size=(64, 64),
                        gt_size=(64, 64), batch_size=2),
        train=TrainConfig(log_every=1, eval_every=0, ckpt_every_steps=4,
                          log_dir=str(log_dir)),
        obs=ObsConfig(heartbeat_period_s=0.05, flops=False))


def _trainer(log_dir):
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.train.loop import Trainer

    cfg = _cfg(log_dir)
    return Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                   device="cpu")


def _worker(mode: str, log_dir: str) -> None:
    torch.set_num_threads(1)
    trainer = _trainer(log_dir)
    step = trainer.train_step

    def paced(state, batch):
        if mode == "wedge" and state.step >= 1:
            # a main-thread wedge: the handler runs, but the loop never
            # reaches its boundary to read the stop flag
            print("WEDGED", flush=True)
            time.sleep(600)
        out = step(state, batch)
        time.sleep(0.3)  # room for the parent's signal between steps
        return out

    trainer.train_step = paced
    trainer.fit(max_steps=TOTAL)


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _spawn(mode, log_dir):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(log_dir)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        text=True)


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)
                if r["kind"] == "train"]


def _wait_for(pred, proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        if proc.poll() is not None:
            raise AssertionError(f"worker exited early: rc {proc.returncode}")
        time.sleep(0.05)
    raise AssertionError("timed out")


def _heartbeat_step(log_dir):
    try:
        with open(os.path.join(log_dir, "heartbeat.json")) as f:
            return json.load(f)["step"]
    except (OSError, ValueError, KeyError):
        return -1


def test_sigterm_saves_and_the_resume_continues_as_a_clean_stop(
        tmp_path, one_thread):
    from deepof_tpu_torch.resilience.verify import verify_run

    run = tmp_path / "run"
    proc = _spawn("fit", run)
    try:
        _wait_for(lambda: _heartbeat_step(run) >= SIGNAL_AT, proc)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == 0
    records = [json.loads(ln) for ln in open(run / "metrics.jsonl")]
    assert any("signal 15 received" in r.get("message", "")
               for r in records)
    stop = records[-1]["step"]
    assert SIGNAL_AT <= stop < TOTAL
    report = verify_run(str(run))
    assert report["ok"] and max(report["valid_steps"]) == stop
    # the resume in the same directory, to the run's end
    resumed = _trainer(run)
    assert resumed.state.step == stop
    assert resumed.state.mini_step == stop % 2  # the accumulator came back
    resumed.fit(max_steps=TOTAL - stop)
    # the same two fits with a clean stop at `stop`
    ref_dir = tmp_path / "ref"
    _trainer(ref_dir).fit(max_steps=stop)
    _trainer(ref_dir).fit(max_steps=TOTAL - stop)
    got, want = _losses(run), _losses(ref_dir)
    assert [s for s, _ in want] == list(range(1, TOTAL + 1))
    assert got == want  # bit for bit


def test_a_second_sigterm_kills_a_wedged_run(tmp_path):
    proc = _spawn("wedge", tmp_path / "run")
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "WEDGED" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        assert "WEDGED" in line
        proc.send_signal(signal.SIGTERM)  # latched by fit's handler
        time.sleep(0.5)
        assert proc.poll() is None
        proc.send_signal(signal.SIGTERM)  # falls through: default action
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert rc == -signal.SIGTERM


def test_an_early_sigterm_stops_fit_before_its_first_step(tmp_path):
    from deepof_tpu_torch.train import loop

    prev = signal.getsignal(signal.SIGTERM)
    loop.install_preemption_latch()
    try:
        os.kill(os.getpid(), signal.SIGTERM)  # latched, not fatal
        assert loop._EARLY_SIGTERM["sig"] == signal.SIGTERM
        trainer = _trainer(tmp_path)
        trainer.fit(max_steps=10)
        assert trainer.state.step == 0
        assert trainer.ckpt.latest_step() == 0
        assert loop._EARLY_SIGTERM["sig"] is None  # consumed
        # the latch is not re-armed: after fit a SIGTERM must kill
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
        assert not _losses(tmp_path)
        assert np.isfinite(trainer.state.schedule(0))
    finally:
        signal.signal(signal.SIGTERM, prev)
        loop._EARLY_SIGTERM["sig"] = None


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], sys.argv[2])
