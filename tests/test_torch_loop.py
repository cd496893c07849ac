"""The PyTorch port's training loop alone (width 0.25, 64x64, batch 2, on
the CPU, the "blobs" synthetic data): the divergence ladder, the loss sequence
across prefetch depths and worker counts, the draw on a second thread,
and the step timer's medians. The fit against the JAX package's is in
`test_torch_fit.py`.

Tolerance: the loss sequence is compared exactly. The same batches reach
the same CPU computation from the same seeded weights, on one intra-op
thread: a CPU step's bits follow how its reductions and convolutions are
split over OpenMP threads (3, 5, 6 or 7 threads give other bits than 8),
so fits that must agree to the bit run with one thread, whatever the
count a region gets on a loaded host. The draws are compared exactly.
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          ResilienceConfig, TrainConfig)
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.train.loop import Trainer, data_stream_seed

STEPS = 4


def _cfg(log_dir, **data_kw):
    return ExperimentConfig(
        width_mult=0.25,
        data=DataConfig(dataset="synthetic", image_size=(64, 64),
                        gt_size=(64, 64), batch_size=2, **data_kw),
        train=TrainConfig(log_every=1, eval_every=2, ckpt_every_steps=2,
                          eval_batch_size=6, log_dir=str(log_dir)))


def _trainer(cfg):
    return Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                   device="cpu")


def _losses(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [r["loss"] for r in map(json.loads, f) if r["kind"] == "train"]


@pytest.fixture(scope="module")
def one_thread():
    """PyTorch's intra-op threads set to one for the fits that must agree
    to the bit, and set back after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def default_losses(one_thread, tmp_path_factory):
    """The train losses of a fit at the default prefetch depth (2) and
    worker count (0)."""
    log_dir = tmp_path_factory.mktemp("default")
    _trainer(_cfg(log_dir)).fit(max_steps=STEPS)
    return _losses(log_dir)


@pytest.mark.parametrize("prefetch,num_workers", [(1, 0), (1, 2), (2, 2)])
def test_loss_sequence_is_the_same_for_any_prefetch_and_workers(
        default_losses, tmp_path, prefetch, num_workers):
    _trainer(_cfg(tmp_path, prefetch=prefetch,
                  num_workers=num_workers)).fit(max_steps=STEPS)
    assert len(default_losses) == STEPS
    assert _losses(tmp_path) == default_losses


@pytest.mark.parametrize("style", ["blobs", "noise"])
def test_draw_on_a_second_thread_equals_the_draw_alone(tmp_path, style):
    """Batch i of a fit is `sample_train(rng=derive_batch_rng(seed, i))`
    on the prefetch thread while the main thread steps: drawn on a second
    thread during train steps, it has the bits of the same draw alone
    ("noise" resizes with PyTorch on the drawing thread)."""
    cfg = _cfg(tmp_path)
    data = SyntheticData(cfg.data, style=style)
    seed = data_stream_seed(cfg.train.seed, 0)

    def draws():
        return [data.sample_train(2, rng=derive_batch_rng(seed, i))
                for i in range(6)]

    alone = draws()
    trainer = Trainer(cfg, dataset=data, device="cpu")
    beside: list[dict] = []
    thread = threading.Thread(target=lambda: beside.extend(draws()))
    thread.start()
    for batch in alone[:2]:
        trainer.train_step(trainer.state, batch)
    thread.join()
    assert len(beside) == len(alone)
    for a, b in zip(alone, beside):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def _ladder_trainer(log_dir, poisoned):
    cfg = _cfg(log_dir)
    cfg = cfg.replace(
        train=dataclasses.replace(cfg.train, eval_every=0),
        resilience=ResilienceConfig(max_consecutive_skips=2))
    trainer = _trainer(cfg)
    draw = trainer._next_train_batch

    def draw_poisoned(it, rng):
        batch = draw(it, rng)
        if poisoned(it):
            batch["source"] = batch["source"].copy()
            batch["source"][0, 0, 0, 0] = np.nan
        return batch

    trainer._next_train_batch = draw_poisoned
    return trainer


def test_poisoned_batch_skips_and_a_streak_rolls_back(tmp_path):
    one = _ladder_trainer(tmp_path / "one", lambda it: it == 2)
    summary = one.fit(max_steps=STEPS)
    assert summary["skipped_updates"] == 1 and "rollbacks" not in summary
    assert one.state.step == STEPS - 1  # the skipped update never applied

    every = _ladder_trainer(tmp_path / "all", lambda it: it >= 2)
    with pytest.raises(FloatingPointError, match="3 consecutive"):
        every.fit(max_steps=50)
    assert every.state.step == 2  # rolled back to the step-2 checkpoint
    with open(tmp_path / "all" / "metrics.jsonl") as f:
        warns = [r["message"] for r in map(json.loads, f)
                 if r["kind"] == "warn"]
    assert sum("rolled back to step 2" in m for m in warns) == 3
    assert sum("skipped in place" in m for m in warns) == 6


def test_step_timer_medians_leave_paused_time_out(monkeypatch):
    """`StepTimer.medians()`: the median tick-to-tick step and phase
    times, over the latest RECENT samples; the tick after a pause only
    re-arms the timer."""
    from deepof_tpu_torch.train import metrics_log

    clock = iter([0.0, 1.0, 3.0, 100.0, 104.0, 105.0])
    monkeypatch.setattr(metrics_log.time, "perf_counter", lambda: next(clock))
    monkeypatch.setattr(metrics_log.StepTimer, "RECENT", 3)
    timer = metrics_log.StepTimer(items_per_step=2)
    timer.tick()  # arms: 0
    timer.tick()  # 1 s
    timer.tick()  # 2 s
    timer.pause()
    timer.tick()  # re-arms at 100
    timer.tick()  # 4 s
    timer.tick()  # 1 s: the latest 3 are 2, 4, 1
    for s in (0.5, 0.1, 0.3, 0.2):
        timer.phase("put", s)
    assert timer.medians() == {"phase_put_ms_median": 200.0,
                               "step_ms_median": 2000.0}
    assert timer.rates()["steps_per_sec"] == 4 / 8
    assert timer.phases() == {"phase_put_s": 1.1}
