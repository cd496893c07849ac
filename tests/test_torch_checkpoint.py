"""The PyTorch port's checkpoints: save -> restore is bitwise (parameters,
Adam moments, step), `keep` pruning, fallback past a corrupted newest
checkpoint, refusal to restart when none restores, the manifest report
against the JAX package's `verify_run`, and `train.init_from`."""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

from deepof_tpu.resilience.verify import verify_run as jax_verify_run
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          OptimConfig, TrainConfig)
from deepof_tpu_torch.resilience.verify import verify_run
from deepof_tpu_torch.train.checkpoint import (PAYLOAD, CheckpointManager,
                                               transfer_params)
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.state import create_train_state


def _cfg(log_dir, **train_kw):
    return ExperimentConfig(
        width_mult=0.25,
        data=DataConfig(dataset="synthetic", image_size=(64, 64),
                        batch_size=2),
        optim=OptimConfig(learning_rate=1e-3),
        train=TrainConfig(log_dir=str(log_dir), **train_kw))


def _small_state(seed=0, step=0):
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 2))
    state = create_train_state(model, OptimConfig(learning_rate=1e-2),
                               lambda s: 1e-2)
    for _ in range(2):  # Adam moments exist after an update
        state.optimizer.zero_grad()
        model(torch.randn(5, 3)).square().sum().backward()
        state.apply_gradients(1.0)
    state.step = step
    return state


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _flip_byte(ckpt_dir, step):
    """Flip the payload's first byte (the archive's first header): a
    byte in raw tensor data would load unnoticed, and where that data
    lies depends on what the payload holds."""
    path = os.path.join(ckpt_dir, f"step_{step:010d}", PAYLOAD)
    with open(path, "r+b") as f:
        b = f.read(1)
        f.seek(0)
        f.write(bytes([b[0] ^ 0xFF]))


def test_save_restore_is_bitwise(tmp_path):
    trainer = Trainer(_cfg(tmp_path, nan_guard=False), device="cpu")
    trainer.fit(max_steps=2)  # saves its final state at step 2
    resumed = Trainer(_cfg(tmp_path, nan_guard=False), device="cpu")
    assert resumed.state.step == trainer.state.step == 2
    for (name, a), b in zip(trainer.model.state_dict().items(),
                            resumed.model.state_dict().values()):
        assert torch.equal(a, b), name
    want = trainer.state.optimizer.state_dict()
    got = resumed.state.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    assert len(want["state"]) == len(list(trainer.model.parameters()))
    for i, moments in want["state"].items():
        for k, v in moments.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    assert any(r["message"] == "resumed from step 2"
               for r in _records(tmp_path) if r["kind"] == "info")


def test_keep_prunes_old_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3, 4):
        assert mgr.save(_small_state(step=step)) is not None
    assert mgr.all_steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == [
        "step_0000000003", "step_0000000003.manifest.json",
        "step_0000000004", "step_0000000004.manifest.json"]
    assert mgr.stats()["saves"] == 4
    assert 0 < mgr.stats()["save_s_max"] <= mgr.stats()["save_s_total"]
    # a re-save of a step replaces it
    mgr.save(_small_state(seed=1, step=4))
    assert mgr.all_steps() == [3, 4]


def test_corrupt_newest_falls_back_to_the_previous_step(tmp_path):
    warned = []
    mgr = CheckpointManager(str(tmp_path), log=lambda s, m: warned.append(m))
    mgr.save(_small_state(seed=0, step=1))
    mgr.save(_small_state(seed=1, step=2))
    _flip_byte(str(tmp_path), 2)
    template = _small_state(seed=2)
    assert mgr.restore(template) is template
    assert template.step == 1
    want = _small_state(seed=0, step=1)
    for a, b in zip(template.model.parameters(), want.model.parameters()):
        assert torch.equal(a, b)
    assert mgr.stats()["verify_failures"] == 1
    assert mgr.stats()["restore_fallbacks"] == 1
    assert any("checksum mismatch" in m for m in warned)
    assert any("fallback after corruption" in m for m in warned)
    # without verification the corrupt payload reaches the reader, which
    # fails, and the fallback still lands on step 1
    unchecked = CheckpointManager(str(tmp_path), verify=False,
                                  log=lambda s, m: warned.append(m))
    assert unchecked.restore(_small_state(seed=2)).step == 1


def test_a_missing_manifest_restores_unverified(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(_small_state(step=3))
    os.remove(tmp_path / "step_0000000003.manifest.json")
    assert mgr.restore(_small_state(seed=1)).step == 3
    assert verify_run(str(tmp_path))["unverified_steps"] == [3]


def test_all_corrupt_refuses_to_restart(tmp_path):
    trainer = Trainer(_cfg(tmp_path), device="cpu")
    trainer.fit(max_steps=1)  # checkpoints at 0 (nan_guard) and 1
    ckpt_dir = os.path.join(tmp_path, "ckpt")
    assert CheckpointManager(ckpt_dir).all_steps() == [0, 1]
    for step in (0, 1):
        _flip_byte(ckpt_dir, step)
    with pytest.raises(RuntimeError, match="none is restorable"):
        Trainer(_cfg(tmp_path), device="cpu")


def test_verify_run_report_matches_jax(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    for step in (1, 2, 3):
        mgr.save(_small_state(step=step))
    _flip_byte(str(tmp_path / "ckpt"), 2)
    os.remove(tmp_path / "ckpt" / "step_0000000003.manifest.json")
    got, want = verify_run(str(tmp_path)), jax_verify_run(str(tmp_path))
    assert got == want
    assert (got["valid_steps"], got["corrupt_steps"],
            got["unverified_steps"], got["ok"]) == ([1], [2], [3], False)


def test_transfer_params_copies_matching_shapes():
    target = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    source = {"a": torch.ones(2, 3), "b": torch.ones(5), "d": torch.ones(1)}
    out, copied, skipped = transfer_params(target, source)
    assert (copied, skipped) == (1, 2)
    assert torch.equal(out["a"], torch.ones(2, 3))
    assert torch.equal(out["b"], torch.zeros(4))
    assert out["c"] is target["c"]


def test_init_from_transfers_on_fresh_starts_only(tmp_path):
    src_dir, dst_dir = tmp_path / "src", tmp_path / "dst"
    src = Trainer(_cfg(src_dir, nan_guard=False), device="cpu")
    src.fit(max_steps=1)
    cfg = _cfg(dst_dir, nan_guard=False, init_from=str(src_dir),
               seed=7)  # another init: only the transfer makes them equal
    dst = Trainer(cfg, device="cpu")
    n = len(dst.model.state_dict())
    for (name, a), b in zip(src.model.state_dict().items(),
                            dst.model.state_dict().values()):
        assert torch.equal(a, b), name
    assert dst.state.step == 0
    assert any(r.get("message") == f"transfer init from {src_dir}: {n} "
               "tensors copied, 0 re-init" for r in _records(dst_dir))
    dst.fit(max_steps=1)
    before = {k: v.clone() for k, v in dst.model.state_dict().items()}
    again = Trainer(cfg, device="cpu")  # resumes: no second transfer
    assert again.state.step == 1
    for k, v in again.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    with pytest.raises(FileNotFoundError, match="init_from"):
        Trainer(_cfg(tmp_path / "other", init_from=str(tmp_path / "none")),
                device="cpu")
    assert np.isfinite(dst.evaluate()["aee"])
