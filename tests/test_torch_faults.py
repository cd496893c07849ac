"""Fault injection in the PyTorch port: the copied `FaultInjector`
against the JAX package's, every wired site firing and recovering in a
CPU `fit` (FlowNet-S, width 0.25, 64x64, batch 2), and the fault and
recovery counters of that fit against the JAX package's `Trainer.fit`
on the same schedule. Counts are integers and compared exactly.
"""

import dataclasses
import json
import os
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import ObsConfig as JaxObsConfig
from deepof_tpu.core.config import ResilienceConfig as JaxResilienceConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.parallel.mesh import local_mesh
from deepof_tpu.resilience import faults as jax_faults
from deepof_tpu.train import loop as jax_loop
from deepof_tpu.train.loop import Trainer as JaxTrainer
from deepof_tpu.train.state import create_train_state as jax_create_state
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.resilience import faults
from deepof_tpu_torch.train.loop import Trainer

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SITES = ("decode", "assemble", "fetch", "ckpt_save", "ckpt_restore",
         "dispatch", "ckpt_truncate", "ckpt_corrupt")


@pytest.mark.parametrize("kw", [
    {"decode_at": (1, 5), "fetch_p": 0.3, "seed": 7},
    {"assemble_p": 0.5, "dispatch_at": (3,), "ckpt_save_at": (2, 4),
     "fail_attempts": 3},
    {"decode_p": 0.1, "ckpt_corrupt_at": (6,), "ckpt_restore_at": (0,),
     "seed": 123, "fail_attempts": 2}])
def test_injector_schedules_the_jax_injectors_hits(kw):
    """The same (site, index) faults, attempt by attempt, and the same
    consume-once acting sites and counters."""
    got = faults.FaultInjector(faults.FaultConfig(enabled=True, **kw))
    want = jax_faults.FaultInjector(jax_faults.FaultConfig(enabled=True,
                                                           **kw))
    for site in SITES:
        for index in range(60):
            assert got.scheduled(site, index) == want.scheduled(site, index)
            for _ in range(4):  # attempts past fail_attempts recover
                outcomes = []
                for inj in (got, want):
                    try:
                        inj.check(site, index)
                        outcomes.append(None)
                    except OSError as e:
                        outcomes.append(str(e))
                assert outcomes[0] == outcomes[1], (site, index)
            assert got.hit(site, index + 100) == want.hit(site, index + 100)
    assert got.stats() == want.stats()
    assert isinstance(faults.InjectedFault("x"), OSError)
    assert faults.build_injector(faults.FaultConfig()) is None


# the schedule of the fits below: a decode fault at micro-batch 1, an
# assemble fault at call 2, a poisoned dispatch at index 3 (the call
# from loop step 3 to 4), a failed read
# of step 2's metrics (index 1), a failed save of the step-0 rollback
# target, and the final checkpoint corrupted after it commits. A
# checkpoint is named by the state's step, which counts applied steps:
# after the skip of step 4, the save at loop step 4 is step 3 and the
# final one (loop step 6) step 5, in both packages
SCHEDULE = {"enabled": True, "decode_at": [1], "assemble_at": [2],
            "dispatch_at": [3], "fetch_at": [1], "ckpt_save_at": [0],
            "ckpt_corrupt_at": [5]}
STEPS = 6
APPLIED = STEPS - 1


def _jax_cfg(log_dir):
    return JaxConfig(
        width_mult=0.25,
        data=JaxDataConfig(dataset="synthetic", image_size=(64, 64),
                           gt_size=(64, 64), batch_size=2),
        train=JaxTrainConfig(log_every=1, eval_every=0, ckpt_every_steps=4,
                             log_dir=str(log_dir)),
        resilience=JaxResilienceConfig(
            data_backoff_s=0.0,
            faults=jax_faults.FaultConfig(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in SCHEDULE.items()})),
        obs=JaxObsConfig(heartbeat=False, flops=False, ledger=False))


def _create_state_jitted(model, example_input, tx, seed=0, log=None):
    """The JAX `create_train_state` with the flax init under `jax.jit`
    (op by op it takes ~18 s on the CPU)."""
    return jax_create_state(types.SimpleNamespace(init=jax.jit(model.init)),
                            example_input, tx, seed=seed, log=log)


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


COUNTERS = ("skipped_updates", "data_sample_retries", "data_retries",
            "data_quarantined", "pipeline_fetch_retries",
            "ckpt_save_failures", "ckpt_saves")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("faults")
    jcfg = _jax_cfg(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", _create_state_jitted)
        jt = JaxTrainer(jcfg, dataset=JaxSynthetic(jcfg.data, style="blobs"),
                        mesh=local_mesh(1))
    want = jt.fit(max_steps=STEPS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pcfg = config_from_dict(dataclasses.asdict(jcfg.replace(
            train=dataclasses.replace(jcfg.train,
                                      log_dir=str(root / "port")))))
    pt = Trainer(pcfg, dataset=SyntheticData(pcfg.data, style="blobs"),
                 device="cpu")
    got = pt.fit(max_steps=STEPS)
    return {"root": root, "cfg": pcfg, "summary": (got, want),
            "steps": (pt.state.step, int(jt.state.step))}


def test_every_site_fires_and_the_fit_recovers(fits):
    got, _ = fits["summary"]
    assert fits["steps"][0] == APPLIED
    assert {k: got[f"fault_{k}"] for k in (
        "decode", "assemble", "dispatch", "fetch", "ckpt_save",
        "ckpt_corrupt")} == dict.fromkeys(
            ("decode", "assemble", "dispatch", "fetch", "ckpt_save",
             "ckpt_corrupt"), 1)
    # decode retried in the sampler, assemble on the pipeline, the
    # poisoned step skipped in place, the read retried, the save degraded
    assert got["data_sample_retries"] == 1 and got["data_quarantined"] == 0
    assert got["data_retries"] == 1
    assert got["skipped_updates"] == 1 and got.get("rollbacks", 0) == 0
    assert got["pipeline_fetch_retries"] == 1
    assert got["ckpt_save_failures"] == 1
    recs = _records(fits["root"] / "port")
    warns = [r["message"] for r in recs if r["kind"] == "warn"]
    assert any("checkpoint save failed at step 0" in w for w in warns)
    assert any("poisoned with NaN" in w for w in warns)
    assert any("fault injection: corrupt" in w and f"step {APPLIED}" in w
               for w in warns)
    train = [r for r in recs if r["kind"] == "train"]
    # dispatch index 3 is the call from loop step 3 to 4: step 4 is
    # skipped and logs no record; every other step does
    assert [r["step"] for r in train] == [1, 2, 3, 5, 6]
    assert all(np.isfinite(r["loss"]) for r in train)


def test_a_corrupted_final_checkpoint_falls_back_on_restore(fits):
    """The next Trainer in the run's directory finds the final checkpoint
    (step 5) damaged and resumes from step 3, the newest one that
    verifies."""
    cfg = fits["cfg"].replace(resilience=dataclasses.replace(
        fits["cfg"].resilience, faults=faults.FaultConfig()))
    pt = Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                 device="cpu")
    assert pt.state.step == 3
    stats = pt.ckpt.stats()
    assert stats["verify_failures"] == 1 and stats["restore_fallbacks"] == 1


def test_fault_counters_match_the_jax_fit(fits):
    got, want = fits["summary"]
    assert fits["steps"] == (APPLIED, APPLIED)
    fault_keys = sorted(k for k in want if k.startswith("fault_"))
    assert fault_keys == sorted(k for k in got if k.startswith("fault_"))
    assert {k: got[k] for k in fault_keys} == {k: want[k] for k in fault_keys}
    assert {k: got.get(k, 0) for k in COUNTERS} == \
        {k: want.get(k, 0) for k in COUNTERS}
