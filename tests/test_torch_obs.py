"""The PyTorch port's observability of the training loop (`obs/`) against
the JAX package's: after a CPU fit with `obs.trace` on in both packages
(FlowNet-S, width 0.25, 64x64, batch 2, an eval and a checkpoint), the
port's trace.json holds the JAX trace's span names and its
heartbeat.json the JAX heartbeat's keys; the watchdog on a forced stall;
the telemetry of train records; `obs.flops` leaving the losses as they
are; and the FLOP count against the JAX package's cost analysis.

Key sets and counts are compared exactly; the losses bit for bit (one
intra-op thread). The FLOP count is held to a band set by what each
counter sees (`test_flop_count_against_the_jax_cost_analysis`).
"""

import collections
import dataclasses
import json
import os
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import ObsConfig as JaxObsConfig
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.obs.telemetry import step_flops as jax_step_flops
from deepof_tpu.parallel.mesh import local_mesh
from deepof_tpu.train import loop as jax_loop
from deepof_tpu.train.loop import Trainer as JaxTrainer
from deepof_tpu.train.schedule import step_decay_schedule as jax_schedule
from deepof_tpu.train.state import TrainState as JaxTrainState
from deepof_tpu.train.state import create_train_state as jax_create_state
from deepof_tpu.train.state import make_optimizer as jax_optimizer
from deepof_tpu.train.step import make_train_step as jax_make_train_step
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          ObsConfig, TrainConfig,
                                          config_from_dict)
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.obs.telemetry import (NOMINAL_BF16_TFLOPS, count_flops,
                                            device_memory_summary)
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.schedule import step_decay_schedule
from deepof_tpu_torch.train.state import create_train_state
from deepof_tpu_torch.train.step import make_train_step

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HW = (64, 64)
STEPS = 4
#: heartbeat keys only the port has: the checkpoint saves' seconds
PORT_ONLY_KEYS = {"ckpt_save_s_total", "ckpt_save_s_max"}
#: event counters present only once their event happened (a measurably
#: starved input wait), in either package
TIMING_COUNTERS = {"starved"}
TELEMETRY_KEYS = {"dev_mem_bytes_in_use", "dev_mem_peak_bytes",
                  "rss_bytes", "model_tflops", "mfu_nominal"}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_cfg(log_dir):
    return JaxConfig(
        width_mult=0.25,
        data=JaxDataConfig(dataset="synthetic", image_size=HW, gt_size=HW,
                           batch_size=2),
        train=JaxTrainConfig(log_every=1, eval_every=STEPS,
                             ckpt_every_steps=2, eval_batch_size=16,
                             log_dir=str(log_dir)),
        obs=JaxObsConfig(trace=True, heartbeat=True, flops=False,
                         ledger=False))


def _create_state_jitted(model, example_input, tx, seed=0, log=None):
    """The JAX `create_train_state` with the flax init under `jax.jit`
    (op by op it takes ~18 s on the CPU)."""
    return jax_create_state(types.SimpleNamespace(init=jax.jit(model.init)),
                            example_input, tx, seed=seed, log=log)


def _port_cfg(jcfg, log_dir):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return config_from_dict(dataclasses.asdict(jcfg.replace(
            train=dataclasses.replace(jcfg.train, log_dir=str(log_dir)))))


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _spans(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(e["name"] for e in events if e["ph"] == "X")


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs")
    jcfg = _jax_cfg(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", _create_state_jitted)
        jt = JaxTrainer(jcfg, dataset=JaxSynthetic(jcfg.data, style="blobs"),
                        mesh=local_mesh(1))
    jt.fit(max_steps=STEPS)
    pcfg = _port_cfg(jcfg, root / "port")
    assert pcfg.obs.trace and pcfg.obs.heartbeat
    pt = Trainer(pcfg, dataset=SyntheticData(pcfg.data, style="blobs"),
                 device="cpu")
    pt.fit(max_steps=STEPS)
    return root


def test_trace_has_the_jax_span_names(fits):
    got, want = _spans(fits / "port"), _spans(fits / "jax")
    assert set(got) == set(want) == {"input_wait", "dispatch", "fetch",
                                     "put", "assemble", "eval", "ckpt"}
    # one a step on the main thread; one a read (a step here, a record
    # there: log_every = 1); one eval and two cadence checkpoints
    for name in ("input_wait", "dispatch", "fetch", "eval", "ckpt"):
        assert got[name] == want[name], name
    with open(fits / "port" / "trace.json") as f:
        trace = json.load(f)
    threads = {e["args"]["name"] for e in trace["traceEvents"]
               if e["name"] == "thread_name"}
    assert {"MainThread", "prefetch"} <= threads
    assert trace["otherData"]["role"] == "trainer"


def test_heartbeat_has_the_jax_heartbeat_keys(fits):
    with open(fits / "port" / "heartbeat.json") as f:
        got = json.load(f)
    with open(fits / "jax" / "heartbeat.json") as f:
        want = json.load(f)
    assert set(got) - TIMING_COUNTERS == \
        (set(want) - TIMING_COUNTERS) | PORT_ONLY_KEYS
    assert got["step"] == want["step"] == STEPS
    assert got["wedges"] == 0 and got["dev_mem_bytes_in_use"] is None


def test_the_watchdog_fires_once_on_a_stall(tmp_path):
    """A step of a few milliseconds (the model's work left out, so a
    loaded host cannot stretch it past the threshold) and one stalled
    call of 4 s, over a 1.5 s floor."""
    cfg = ExperimentConfig(
        width_mult=0.25,
        data=DataConfig(dataset="synthetic", image_size=HW, batch_size=2),
        train=TrainConfig(log_every=1, eval_every=0, log_dir=str(tmp_path)),
        obs=ObsConfig(heartbeat_period_s=0.05, watchdog_factor=1.0,
                      watchdog_min_s=1.5, flops=False))
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                      device="cpu")
    calls = {"n": 0}
    metrics = {"total": 1.0, "grad_norm": 1.0, "update_skipped": 0.0,
               **{f"scale_{k}": [1.0] * 6 for k in (
                   "total", "Charbonnier_reconstruct", "U_loss", "V_loss",
                   "smooth")}}

    def stalling(state, batch):
        calls["n"] += 1
        if calls["n"] == 5:  # after the watchdog armed (3 beats)
            import time

            time.sleep(4.0)
        return metrics

    trainer.train_step = stalling
    trainer.fit(max_steps=7)
    assert calls["n"] == 7
    dogs = [r["message"] for r in _records(tmp_path)
            if r["kind"] == "warn" and "WATCHDOG" in r["message"]]
    assert len(dogs) == 1
    assert "--- thread MainThread" in dogs[0] and "stalling" in dogs[0]
    with open(tmp_path / "heartbeat.json") as f:
        hb = json.load(f)
    assert hb["wedges"] == 1 and not hb["wedged"] and hb["step"] == 7


def _fit_losses(log_dir, flops):
    cfg = ExperimentConfig(
        width_mult=0.25,
        data=DataConfig(dataset="synthetic", image_size=HW, batch_size=2),
        train=TrainConfig(log_every=1, eval_every=0, log_dir=str(log_dir)),
        obs=ObsConfig(flops=flops, heartbeat=False))
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                      device="cpu")
    summary = trainer.fit(max_steps=3)
    train = [r for r in _records(log_dir) if r["kind"] == "train"]
    return [r["loss"] for r in train], train, summary, trainer


def test_flops_counting_leaves_the_losses_and_carries_telemetry(
        tmp_path, one_thread):
    on, records, summary, trainer = _fit_losses(tmp_path / "on", True)
    off, plain, _, _ = _fit_losses(tmp_path / "off", False)
    assert on == off  # bit for bit: counting adds no step, update or draw
    assert trainer.state.step == 3 and trainer._flops_per_step > 0
    for r in records:
        assert {"dev_mem_bytes_in_use", "dev_mem_peak_bytes",
                "rss_bytes"} <= set(r)
        assert r["dev_mem_bytes_in_use"] is None and r["rss_bytes"] > 0
    # the first record comes before the rate's first timed step
    timed = [r for r in records if r["steps_per_sec"] > 0]
    assert timed and all(TELEMETRY_KEYS <= set(r) for r in timed)
    for r in timed:
        assert r["mfu_nominal"] == pytest.approx(
            r["model_tflops"] / NOMINAL_BF16_TFLOPS, rel=1e-3)
    assert not any("model_tflops" in r for r in plain)
    assert summary["model_tflops"] > 0 and "dev_mem_peak_bytes" not in summary
    assert device_memory_summary("cpu") == {"dev_mem_bytes_in_use": None,
                                            "dev_mem_peak_bytes": None}


def test_flop_count_against_the_jax_cost_analysis():
    """FlopCounterMode counts the convolutions and transposed
    convolutions, forward and backward, and nothing else; XLA's cost
    analysis counts every operator of the same step (the loss, the
    resizes, the warps, Adam). The convolutions dominate both: for
    FlowNet-S at width 0.25, 64x64, batch 2 the port's count was measured
    at 1.017 of the JAX package's (300,782,784 against 295,665,312), and
    is held to within 10% of it."""
    jm = jax_build_model("flownet_s", width_mult=0.25)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, *HW, 6)))["params"]
    jcfg = JaxConfig(width_mult=0.25,
                     data=JaxDataConfig(dataset="synthetic", image_size=HW,
                                        batch_size=2))
    tx = jax_optimizer(jcfg.optim, jax_schedule(jcfg.optim, 1))
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1), tx=tx)
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=HW))
    batch = ds.sample_train(2, rng=derive_batch_rng(np.array([0, 0],
                                                             np.uint32), 0))
    jbatch = {k: jnp.asarray(batch[k]) for k in ("source", "target")}
    want = jax_step_flops(jax_make_train_step(jm, jcfg, (0.0, 0.0, 0.0),
                                              local_mesh(1)),
                          jstate, jbatch)
    cfg = ExperimentConfig(width_mult=0.25)
    model = build_model("flownet_s", width_mult=0.25, device="cpu")
    load_flax_params(model, jax.tree_util.tree_map(np.asarray, params))
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    _, got = count_flops(lambda: make_train_step(model, cfg, (0.0,) * 3)(
        state, batch))
    ratio = got / want
    assert 0.9 <= ratio <= 1.1, (got, want, ratio)


def test_the_carried_obs_and_train_keys_are_no_longer_dropped():
    with pytest.warns(UserWarning, match="ignored keys") as rec:
        cfg = config_from_dict(dataclasses.asdict(JaxConfig()))
    ignored = str(rec[0].message)
    for key in ("train.steps_per_call", "train.remat",
                "train.pipeline_depth", "resilience.fetch_retries",
                "obs.trace'", "obs.trace_ring", "obs.heartbeat'",
                "obs.heartbeat_period_s", "obs.watchdog_factor",
                "obs.watchdog_min_s", "obs.flops",
                # the quality and incident planes are ported
                "obs.quality_sample_rate", "obs.incidents'",
                "obs.incident_keep", "obs.alerts",
                # and the executable ledger (obs/ledger.py)
                "obs.ledger"):
        assert key not in ignored, key
    # the mesh, the elastic pool and the metrics port are carried (item
    # 10); the XLA compile cache, which changes no result, stays
    # dropped, named
    for key in ("'mesh", "'elastic", "obs.metrics_port"):
        assert key not in ignored, key
    assert "train.compile_cache" in ignored
    want = JaxConfig()
    assert dataclasses.asdict(cfg.elastic) == dataclasses.asdict(
        want.elastic)
    assert dataclasses.asdict(cfg.mesh) == dataclasses.asdict(want.mesh)
    assert cfg.obs.ledger is True  # the JAX default
    assert cfg.obs == ObsConfig() and cfg.train.pipeline_depth == 2


def test_trace_and_profile_flags_write_their_files(tmp_path, capsys):
    """`--trace` turns `obs.trace` on; `--profile-steps a:b` writes a
    torch.profiler Chrome trace of those steps under <log-dir>/profile."""
    from deepof_tpu_torch import cli

    log_dir = tmp_path / "run"
    assert cli.main(["train", "--synthetic", "--model", "flownet_s",
                     "--device", "cpu", "--steps", "3", "--set",
                     "width_mult=0.25", "--set", "obs.heartbeat=false",
                     "--trace", "--profile-steps", "1:2",
                     "--log-dir", str(log_dir)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "pipeline_depth"] == 2  # the default, as in JAX
    assert _spans(log_dir)["dispatch"] == 3
    with open(log_dir / "profile" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with pytest.raises(SystemExit, match="0 <= A < B"):
        cli.main(["train", "--synthetic", "--model", "flownet_s",
                  "--device", "cpu", "--profile-steps", "3:1",
                  "--log-dir", str(tmp_path / "bad")])
