"""The port's metric fetchers (`train/metrics_log.py`: `AsyncFetcher`,
`SyncFetcher`, `HostStager`) and the loop's fetch cadence, against the
JAX package's loop.

  - the fetchers' contract, as the JAX fetcher's own tests pin it: the
    depth bound and `max_in_flight` (2 under a slow fetch at depth 2),
    an error raised again on the next call, the drain timeout, the
    ``fetch`` fault site's index in submit order;
  - a FlowNet-S fit (width 0.25, 64x64, batch 2) with a dispatch fault
    at depth 2 and a skip streak of 1, so the skipped step rolls back,
    from the JAX run's weights: its record steps and skip and rollback
    counts equal the JAX loop's at depth 2, its losses the JAX loop's at
    rtol 1e-4 (`test_torch_fit.py`'s), and its own run at depth 0 bit
    for bit.
The device-side skip under gradient accumulation against the JAX state
is in `test_torch_device_skip.py`.
"""

import dataclasses
import json
import os
import threading
import time
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
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.data.datasets import SyntheticData
from deepof_tpu_torch.resilience.faults import FaultConfig, FaultInjector
from deepof_tpu_torch.train.loop import Trainer
from deepof_tpu_torch.train.metrics_log import (AsyncFetcher, HostStager,
                                                StepTimer, SyncFetcher)

FETCH_DELAY = 0.05


def _slow(tree):
    time.sleep(FETCH_DELAY)
    return tree


# ---------------------------------------------------------- the fetchers


def test_depth_bounds_the_fetches_in_flight_and_reaches_it():
    """At depth 2 under a slow fetch, 2 fetches are in flight at once and
    never more; at depth 1 the submits wait the fetches out."""
    done = []
    f = AsyncFetcher(depth=2, fetch_fn=_slow)
    for i in range(6):
        f.submit(i, {"total": i}, lambda tag, host: done.append(tag))
    assert f.drain()
    f.close()
    assert done == list(range(6))  # FIFO
    assert f.stats()["max_in_flight"] == 2
    assert f.stats()["fetches"] == 6
    one = AsyncFetcher(depth=1, fetch_fn=_slow)
    t0 = time.perf_counter()
    for i in range(4):
        one.submit(i, i, lambda tag, host: None)
    waited = time.perf_counter() - t0
    one.drain()
    one.close()
    assert waited > 2 * FETCH_DELAY
    assert one.stats()["max_in_flight"] == 1


@pytest.mark.parametrize("where", ["fetch", "callback"])
def test_an_error_is_raised_again_on_the_next_call(where):
    def fetch(tree):
        if where == "fetch":
            raise ValueError("fetch exploded")
        return tree

    def callback(tag, host):
        if where == "callback":
            raise ValueError("callback exploded")

    f = AsyncFetcher(depth=2, fetch_fn=fetch)
    f.submit(0, 0, callback)
    with pytest.raises(ValueError, match=f"{where} exploded"):
        f.drain()
    assert f.drain()  # raised once
    f.submit(1, 1, callback)
    deadline = time.monotonic() + 30
    while f._in_flight and time.monotonic() < deadline:
        time.sleep(0.01)  # until the consumer has stored its error
    with pytest.raises(ValueError, match=f"{where} exploded"):
        f.submit(2, 2, lambda *a: None)
    f.close()


def test_drain_times_out_and_close_does_not_wait_on_a_wedged_fetch():
    wedged = threading.Event()

    def hang(tree):
        wedged.set()
        time.sleep(1.0)  # far past the drain's timeout
        return tree

    f = AsyncFetcher(depth=1, fetch_fn=hang)
    f.submit(0, 0, lambda *a: None)
    assert wedged.wait(5.0)
    t0 = time.perf_counter()
    assert f.drain(timeout=0.2) is False
    f.close()
    assert time.perf_counter() - t0 < 10.0


@pytest.mark.parametrize("depth", [0, 2])
def test_the_fetch_fault_index_is_the_submit_order(depth):
    """`fetch_at=(1,)`: the second submitted fetch fails once and is
    retried; the values and the callbacks are unaffected."""
    inj = FaultInjector(FaultConfig(enabled=True, fetch_at=(1,),
                                    fail_attempts=1))
    timer = StepTimer(1)
    kw = dict(timer=timer, retries=2, backoff_s=0.0, injector=inj)
    f = AsyncFetcher(depth=depth, **kw) if depth else SyncFetcher(**kw)
    got = []
    for i in range(3):
        f.submit(i, {"total": torch.tensor(float(i)),
                     "scale_total": torch.arange(3.0) + i},
                 lambda tag, m: got.append((tag, m)))
    assert f.drain(timeout=10.0)
    f.close()
    assert [t for t, _ in got] == [0, 1, 2]
    for i, (_, m) in enumerate(got):
        assert m["total"].shape == () and float(m["total"]) == i
        np.testing.assert_array_equal(m["scale_total"], np.arange(3.0) + i)
    assert f.stats()["fetch_retries"] == 1 and inj.stats()["fetch"] == 1
    assert f.stats()["fetches"] == 3
    assert "phase_fetch_s" in timer.phases()


def test_host_stager_keeps_shapes_and_numbers():
    stager = HostStager(slots=3)
    tree = {"total": torch.tensor(2.5), "grad_norm": 7.0,
            "update_skipped": torch.tensor([0.0, 1.0]),
            "scale_smooth": torch.arange(12.0).reshape(2, 6)}
    host = stager.read(stager.stage(tree))
    assert list(host) == list(tree)
    for k, v in tree.items():
        np.testing.assert_array_equal(host[k], np.asarray(v), err_msg=k)
        assert host[k].shape == np.asarray(v).shape
        assert host[k].dtype == np.float32


# ------------------------------------------------- the fit against JAX's

SCHEDULE = {"enabled": True, "dispatch_at": [3]}
STEPS = 6


def _jax_cfg(log_dir):
    return JaxConfig(
        width_mult=0.25,
        data=JaxDataConfig(dataset="synthetic", image_size=(64, 64),
                           gt_size=(64, 64), batch_size=2),
        train=JaxTrainConfig(log_every=1, eval_every=0, ckpt_every_steps=2,
                             log_dir=str(log_dir)),
        resilience=JaxResilienceConfig(
            max_consecutive_skips=1, data_backoff_s=0.0,
            faults=jax_faults.FaultConfig(**{
                k: tuple(v) if isinstance(v, list) else v
                for k, v in SCHEDULE.items()})),
        obs=JaxObsConfig(heartbeat=False, flops=False, ledger=False))


def _create_state_jitted(model, example_input, tx, seed=0, log=None):
    return jax_create_state(types.SimpleNamespace(init=jax.jit(model.init)),
                            example_input, tx, seed=seed, log=log)


def _records(log_dir):
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def _port_fit(cfg, depth, log_dir, params):
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, pipeline_depth=depth, log_dir=str(log_dir)))
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data, style="blobs"),
                      device="cpu")
    load_flax_params(trainer.model, params)  # the JAX run's weights
    return trainer.fit(max_steps=STEPS), _records(log_dir)


@pytest.fixture(scope="module")
def fits(tmp_path_factory):
    root = tmp_path_factory.mktemp("depth")
    jcfg = _jax_cfg(root / "jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_loop, "create_train_state", _create_state_jitted)
        jt = JaxTrainer(jcfg, dataset=JaxSynthetic(jcfg.data, style="blobs"),
                        mesh=local_mesh(1))
    params = jax.tree_util.tree_map(np.asarray, jt.state.params)
    want = jt.fit(max_steps=STEPS)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        pcfg = config_from_dict(dataclasses.asdict(jcfg))
    before = torch.get_num_threads()
    torch.set_num_threads(1)  # the two depths' bits must agree
    try:
        port = {d: _port_fit(pcfg, d, root / f"port{d}", params)
                for d in (2, 0)}
    finally:
        torch.set_num_threads(before)
    return {"jax": (want, _records(root / "jax")), "port": port}


def _train(records):
    return [(r["step"], r["loss"]) for r in records if r["kind"] == "train"]


def test_a_skip_that_rolls_back_follows_the_jax_loop_at_depth_2(fits):
    want, want_recs = fits["jax"]
    got, got_recs = fits["port"][2]
    assert got["pipeline_depth"] == 2  # the JAX config's default
    assert _jax_cfg("x").train.pipeline_depth == 2
    # the dispatch fault poisons the call from step 3 to 4: step 4 is
    # skipped and, at a streak of 1, rolls back to the step-2 checkpoint
    steps = [s for s, _ in _train(got_recs)]
    assert steps == [s for s, _ in _train(want_recs)] == [1, 2, 3, 3, 4, 5,
                                                          6]
    for key in ("skipped_updates", "rollbacks", "pipeline_fetches",
                "fault_dispatch"):
        assert got.get(key, 0) == want.get(key, 0), key
    assert got["skipped_updates"] == got["rollbacks"] == 1
    rolled = [r["message"] for r in got_recs
              if "rolled back to step" in r.get("message", "")]
    assert rolled == [r["message"] for r in want_recs
                      if "rolled back to step" in r.get("message", "")]
    assert rolled == ["divergence at step 4; rolled back to step 2"]
    np.testing.assert_allclose([l for _, l in _train(got_recs)],
                               [l for _, l in _train(want_recs)], rtol=1e-4)
    assert got["pipeline_max_in_flight"] <= 2


def test_depth_0_gives_the_depth_2_run_bit_for_bit(fits):
    (d2, recs2), (d0, recs0) = fits["port"][2], fits["port"][0]
    assert d0["pipeline_depth"] == 0 and d0["pipeline_max_in_flight"] == 1
    assert _train(recs0) == _train(recs2)
    for key in ("skipped_updates", "rollbacks", "pipeline_fetches"):
        assert d0[key] == d2[key], key
