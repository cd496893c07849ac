"""The port's executable ledger (`deepof_tpu_torch/obs/ledger.py`,
`tools/ledger_diff.py`) against the JAX package's.

- The readers (`load_ledger`, `summarize_ledger`, `diff_ledgers` on
  every failure class and bound, `find_baseline`, `ledger_verdict`) give
  the JAX module's results on the same rows: the row shapes of
  `tests/test_ledger.py` and the recorded fixture under
  `tests/fixtures/ledger`, whose verdicts match the JAX goldens byte for
  byte.
- The drift tool exits as the JAX tool does (0, 8, 1).
- A row the port writes has exactly the JAX `ROW_KEYS`, and the JAX
  package's `load_ledger` and `diff_ledgers` read it.
- The fingerprint: two fresh CPU trainers of one config (one in another
  process) give one fingerprint; `loss.smoothness_order` or
  `width_mult` changes it.
- A model engine's `warm()` writes a row per (bucket, tier) and the
  quality scorer's; its dispatches and `close()` give the exec_timing
  row.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from deepof_tpu.obs import ledger as jax_ledger
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          LossConfig, ObsConfig, ServeConfig,
                                          TrainConfig)
from deepof_tpu_torch.obs import ledger
from deepof_tpu_torch.tools import ledger_diff

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "ledger")
GOLDENS = os.path.join(HERE, "fixtures", "goldens")

#: tests/test_ledger.py's baseline row
BASE = {"kind": "exec", "name": "a", "fingerprint": "f1", "cache_hits": 1,
        "cache_misses": 0, "compile_s": 0.5, "argument_bytes": 100,
        "output_bytes": 50, "temp_bytes": 50}

#: (baseline rows, run rows, bounds): every failure class alone, under
#: and past its bound, the compile kinds, new and missing names
DIFFS = {
    "same": ([BASE], [dict(BASE)], {}),
    "memory_near": ([BASE], [dict(BASE, argument_bytes=110)], {}),
    "new": ([BASE], [dict(BASE), dict(BASE, name="b")], {}),
    "missing": ([BASE, dict(BASE, name="b")], [dict(BASE)], {}),
    "drift": ([BASE], [dict(BASE, fingerprint="f2")], {}),
    "recompile": ([BASE], [dict(BASE, cache_hits=0, cache_misses=1)], {}),
    "artifact_not_recompile": (
        [dict(BASE, compile_kind="artifact")],
        [dict(BASE, cache_hits=0, cache_misses=1)], {}),
    "blowup": ([BASE], [dict(BASE, compile_s=1.5)], {}),
    "blowup_kinds_differ": ([dict(BASE, compile_kind="aot")],
                            [dict(BASE, compile_s=1.5,
                                  compile_kind="first_step")], {}),
    "blowup_first_step": ([dict(BASE, compile_kind="first_step")],
                          [dict(BASE, compile_s=1.5,
                                compile_kind="first_step")], {}),
    "blowup_factor": ([BASE], [dict(BASE, compile_s=1.5)],
                      {"compile_factor": 4.0}),
    "blowup_floor": ([dict(BASE, compile_s=0.01)],
                     [dict(BASE, compile_s=0.9)], {}),
    "blowup_floor_raised": ([BASE], [dict(BASE, compile_s=1.5)],
                            {"compile_floor_s": 2.0}),
    "growth": ([BASE], [dict(BASE, temp_bytes=200)], {}),
    "growth_factor": ([BASE], [dict(BASE, temp_bytes=200)],
                      {"memory_factor": 2.0}),
    "all": ([BASE], [dict(BASE, fingerprint="f2", cache_hits=0,
                          cache_misses=1, compile_s=9.0, temp_bytes=900)],
            {}),
}


@pytest.mark.parametrize("case", sorted(DIFFS))
def test_diff_ledgers_matches_jax(case):
    base, run, bounds = DIFFS[case]
    got = ledger.diff_ledgers(base, run, **bounds)
    assert got == jax_ledger.diff_ledgers(base, run, **bounds)
    assert got["failed"] == (case in ("drift", "recompile", "blowup",
                                      "blowup_first_step", "growth", "all"))


def test_summaries_and_fixture_verdicts_match_jax():
    base = ledger.load_ledger(os.path.join(FIXTURE, "baseline.jsonl"))
    assert base == jax_ledger.load_ledger(
        os.path.join(FIXTURE, "baseline.jsonl"))
    for name, failed in (("clean", False), ("drift", True)):
        run = ledger.load_ledger(os.path.join(FIXTURE, f"run_{name}"))
        got = ledger.diff_ledgers(base, run)
        assert got["failed"] is failed
        with open(os.path.join(GOLDENS, f"ledger_diff_{name}.json")) as f:
            assert json.dumps(got) == json.dumps(json.load(f))
        assert ledger.summarize_ledger(run) == \
            jax_ledger.summarize_ledger(run)
        assert ledger.latest_by_name(run) == jax_ledger.latest_by_name(run)
    mixed = [{"kind": "exec", "name": "train_step", "compile_s": 32.4,
              "compile_kind": "aot", "fingerprint": "ff"},
             {"kind": "exec", "name": "train_step", "compile_s": 70.6,
              "compile_kind": "first_step", "fingerprint": "fe"},
             {"kind": "exec_timing", "name": "train_step",
              "mfu_nominal": 0.25}]
    assert ledger.summarize_ledger(mixed) == \
        jax_ledger.summarize_ledger(mixed)
    assert ledger.summarize_ledger([]) is None
    assert ledger.exec_name((384, 512), "f32", "warm") == \
        jax_ledger.exec_name((384, 512), "f32", "warm")
    assert ledger.quality_exec_name((8, 8)) == \
        jax_ledger.quality_exec_name((8, 8))
    assert ledger.ROW_KEYS == jax_ledger.ROW_KEYS
    assert ledger.LEDGER_SCHEMA == jax_ledger.LEDGER_SCHEMA


def test_find_baseline_and_ledger_verdict_match_jax(tmp_path):
    run = str(tmp_path / "run")
    shutil.copytree(os.path.join(FIXTURE, "run_drift"), run)
    base = os.path.join(FIXTURE, "baseline.jsonl")
    for mod in (ledger, jax_ledger):
        assert mod.find_baseline(run) is None
        assert mod.find_baseline(run, base) == base
        assert mod.ledger_verdict(run) is None
        assert mod.resolve_ledger_path(run) == os.path.join(
            run, "ledger.jsonl")
    assert ledger.ledger_verdict(run, base, memory_factor=9.0) == \
        jax_ledger.ledger_verdict(run, base, memory_factor=9.0)
    shutil.copy(base, os.path.join(run, "ledger_baseline.jsonl"))
    assert ledger.find_baseline(run) == jax_ledger.find_baseline(run)
    got = ledger.ledger_verdict(run)
    assert got == jax_ledger.ledger_verdict(run) and got["failed"]
    # an empty side gives no verdict, never a crash
    open(tmp_path / "empty.jsonl", "w").close()
    assert ledger.ledger_verdict(run, str(tmp_path / "empty.jsonl")) is \
        jax_ledger.ledger_verdict(run, str(tmp_path / "empty.jsonl")) is None


def test_ledger_diff_tool_exits_as_the_jax_tool(tmp_path, capsys):
    base = os.path.join(FIXTURE, "baseline.jsonl")
    jax_tool = os.path.join(REPO, "tools", "ledger_diff.py")
    open(tmp_path / "empty.jsonl", "w").close()
    for run, extra, rc in (
            ("run_drift", [], 8), ("run_clean", [], 0),
            ("run_drift", ["--compile-factor", "10", "--memory-factor",
                           "10"], 8),
            (str(tmp_path / "nope"), [], 1),
            (str(tmp_path / "empty.jsonl"), [], 1)):
        argv = ["--baseline", base, "--run",
                os.path.join(FIXTURE, run), *extra]
        assert ledger_diff.main(argv) == rc
        out = capsys.readouterr().out
        want = subprocess.run([sys.executable, jax_tool, *argv], cwd=REPO,
                              capture_output=True, text=True)
        assert want.returncode == rc
        if rc != 1:
            assert json.loads(out) == json.loads(want.stdout)


# ------------------------------------------------ the rows the port writes


def _cfg(log_dir, **kw):
    return ExperimentConfig(
        model="flownet_s", width_mult=kw.get("width_mult", 0.125),
        loss=LossConfig(smoothness_order=kw.get("smoothness_order", 1)),
        data=DataConfig(dataset="synthetic", image_size=(32, 32),
                        gt_size=(32, 32), batch_size=2),
        train=TrainConfig(log_dir=str(log_dir), eval_every=1, log_every=1,
                          eval_batch_size=2, num_epochs=1),
        obs=ObsConfig(heartbeat=False))


def _train_rows(log_dir, **kw) -> dict:
    from deepof_tpu_torch.train.loop import Trainer

    Trainer(_cfg(log_dir, **kw), device="cpu").fit(max_steps=1)
    return {r["name"]: r for r in ledger.load_ledger(str(log_dir))}


#: the fingerprints of `_cfg`'s defaults in a process of their own
FRESH = """
import json, sys
sys.path.insert(0, {repo!r})
import tests.test_torch_ledger as t
print(json.dumps({{n: r["fingerprint"]
                  for n, r in t._train_rows({d!r}).items()}}))
"""


def test_trainer_rows_fingerprint_one_config_and_read_by_jax(tmp_path):
    rows = _train_rows(tmp_path / "a")
    assert set(rows) == {"train_step", "eval_step"}
    for row in rows.values():
        assert tuple(row) == ledger.ROW_KEYS
        assert row["kind"] == "exec" and row["backend"] == "cpu"
        assert row["compile_kind"] == "first_step"
        # the CPU launches no library: no cache verdict, no code bytes
        assert row["cache_requests"] is None and row["code_bytes"] is None
        assert row["temp_bytes"] is None and row["alias_bytes"] is None
        assert row["flops"] > 0 and row["bytes_accessed"] > row["flops"] / 50
        assert row["roofline_s"] == row["flops"] / 989e12
        assert row["num_args"] > 0 and row["argument_bytes"] > 0
        assert len(row["fingerprint"]) == 16 and row["hlo_chars"] > 1000
    # the train step's inputs: parameters, both Adam moments, the batch
    n_params = sum(1 for _ in _cfg_model_params())
    assert rows["train_step"]["num_args"] >= 3 * n_params
    # the JAX package reads the port's ledger
    jax_rows = jax_ledger.load_ledger(str(tmp_path / "a"))
    assert jax_ledger.latest_by_name(jax_rows).keys() == rows.keys()
    assert jax_ledger.summarize_ledger(jax_rows)["executables"] == 2
    # the same config: the same fingerprints, here and in a fresh process
    again = _train_rows(tmp_path / "b")
    assert {n: r["fingerprint"] for n, r in again.items()} == \
        {n: r["fingerprint"] for n, r in rows.items()}
    assert not jax_ledger.diff_ledgers(
        jax_rows, jax_ledger.load_ledger(str(tmp_path / "b")))["failed"]
    proc = subprocess.run(
        [sys.executable, "-c", FRESH.format(repo=REPO,
                                            d=str(tmp_path / "c"))],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == \
        {n: r["fingerprint"] for n, r in rows.items()}
    # another computation: another fingerprint, and the JAX diff's drift
    for kw in ({"smoothness_order": 2}, {"width_mult": 0.25}):
        other = _train_rows(tmp_path / f"o{len(kw)}{list(kw)[0]}", **kw)
        assert other["train_step"]["fingerprint"] != \
            rows["train_step"]["fingerprint"]
        diff = jax_ledger.diff_ledgers(jax_rows, list(other.values()))
        assert {e["name"] for e in diff["fingerprint_drift"]} == {
            "train_step", "eval_step"}


def _cfg_model_params():
    from deepof_tpu_torch.models.registry import build_model

    return build_model("flownet_s", width_mult=0.125,
                       device="cpu").parameters()


def test_the_trainer_writes_no_row_with_the_ledger_off(tmp_path):
    from deepof_tpu_torch.train.loop import Trainer

    cfg = _cfg(tmp_path)
    cfg = cfg.replace(obs=dataclasses.replace(cfg.obs, ledger=False))
    trainer = Trainer(cfg, device="cpu")
    out = trainer.fit(max_steps=1)
    assert not os.path.exists(tmp_path / "ledger.jsonl")
    # the FLOPs are still counted, by `count_flops` alone
    assert "exec_lowerings" not in out and trainer._flops_per_step > 0


def test_engine_warm_writes_a_row_per_executable(tmp_path):
    """warm(): one row per (bucket, tier, mode) and the quality scorer's
    per bucket; each dispatch feeds note_exec, stats() carries the
    exec_* block, close() writes the exec_timing row."""
    import numpy as np

    from deepof_tpu_torch.serve.engine import InferenceEngine

    cfg = ExperimentConfig(
        model="flownet_s", width_mult=0.125,
        data=DataConfig(image_size=(32, 48)),
        serve=ServeConfig(max_batch=2, precisions=("f32", "int8")),
        obs=ObsConfig(quality_sample_rate=1.0),
        train=TrainConfig(log_dir=str(tmp_path)))
    rs = np.random.RandomState(0)
    with InferenceEngine(cfg, device="cpu", ledger_dir=str(tmp_path)) as eng:
        eng.warm()
        a, b = (rs.randint(0, 256, (32, 48, 3), np.uint8) for _ in range(2))
        eng.submit(a, b).result(timeout=120)
        stats = eng.stats()
    rows = ledger.load_ledger(str(tmp_path))
    execs = [r for r in rows if r["kind"] == "exec"]
    assert [r["name"] for r in execs] == [
        "serve:32x48:f32:cold", "serve:32x48:int8:cold", "quality:32x48"]
    assert all(tuple(r) == ledger.ROW_KEYS for r in execs)
    f32, int8, quality = execs
    assert f32["fingerprint"] != int8["fingerprint"]
    assert int8["argument_bytes"] < f32["argument_bytes"]  # int8 weights
    assert stats["exec_lowerings"] == 3 and stats["exec_executables"] == 3
    assert stats["exec_dispatches"] == 1 and stats["exec_recompiles"] == 0
    assert set(stats["exec_fingerprints"]) == {r["name"] for r in execs}
    timing = [r for r in rows if r["kind"] == "exec_timing"]
    assert [(r["name"], r["count"]) for r in timing] == [
        ("serve:32x48:f32:cold", 1)]
    # the measured mean beside the roofline (rounded to 0 on this tiny
    # CPU model): the JAX summary reads it
    assert timing[0]["mean_s"] > 0 and timing[0]["mfu_nominal"] is not None
    assert "mfu_nominal_max" in jax_ledger.summarize_ledger(rows)


def test_an_engine_given_no_ledger_dir_writes_no_file(tmp_path, monkeypatch):
    """Only a caller that owns a run directory gives the engine one: an
    engine built without `ledger_dir` counts its rows (the exec_* block)
    and writes nothing, under its `train.log_dir` or anywhere else."""
    from deepof_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.chdir(tmp_path)
    run = tmp_path / "run"
    cfg = ExperimentConfig(
        model="flownet_s", width_mult=0.125,
        data=DataConfig(image_size=(32, 48)),
        serve=ServeConfig(max_batch=2),
        train=TrainConfig(log_dir=str(run)))
    with InferenceEngine(cfg, device="cpu") as eng:
        eng.warm()
        stats = eng.stats()
    assert stats["exec_lowerings"] == 1 and stats["exec_executables"] == 1
    assert list(tmp_path.rglob("*")) == []


@pytest.mark.parametrize("model, over, want", [
    ("flownet_s", {}, ()),
    ("flownet_c", {}, ("corr",)),
    ("flownet_c", {"obs": {"quality_sample_rate": 0.5}}, ("corr", "warp")),
    ("flownet_cs", {}, ("corr", "warp")),
    ("inception_v3", {"serve": {"session": {"warm_start": True}}},
     ("warp",)),
])
def test_a_boot_loads_the_libraries_its_engine_launches(model, over, want):
    """A server's boot times the load of the CUDA libraries its engine
    launches, and never the correlation's backward."""
    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.serve.engine import serve_libraries

    assert serve_libraries(config_from_dict({"model": model, **over})) \
        == want


def test_a_kernel_launch_enters_the_trace_and_the_cache_counts():
    """The wrappers' launches, which the dispatch mode cannot see, are
    noted to the open trace with their plans: another plan gives
    another fingerprint, and the launch's library is a cache request
    found built. A launch outside a trace is only counted."""
    from deepof_tpu_torch.ops.cuda import build
    from deepof_tpu_torch.ops.cuda.warp import fwd_launches

    def call(plan):
        def fn():
            x = torch.ones(3) * 2
            fwd_launches.add(lambda: plan)  # where a wrapper launches
            return x
        return ledger.trace_call(fn, "cpu")[1]

    before = fwd_launches.count
    try:
        a, b, c = (call((((4, 3, 8, 8), (192, 64, 8, 1), 0, 0),)),
                   call((((4, 3, 8, 8), (192, 64, 8, 1), 0, 0),)),
                   call((((4, 3, 8, 16), (384, 128, 16, 1), 0, 0),)))
        fwd_launches.add(lambda: 1 / 0)  # no trace open: counted, the plan
        # never built, noted nowhere
        assert fwd_launches.count == before + 4
    finally:
        fwd_launches.count = before
    assert a["fingerprint"] == b["fingerprint"] != c["fingerprint"]
    assert a["cache"] == {"requests": 1, "hits": 1, "misses": 0}
    assert build._traces == [0]
    row = ledger.exec_row("x", a, "cpu")
    assert (row["cache_verdict"], row["cache_hits"]) == ("hit", 1)
