"""`train/warmup.py` and the `warmup` verb (port of
`deepof_tpu/train/warmup.py`; the JAX tests are `tests/test_warmup.py`).

JAX's warmup lowers and compiles from shape specs into its XLA cache and
executes nothing; this package's compiles only its CUDA libraries, so
its warmup builds them and traces one call of each executable on zero
inputs into an "aot" ledger row. What is held here: the report's keys
and per-executable lines (JAX's `_ledger_report_entry` on the port's
row), that a warmup's train and eval rows carry the fingerprints a
`fit`'s first calls record (so a warmup ledger is a drift baseline for
a run: JAX's `test_warmup_then_trainer_compiles_nothing`, at one and two
steps a call: `test_example_train_batch_matches_producer_stacking`),
that a rerun traces the same computation and builds nothing, the verb
itself, and a recipe's stage rows. The compile-cache tests have no
counterpart (a library's hash is its cache key). The serving lattice's
warmup is `tests/test_torch_artifacts.py`.
"""

import json
import os

import pytest
import torch

from deepof_tpu.obs import ledger as jax_ledger
from deepof_tpu.train.warmup import _ledger_report_entry
from deepof_tpu_torch import cli
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          TrainConfig)
from deepof_tpu_torch.obs.ledger import diff_ledgers, load_ledger
from deepof_tpu_torch.train import warmup
from deepof_tpu_torch.train.loop import Trainer

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

#: the report keys of the JAX `warmup_compile` and `warmup_serve` (less
#: the XLA cache's `persisted_buckets`/`skipped_buckets`)
JAX_COMPILE_KEYS = {"model", "steps_per_call", "backend", "cache_dir",
                    "executables", "train_compile_s", "eval_compile_s",
                    "cache"}
JAX_SERVE_KEYS = {"model", "max_batch", "backend", "cache_dir", "tiers",
                  "modes", "buckets"}


def _cfg(log_dir, k=1, model="flownet_s") -> ExperimentConfig:
    return ExperimentConfig(
        model=model, width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(64, 64),
                        batch_size=2),
        train=TrainConfig(log_dir=str(log_dir), eval_batch_size=2,
                          eval_every=1, steps_per_call=k))


def _fingerprints(log_dir) -> dict:
    return {r["name"]: r["fingerprint"] for r in load_ledger(str(log_dir))
            if r["kind"] == "exec"}


def _report(capsys) -> dict:
    """The verb's report: its last line (the trainer's records come
    first)."""
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_the_report_has_jaxs_keys_and_lines(tmp_path):
    rep = warmup.warmup_compile(_cfg(tmp_path / "w"), device="cpu")
    assert JAX_COMPILE_KEYS <= set(rep)
    rows = [r for r in load_ledger(str(tmp_path / "w"))]
    assert [(r["name"], r["compile_kind"]) for r in rows] == [
        ("train_step", "aot"), ("eval_step", "aot")]
    assert rep["executables"] == [_ledger_report_entry(r) for r in rows]
    # the CPU launches no library: nothing requested, nothing built
    assert rep["libraries"] == {} and rep["cache"] == {
        "requests": 0, "hits": 0, "misses": 0}
    assert warmup.train_libraries(_cfg(tmp_path, model="flownet_c")) == (
        "corr", "corr_bwd", "warp")
    assert warmup.train_libraries(
        _cfg(tmp_path).replace(model="ucf101_spatial")) == ()


@pytest.mark.parametrize("k", [1, 2])
def test_a_warmup_ledger_is_the_baseline_of_a_fit(tmp_path, k):
    """The warmup's train and eval rows carry the fingerprints that a
    fit's first train call and first eval record (the batch staged and
    stacked as the loop stages it), so JAX's and the port's
    diff_ledgers find no drift and no recompile between them; a second
    warmup traces the same computation."""
    warmup.warmup_compile(_cfg(tmp_path / "w", k), device="cpu")
    warmup.warmup_compile(_cfg(tmp_path / "w2", k), device="cpu")
    Trainer(_cfg(tmp_path / "fit", k), device="cpu").fit(max_steps=k)
    base, run = _fingerprints(tmp_path / "w"), _fingerprints(tmp_path / "fit")
    assert base == run == _fingerprints(tmp_path / "w2")
    assert set(base) == {"train_step", "eval_step"}
    for diff in (diff_ledgers, jax_ledger.diff_ledgers):
        rep = diff(load_ledger(str(tmp_path / "w")),
                   load_ledger(str(tmp_path / "fit")))
        assert rep["fingerprint_drift"] == [] and not rep["failed"], rep


def test_the_warmup_verb(tmp_path, capsys):
    """`warmup` prints its JSON report last and exits 0; --no-eval
    traces the train step alone; --serve adds the serving lattice's
    report."""
    flags = ["--synthetic", "--model", "flownet_s", "--set",
             "width_mult=0.125", "--set", "data.batch_size=2", "--set",
             "train.eval_batch_size=2", "--device", "cpu"]
    assert cli.main(["warmup", *flags, "--no-eval", "--log-dir",
                     str(tmp_path / "a")]) == 0
    rep = _report(capsys)
    assert [e["name"] for e in rep["executables"]] == ["train_step"]
    assert cli.main(["warmup", *flags, "--serve", "--log-dir",
                     str(tmp_path / "b")]) == 0
    rep = _report(capsys)
    assert JAX_SERVE_KEYS <= set(rep["serve"])
    assert [b["mode"] for b in rep["serve"]["buckets"]] == ["cold"]
    assert "artifacts" not in rep["serve"]  # no store named
    assert sorted(_fingerprints(tmp_path / "b")) == [
        "eval_step", "serve:64x64:f32:cold", "train_step"]


def test_a_recipe_warms_every_stage(tmp_path, capsys):
    """`warmup --recipe FILE`: the prebuild report with one traced train
    and eval row a stage (`train_step_stage<i>`), on each stage's
    shapes."""
    path = str(tmp_path / "recipe.json")
    with open(path, "w") as f:
        json.dump({"stages": [{"name": "a", "image_size": [32, 32],
                               "steps": 1},
                              {"name": "b", "image_size": [48, 64]}]}, f)
    assert cli.main(["warmup", "--synthetic", "--model", "flownet_s",
                     "--set", "width_mult=0.125", "--set",
                     "data.batch_size=2", "--set", "train.eval_batch_size=2",
                     "--recipe", path, "--device", "cpu", "--log-dir",
                     str(tmp_path / "r")]) == 0
    rep = _report(capsys)
    assert [[e["name"] for e in s["executables"]] for s in rep["stages"]] \
        == [["train_step_stage0", "eval_step_stage0"],
            ["train_step_stage1", "eval_step_stage1"]]
    fps = _fingerprints(tmp_path / "r")
    assert fps["train_step_stage0"] != fps["train_step_stage1"]
