"""The staged training recipe of the port (data/mixture.py,
train/recipe.py, `train --recipe`) against the JAX package's.

  - the mixture: for the same seed and batch indices the port picks the
    JAX member every time, and its batches are the JAX batches: bit for
    bit for synthetic members, and for FlyingChairs and a T = 2 Sintel
    volume (normalised to pair form) at their native size, where both
    decode the same bytes; resized, within the loaders' own stated
    tolerance (1 grey level: `tests/test_torch_data_path.py`,
    `tests/test_torch_sintel.py`);
  - the recipe's config (round trip, strict loading with the JAX error
    text), the stage resolution, `eval_trend` and `plateau_reached`
    (within 1e-12), the resume scan on fabricated checkpoints, and
    `run_recipe` driven by one stand-in trainer on both sides (the JAX
    `tests/test_recipe.py` drills: the plateau and the budget cap);
  - a real two-stage run through `train --recipe` on the CPU (FlowNet-S
    at width 0.125, 64x64, 2 + 2 steps): the graft, the manifests'
    stage block, the prebuild, and a resume in the middle of stage 1.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from deepof_tpu import analyze as jax_analyze
from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.core.config import MixtureMemberConfig as JaxMember
from deepof_tpu.core.config import RecipeConfig as JaxRecipe
from deepof_tpu.core.config import StageConfig as JaxStage
from deepof_tpu.core.config import TrainConfig as JaxTrainConfig
from deepof_tpu.core.config import recipe_from_dict as jax_recipe_from_dict
from deepof_tpu.data import mixture as jax_mixture
from deepof_tpu.data.pipeline import derive_batch_rng as jax_batch_rng
from deepof_tpu.train import recipe as jax_recipe
from deepof_tpu_torch import analyze, cli
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          MixtureMemberConfig, RecipeConfig,
                                          StageConfig, TrainConfig,
                                          config_from_dict, recipe_from_dict)
from deepof_tpu_torch.data import mixture
from deepof_tpu_torch.data.pipeline import derive_batch_rng
from deepof_tpu_torch.resilience import verify as ckpt_verify
from deepof_tpu_torch.train import recipe

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SEED = np.array([7, 3], np.uint32)
SINTEL_CLIPS = {"alley_1": 5, "bamboo_2": 8, "market_2": 6}
CHAIRS_HW = (384, 512)  # chip_smoke.write_chairs' frames and flows


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A FlyingChairs tree and a Sintel tree whose frames and flows are
    the Chairs size, so a T = 2 Sintel volume mixes with Chairs pairs."""
    root = tmp_path_factory.mktemp("trees")
    chairs, sintel = str(root / "chairs"), str(root / "sintel")
    chip_smoke.write_chairs(chairs, pairs=6, val=2)
    chip_smoke.write_sintel(sintel, SINTEL_CLIPS, CHAIRS_HW, seed=3)
    return chairs, sintel


def _both(stage_kw: dict, members: list[dict], **data_kw):
    """(port, JAX) mixtures of the same stage and data config."""
    out = []
    for data_cls, stage_cls, member_cls, mod in (
            (DataConfig, StageConfig, MixtureMemberConfig, mixture),
            (JaxDataConfig, JaxStage, JaxMember, jax_mixture)):
        stage = stage_cls(mixture=tuple(member_cls(**m) for m in members),
                          **stage_kw)
        out.append(mod.build_mixture(data_cls(**data_kw), stage))
    return out


def _blobs(data_kw: dict, weights=(0.7, 0.3)):
    """(port, JAX) mixtures of synthetic "blobs" members, built directly:
    `build_mixture` builds the "noise" style, whose bicubic upsampling
    is PyTorch's in the port and cv2's in JAX (float rounding apart)."""
    from deepof_tpu.data.datasets import SyntheticData as JaxSynthetic
    from deepof_tpu_torch.data.datasets import SyntheticData

    return [mod.MixtureDataset(
        [cls(data_cls(**data_kw), style="blobs", num_train=n)
         for n in (64, 32)], list(weights), ["blobs64", "blobs32"],
        stage="synthetic") for cls, data_cls, mod in (
            (SyntheticData, DataConfig, mixture),
            (JaxSynthetic, JaxDataConfig, jax_mixture))]


MIXTURES = {
    # two synthetic members: exact
    "synthetic": (
        None, dict(dataset="synthetic", image_size=(32, 48),
                   gt_size=(32, 48), batch_size=3, time_step=2), {}),
    # Chairs and a T = 2 Sintel volume at their native size: exact
    "chairs_sintel_native": (
        [{"dataset": "flyingchairs", "weight": 0.6},
         {"dataset": "sintel", "weight": 0.4, "data_path": "{sintel}",
          "time_step": 2}],
        dict(image_size=CHAIRS_HW, gt_size=CHAIRS_HW, batch_size=2,
             data_path="{chairs}"), {"source": 0.0, "target": 0.0}),
    # resized: the loaders' resize tolerance (1 grey level)
    "chairs_sintel_resized": (
        [{"dataset": "flyingchairs", "weight": 0.5},
         {"dataset": "sintel", "weight": 0.5, "data_path": "{sintel}"}],
        dict(image_size=(48, 64), gt_size=CHAIRS_HW, batch_size=2,
             data_path="{chairs}"), {"source": 1.0, "target": 1.0}),
}


def _fill(obj, trees):
    chairs, sintel = trees
    if isinstance(obj, dict):
        return {k: _fill(v, trees) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill(v, trees) for v in obj)
    if isinstance(obj, str):
        return obj.format(chairs=chairs, sintel=sintel)
    return obj


@pytest.mark.parametrize("name", sorted(MIXTURES))
def test_mixture_picks_and_batches_match_jax(trees, name):
    members, data_kw, atol = _fill(MIXTURES[name], trees)
    port, jax_ = (_both({"name": name}, members, **data_kw) if members
                  else _blobs(data_kw))
    np.testing.assert_array_equal(port.mean, jax_.mean)
    assert (port.num_train, port.num_val, port.names) == (
        jax_.num_train, jax_.num_val, jax_.names)
    picks = []
    for i in range(12):
        got = port._pick(derive_batch_rng(SEED, i))
        assert got == jax_._pick(jax_batch_rng(SEED, i)), i
        picks.append(got)
        b = port.sample_train(data_kw["batch_size"],
                              rng=derive_batch_rng(SEED, i))
        want = jax_.sample_train(data_kw["batch_size"],
                                 rng=jax_batch_rng(SEED, i))
        assert set(b) == set(want)
        for k in want:
            np.testing.assert_allclose(b[k], want[k], rtol=0,
                                       atol=atol.get(k, 0.0), err_msg=k)
    assert len(set(picks)) == 2  # both members drawn
    assert port.mixture_stats() == jax_.mixture_stats()
    got, want = port.sample_val(2, 0), jax_.sample_val(2, 0)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=atol.get(k, 0.0))


def test_mixture_draw_counts_under_the_pipeline_match_jax():
    """The draw counters of a mixture fed through the port's input
    pipeline (4 workers) are JAX's for the same batch indices, and the
    port's stream is the same at 0 and 4 workers."""
    from deepof_tpu_torch.data.pipeline import InputPipeline

    members = [{"dataset": "synthetic", "weight": 0.8},
               {"dataset": "synthetic", "weight": 0.2, "time_step": 0}]
    kw = dict(dataset="synthetic", image_size=(16, 16), gt_size=(16, 16),
              batch_size=2)
    streams = []
    for workers in (0, 4):
        port, jax_ = _both({"name": "counts"}, members, **kw)
        pipe = InputPipeline(
            lambda i, ds=port: ds.sample_train(2, rng=derive_batch_rng(
                SEED, i)), num_workers=workers)
        try:
            streams.append([pipe.get()["source"] for _ in range(10)])
        finally:
            pipe.close()
        for i in range(10):
            jax_.sample_train(2, rng=jax_batch_rng(SEED, i))
        # a worker may have drawn ahead of the 10 batches read
        got = port.mixture_stats()["recipe_draws_by_dataset"]["synthetic"]
        assert got >= 10
    for a, b in zip(*streams):
        np.testing.assert_array_equal(a, b)
    assert jax_.mixture_stats() == {"recipe_draws_by_dataset":
                                    {"synthetic": 10}}
    assert port.cache_stats() == {"hits": 0, "misses": 0, "evictions": 0}


@pytest.mark.parametrize("case", ["structure", "empty", "weight"])
def test_mixture_refusals_match_jax(case):
    kw = dict(dataset="synthetic", image_size=(16, 16), gt_size=(16, 16),
              batch_size=2)
    errors = []
    for data_cls, stage_cls, member_cls, mod in (
            (DataConfig, StageConfig, MixtureMemberConfig, mixture),
            (JaxDataConfig, JaxStage, JaxMember, jax_mixture)):
        with pytest.raises(ValueError) as ei:
            if case == "structure":  # T = 2 pairs against a T = 3 volume
                mod.build_mixture(data_cls(**kw), stage_cls(
                    name="badstage", mixture=(
                        member_cls("synthetic", 0.5),
                        member_cls("synthetic", 0.5, time_step=3))))
            elif case == "empty":
                mod.build_mixture(data_cls(**kw), stage_cls(name="empty"))
            else:
                mod.MixtureDataset([object()], [0.0], ["x"], stage="zero")
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------- config


def _sample_recipe(classes) -> object:
    recipe_cls, stage_cls, member_cls = classes
    return recipe_cls(
        enabled=True, max_trigger_evals=64, warmup=False,
        stages=(stage_cls(name="chairs",
                          mixture=(member_cls("flyingchairs", 0.8),
                                   member_cls("sintel", 0.2,
                                              sintel_pass="clean")),
                          image_size=(64, 64), steps=4),
                stage_cls(name="sintel", advance="plateau",
                          plateau_window=4, plateau_slope=0.05,
                          learning_rate=1e-5, loss_weights=(1.0, 2.0))))


PORT_CLASSES = (RecipeConfig, StageConfig, MixtureMemberConfig)
JAX_CLASSES = (JaxRecipe, JaxStage, JaxMember)


def test_recipe_json_round_trips_and_matches_jax():
    rc = _sample_recipe(PORT_CLASSES)
    d = json.loads(json.dumps(dataclasses.asdict(rc)))
    assert d == json.loads(json.dumps(dataclasses.asdict(
        _sample_recipe(JAX_CLASSES))))
    assert recipe_from_dict(d) == rc
    # a full JAX config's recipe block loads, warmup and
    # max_trigger_evals included (no longer dropped with a warning)
    jcfg = JaxConfig(recipe=_sample_recipe(JAX_CLASSES))
    with pytest.warns(UserWarning, match="ignored keys") as rec:
        cfg = config_from_dict(dataclasses.asdict(jcfg))
    assert cfg.recipe == rc
    assert not [w for w in rec if "recipe" in str(w.message)]


@pytest.mark.parametrize("d", [
    {"enabledd": True},
    {"stages": [{"name": "ok"}, {"stepss": 4}]},
    {"stages": [{"mixture": [{"dataset": "sintel"},
                             {"dataset": "sintel", "wieght": 0.5}]}]}])
def test_recipe_from_dict_rejects_unknown_keys_as_jax(d):
    errors = []
    for fn in (recipe_from_dict, jax_recipe_from_dict):
        with pytest.raises(ValueError) as ei:
            fn(d)
        errors.append(str(ei.value))
    assert errors[0] == errors[1]


def test_stage_config_resolves_as_jax():
    stage_kw = dict(name="s", image_size=(48, 48), time_step=3,
                    model="st_single", learning_rate=5e-5, batch_size=6,
                    crop_size=(40, 40), gt_size=(50, 50),
                    loss_weights=(1.0, 2.0))
    got = recipe.stage_config(
        ExperimentConfig(), StageConfig(
            mixture=(MixtureMemberConfig("sintel", 1.0),), **stage_kw))
    want = jax_recipe.stage_config(
        JaxConfig(), JaxStage(mixture=(JaxMember("sintel", 1.0),),
                              **stage_kw))
    for section, fields in (
            ("data", ("dataset", "image_size", "gt_size", "crop_size",
                      "time_step", "batch_size")),
            ("loss", ("weights",)), ("optim", ("learning_rate",))):
        for f in fields:
            assert getattr(getattr(got, section), f) == \
                getattr(getattr(want, section), f), (section, f)
    assert got.model == want.model
    # sentinels inherit the base
    plain = recipe.stage_config(ExperimentConfig(), StageConfig())
    assert plain == ExperimentConfig()


def _series(kind: str) -> list[dict]:
    rs = np.random.RandomState(5)
    steps = [250 * i for i in range(12)]
    if kind == "improving":
        return [{"step": s, "aee": 10.0 - 0.002 * s} for s in steps]
    if kind == "flat":
        return [{"step": s, "aee": 2.0 + 1e-3 * rs.randn()} for s in steps]
    if kind == "regressing":
        return [{"step": s, "aee": 2.0 + 0.004 * i + 0.01 * rs.rand()}
                for i, s in enumerate(steps)]
    return [{"step": s, "aee": 3.0 / (1 + i) + (float("nan") if i == 4
                                                else 0.0)}
            for i, s in enumerate(steps)]


@pytest.mark.parametrize("kind", ["improving", "flat", "regressing",
                                  "with_nan"])
def test_eval_trend_and_plateau_match_jax(kind):
    evals = _series(kind)
    for window in (3, 4, 8):
        for n in range(len(evals) + 1):
            got = analyze.eval_trend(evals[:n], window=window)
            want = jax_analyze.eval_trend(evals[:n], window=window)
            assert (got is None) == (want is None)
            if got is None:
                continue
            assert set(got) == set(want)
            for k in got:
                assert got[k] == pytest.approx(want[k], abs=1e-12), k
            for slope in (0.01, 0.5):
                for min_evals in (3, 5):
                    kw = dict(name="p", advance="plateau",
                              plateau_window=window, plateau_slope=slope,
                              min_evals=min_evals)
                    assert recipe.plateau_reached(
                        StageConfig(**kw), evals[:n]) == \
                        jax_recipe.plateau_reached(JaxStage(**kw),
                                                   evals[:n])


def _fabricate(cfg, idx: int, step: int, extra):
    step_dir = os.path.join(recipe.stage_ckpt_dir(cfg, idx),
                            f"step_{step:010d}")
    os.makedirs(step_dir, exist_ok=True)
    with open(os.path.join(step_dir, "state.pt"), "wb") as f:
        f.write(b"x" * 8)
    ckpt_verify.write_manifest(step_dir, ckpt_verify.build_manifest(
        step_dir, step, extra=extra))


def test_find_resume_stage_on_fabricated_checkpoints(tmp_path):
    stages = (StageConfig(name="a", steps=4), StageConfig(name="b"),
              StageConfig(name="c"))
    cfg = ExperimentConfig(train=TrainConfig(log_dir=str(tmp_path)),
                           recipe=RecipeConfig(enabled=True, stages=stages))
    assert recipe.find_resume_stage(cfg) == (0, {})
    _fabricate(cfg, 0, 4, {"recipe_stage": 0, "recipe_stage_name": "a",
                           "stage_start_step": 0})
    assert recipe.find_resume_stage(cfg)[0] == 0
    _fabricate(cfg, 1, 7, {"recipe_stage": 1, "recipe_stage_name": "b",
                           "stage_start_step": 4})
    idx, extra = recipe.find_resume_stage(cfg)
    assert (idx, extra["stage_start_step"], extra["recipe_stage_name"]) \
        == (1, 4, "b")
    # a manifest without the block resumes into its directory's stage
    _fabricate(cfg, 2, 9, None)
    assert recipe.find_resume_stage(cfg) == (2, {})


# ---------------------------------------- run_recipe with a stand-in


class _StandInState:
    def __init__(self, step=0):
        self.step = step
        self.params = {}

    def replace(self, **kw):
        out = _StandInState(self.step)
        out.params = self.params
        for k, v in kw.items():
            setattr(out, k, int(v) if k == "step" else v)
        return out


class _StandInModel:
    def state_dict(self):
        return {}

    def load_state_dict(self, sd):
        pass


class StandInTrainer:
    """A trainer for both packages' `run_recipe` (the JAX
    `tests/test_recipe.py` stand-in): fit() trains one step at a time
    and feeds on_eval an AEE series, steeply improving to step 5 and
    flat after."""

    logs: list = []

    def __init__(self, scfg, dataset=None, ckpt_dir=None,
                 manifest_extra=None, extra_stats=None, on_eval=None,
                 **_kw):
        self.state = _StandInState()
        self.model = _StandInModel()
        self.steps_per_epoch = 1000
        self.logger = self
        self._on_eval = on_eval
        self._extra_stats = extra_stats
        self.manifest_extra = manifest_extra

    def log(self, kind, step, **fields):
        StandInTrainer.logs.append({"kind": kind, "step": step, **fields})

    def fit(self, num_epochs=1, max_steps=None):
        n = (max_steps if max_steps is not None
             else num_epochs * self.steps_per_epoch)
        aee = float("nan")
        for _ in range(int(n)):
            self.state = self.state.replace(step=int(self.state.step) + 1)
            stats = self._extra_stats()
            StandInTrainer.logs.append({"kind": "stats", **stats})
            aee = max(6.0 - int(self.state.step), 1.0)
            if self._on_eval(int(self.state.step), {"aee": aee}):
                break
        return {"aee": aee}


DRILLS = {
    "plateau": (
        [dict(name="plat", mixture=[("synthetic", 1.0)], advance="plateau",
              plateau_window=3, plateau_slope=0.01, min_evals=3, steps=0),
         dict(name="tail", mixture=[("synthetic", 1.0)], steps=2)], None),
    "budget": (
        [dict(name="a", mixture=[("synthetic", 1.0)], steps=8),
         dict(name="b", mixture=[("synthetic", 1.0)], steps=4)], 5),
    "steps": (
        [dict(name="a", mixture=[("synthetic", 0.5), ("synthetic", 0.5)],
              steps=3),
         dict(name="b", steps=2, image_size=(24, 24)),
         dict(name="c", mixture=[("synthetic", 1.0)], advance="plateau",
              steps=4)], None)}


def _drill_cfg(classes, stages, log_dir):
    cfg_cls, data_cls, train_cls, recipe_cls, stage_cls, member_cls = \
        classes
    return cfg_cls(
        data=data_cls(dataset="synthetic", image_size=(32, 32),
                      gt_size=(32, 32), batch_size=4),
        train=train_cls(log_dir=log_dir, seed=0),
        recipe=recipe_cls(enabled=True, warmup=False, stages=tuple(
            stage_cls(**{**s, "mixture": tuple(
                member_cls(d, w) for d, w in s.get("mixture", ()))})
            for s in stages)))


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_run_recipe_with_a_stand_in_matches_jax(tmp_path, monkeypatch,
                                                drill):
    stages, max_steps = DRILLS[drill]
    monkeypatch.setattr("deepof_tpu.train.loop.Trainer", StandInTrainer)
    monkeypatch.setattr("deepof_tpu_torch.train.loop.Trainer",
                        StandInTrainer)
    outs, logs = [], []
    for run, classes in (
            (recipe.run_recipe, (ExperimentConfig, DataConfig, TrainConfig,
                                 RecipeConfig, StageConfig,
                                 MixtureMemberConfig)),
            (jax_recipe.run_recipe, (JaxConfig, JaxDataConfig,
                                     JaxTrainConfig, JaxRecipe, JaxStage,
                                     JaxMember))):
        StandInTrainer.logs = []
        cfg = _drill_cfg(classes, stages, str(tmp_path / run.__module__))
        kw = {"device": "cpu"} if run is recipe.run_recipe else {}
        outs.append(run(cfg, max_steps=max_steps, **kw))
        logs.append([{k: v for k, v in r.items() if k != "step"}
                     for r in StandInTrainer.logs])
    got, want = outs
    for k in ("final_stage", "global_step", "advances", "last_trigger",
              "per_stage", "aee"):
        assert got[k] == want[k], k
    # the same advance messages and recipe_* blocks, in the same order
    assert logs[0] == logs[1]
    assert [g["stage"] for g in got["grafts"]] == [
        s["stage"] for s in got["per_stage"][1:]]
    if drill == "plateau":
        assert got["per_stage"][0]["advance"] == "plateau"
        assert got["per_stage"][0]["end_step"] == 7
    if drill == "budget":
        assert got["per_stage"] == [{"stage": 0, "name": "a",
                                     "start_step": 0, "end_step": 5,
                                     "advance": "budget"}]


# ------------------------------------------------------ a real run


RECIPE = {"stages": [
    {"name": "warm", "mixture": [{"dataset": "synthetic", "weight": 0.8},
                                 {"dataset": "synthetic", "weight": 0.2}],
     "steps": 2},
    {"name": "main", "mixture": [{"dataset": "synthetic", "weight": 1.0}],
     "steps": 2, "learning_rate": 3e-5}]}
ARGV = ["train", "--synthetic", "--model", "flownet_s", "--device", "cpu",
        "--set", "width_mult=0.125", "--set", "train.log_every=1",
        "--set", "train.eval_every=0", "--set", "data.batch_size=2"]


def _train(capsys, log_dir, recipe_path, *extra):
    assert cli.main([*ARGV, "--recipe", recipe_path, "--log-dir", log_dir,
                     *extra]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _extras(log_dir, idx):
    d = recipe.stage_ckpt_dir(
        ExperimentConfig(train=TrainConfig(log_dir=log_dir)), idx)
    return {s: ckpt_verify.load_manifest(ckpt_verify.manifest_path(p))
            .get("extra") for s, p in ckpt_verify.step_dirs(d)}


def test_train_recipe_grafts_records_and_resumes_mid_stage(tmp_path, capsys):
    """Two stages of two steps: stage 1 starts from stage 0's weights
    (every tensor grafted: the same model), its manifests name it, the
    train records carry the recipe block; a run cut by --max-steps 3
    inside stage 1 resumes there and finishes the stage from its own
    start step, never restarting it."""
    path = str(tmp_path / "recipe.json")
    with open(path, "w") as f:
        json.dump(RECIPE, f)
    log_dir = str(tmp_path / "run")
    out = _train(capsys, log_dir, path, "--max-steps", "3")
    assert out["global_step"] == 3 and out["libraries_built_after_prebuild"] \
        == 0
    assert out["per_stage"] == [
        {"stage": 0, "name": "warm", "start_step": 0, "end_step": 2,
         "advance": "steps"},
        {"stage": 1, "name": "main", "start_step": 2, "end_step": 3,
         "advance": "budget"}]
    assert out["grafts"] == [{"stage": 1, "copied": 52, "reinitialized": 0}]
    assert [s["dataset_s"] >= 0 for s in out["prebuild"]["stages"]] == [
        True, True]
    assert "libraries" not in out["prebuild"]  # the CPU builds none
    assert _extras(log_dir, 1)[3] == {"recipe_stage": 1,
                                      "recipe_stage_name": "main",
                                      "stage_start_step": 2}
    assert set(_extras(log_dir, 0)) >= {2}
    assert all(e["recipe_stage"] == 0 for e in _extras(log_dir, 0).values())
    # stage 1 trained from stage 0's final weights
    from deepof_tpu_torch.train.checkpoint import CheckpointManager

    stage0 = CheckpointManager(os.path.join(log_dir, "ckpt-stage0"),
                               create=False)
    assert stage0.read_manifest_extra()["recipe_stage"] == 0
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    trains = [r for r in records if r["kind"] == "train"]
    assert [(r["step"], r["recipe_stage"]) for r in trains] == [
        (1, 0), (2, 0), (3, 1)]
    assert sum(trains[1]["recipe_draws_by_dataset"].values()) >= 2
    assert trains[2]["lr"] == pytest.approx(3e-5)
    assert any("52 tensors grafted from stage 0, 0 re-initialized"
               in r.get("message", "") for r in records)
    # each stage's Trainer wrote its train step's ledger row under the
    # JAX name, into the run's one ledger
    from deepof_tpu_torch.obs.ledger import load_ledger

    assert [r["name"] for r in load_ledger(log_dir)
            if r["name"].startswith("train_step")] == [
        "train_step_stage0", "train_step_stage1"]

    again = _train(capsys, log_dir, path)
    assert again["per_stage"] == [
        {"stage": 1, "name": "main", "start_step": 2, "end_step": 4,
         "advance": "steps"}]
    assert again["grafts"] == [] and again["global_step"] == 4
    # the finished run trains nothing more
    done = _train(capsys, log_dir, path)
    assert done["global_step"] == 4 and done["per_stage"][0]["end_step"] == 4
    # analyze reads the staged run as the JAX module does
    got, want = analyze.analyze(log_dir, plot=False), \
        jax_analyze.analyze(log_dir, plot=False)
    assert got["recipe"] == want["recipe"]
    # the resumed call's records count its own advances, as in JAX
    assert got["recipe"]["stage"] == 1 and got["recipe"]["advances"] == 0


def test_bench_data_only_times_the_first_stage_mixture(tmp_path, capsys):
    path = str(tmp_path / "recipe.json")
    with open(path, "w") as f:
        json.dump({"stages": [{"name": "a", "image_size": [24, 32],
                               "mixture": [{"dataset": "synthetic",
                                            "weight": 0.5},
                                           {"dataset": "synthetic",
                                            "weight": 0.5}]}]}, f)
    assert cli.main(["bench", "--data-only", "--recipe", path, "--batch",
                     "2", "--batches", "3"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["dataset"] == "synthetic+synthetic"
    assert line["image_size"] == [24, 32]
    assert sum(line["draws_by_dataset"].values()) >= 4  # warm + 3


def test_the_trainer_hooks_the_recipe_drives(tmp_path):
    """The real Trainer's hooks: its checkpoints in `ckpt_dir` with the
    `manifest_extra` block, `extra_stats` in the records, the heartbeat
    and the summary, and `on_eval` returning True ending `fit` at that
    eval, through its final checkpoint."""
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.train.checkpoint import CheckpointManager
    from deepof_tpu_torch.train.loop import Trainer

    cfg = ExperimentConfig(
        width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(32, 32),
                        gt_size=(32, 32), batch_size=2),
        train=TrainConfig(log_dir=str(tmp_path), log_every=1, eval_every=2,
                          eval_batch_size=2))
    seen = []

    def on_eval(step, metrics):
        seen.append((step, metrics["aee"]))
        return True

    ckpt_dir = str(tmp_path / "ckpt-stage3")
    trainer = Trainer(cfg, dataset=SyntheticData(cfg.data, num_val=2),
                      device="cpu", ckpt_dir=ckpt_dir,
                      manifest_extra={"recipe_stage": 3},
                      extra_stats=lambda: {"recipe_stage": 3,
                                           "recipe_advances": 1},
                      on_eval=on_eval)
    out = trainer.fit(max_steps=6)
    assert trainer.state.step == 2 and [s for s, _ in seen] == [2]
    assert (out["recipe_stage"], out["recipe_advances"]) == (3, 1)
    manager = CheckpointManager(ckpt_dir, create=False)
    assert manager.all_steps()[-1] == 2
    assert manager.read_manifest_extra() == {"recipe_stage": 3}
    assert not os.path.exists(tmp_path / "ckpt")
    records = analyze.load_records(str(tmp_path))
    assert [r["recipe_stage"] for r in records if r["kind"] == "train"] \
        == [3, 3]
    assert any("on_eval hook requested stop at step 2" in
               r.get("message", "") for r in records)
    assert analyze.load_heartbeat(str(tmp_path))["recipe_stage"] == 3
