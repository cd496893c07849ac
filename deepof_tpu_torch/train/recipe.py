"""Staged training-recipe engine (port of `deepof_tpu/train/recipe.py`).

The reference ships three disjoint trainers — FlyingChairs pairs,
Sintel 10-frame volumes, UCF-101 two-stream (`flyingChairsTrain.py`,
`sintelTrain.py`, `ucf101train.py`) — and its published results come
from running them in sequence by hand. `run_recipe` replaces that with
one declarative `RecipeConfig`: an ordered list of stages, each naming
a weighted dataset mixture (data/mixture.py), per-stage overrides of
the base config (image size, time_step, model, loss weights, lr), and
an advance condition — a fixed step count or the `eval_trend`
sustained-AEE-plateau signal (analyze.py).

- Each stage runs a fresh `Trainer` against a stage-resolved config and
  an injected mixture dataset. The member CHOICE is folded from the
  same per-batch rng as the draw, so the mixed stream is bit-identical
  for any `data.num_workers`.
- Each stage owns its checkpoint lineage (`<log_dir>/ckpt-stage<i>`),
  and every manifest the stage writes carries
  ``extra = {recipe_stage, recipe_stage_name, stage_start_step}``; a
  resume scans the stage directories newest first and lands in the
  stage the newest manifest names.
- Stage i+1 starts from stage i's weights via `transfer_params` (the
  name-and-shape-matched graft of the Chairs->Sintel fine-tune; the
  rest keeps its fresh initialisation), and the global step carries
  across stages so records and checkpoints stay monotonic. As in the
  JAX package only the step carries: the new stage's Adam state, and
  with it the learning-rate schedule's count, starts from zero.
- `prebuild_stages` (under `recipe.warmup`) takes the place of the JAX
  module's `precompile_stages`: before step 1 it builds every remaining
  stage's dataset (handed to that stage's Trainer) and, on the card,
  builds and loads every CUDA library. This package compiles nothing
  per stage, so a stage switch then builds nothing, which
  `run_recipe`'s ``libraries_built_after_prebuild`` shows (the count of
  libraries compiled after the prebuild). It records no ledger row: the
  JAX module's prebuild rows describe XLA executables compiled ahead of
  time, and this package runs nothing ahead of time.
- Each stage's Trainer writes the executable ledger's rows under the
  JAX names, `train_step_stage<i>` at the stage's first step and
  `eval_step_stage<i>` at its first eval forward, into the run's one
  `<log_dir>/ledger.jsonl` (`obs/ledger.py`); a row's `cache_misses`
  counts the libraries built during that call (0 after the prebuild).
"""

from __future__ import annotations

import dataclasses
import math
import time

from ..analyze import eval_trend
from ..core.config import ExperimentConfig, StageConfig
from ..data.mixture import MixtureDataset, build_mixture
from ..resilience import verify as ckpt_verify


def stage_ckpt_dir(cfg: ExperimentConfig, index: int) -> str:
    """Per-stage checkpoint lineage: stages may disagree on structure
    (model / time_step overrides), so one directory per stage keeps each
    lineage's verification clean."""
    return f"{cfg.train.log_dir}/ckpt-stage{index}"


def stage_config(cfg: ExperimentConfig, stage: StageConfig) -> ExperimentConfig:
    """The base config with this stage's non-sentinel overrides applied
    (None / 0 / "" / () inherit — a stage names only what it changes)."""
    data = cfg.data
    if stage.image_size is not None:
        data = dataclasses.replace(data, image_size=tuple(stage.image_size))
    if stage.gt_size is not None:
        data = dataclasses.replace(data, gt_size=tuple(stage.gt_size))
    if stage.crop_size is not None:
        data = dataclasses.replace(data, crop_size=tuple(stage.crop_size))
    if stage.time_step:
        data = dataclasses.replace(data, time_step=stage.time_step)
    if stage.batch_size:
        data = dataclasses.replace(data, batch_size=stage.batch_size)
    if stage.mixture:
        # the first member is the stage's face for anything that reads
        # cfg.data.dataset (telemetry, eval protocol selection)
        data = dataclasses.replace(data, dataset=stage.mixture[0].dataset)
    out = cfg.replace(data=data)
    if stage.model:
        out = out.replace(model=stage.model)
    if stage.loss_weights:
        out = out.replace(loss=dataclasses.replace(
            out.loss, weights=tuple(float(w) for w in stage.loss_weights)))
    if stage.learning_rate:
        out = out.replace(optim=dataclasses.replace(
            out.optim, learning_rate=stage.learning_rate))
    return out


def stage_dataset(scfg: ExperimentConfig, stage: StageConfig):
    """The stage's dataset: its weighted mixture, or the stage-resolved
    base dataset when the stage declares no mixture."""
    if stage.mixture:
        return build_mixture(scfg.data, stage)
    from ..data.datasets import build_dataset

    return build_dataset(scfg.data)


def plateau_reached(stage: StageConfig, evals: list[dict]) -> bool:
    """The EPE-plateau advance condition, pure in its inputs: True when
    `eval_trend` over this stage's eval records reports an AEE slope
    that has flattened to >= -plateau_slope AEE per 1000 steps (i.e. no
    longer improving faster than the declared threshold), with at least
    max(min_evals, 3) finite stage evals seen."""
    if len(evals) < max(stage.min_evals, 3):
        return False
    trend = eval_trend(evals, window=max(stage.plateau_window, 3))
    if trend is None or not math.isfinite(trend["slope_aee_per_kstep"]):
        return False
    return trend["slope_aee_per_kstep"] >= -abs(stage.plateau_slope)


def find_resume_stage(cfg: ExperimentConfig) -> tuple[int, dict]:
    """(stage index, newest manifest extra) a resume lands in: the
    HIGHEST stage whose checkpoint directory holds a committed step —
    the manifest's ``extra.recipe_stage`` is authoritative when present
    (it survives directory renames), the directory index otherwise.
    (0, {}) for a fresh run."""
    for i in reversed(range(len(cfg.recipe.stages))):
        steps = ckpt_verify.step_dirs(stage_ckpt_dir(cfg, i))
        if not steps:
            continue
        manifest = ckpt_verify.load_manifest(
            ckpt_verify.manifest_path(steps[-1][1]))
        extra = (manifest or {}).get("extra")
        extra = dict(extra) if isinstance(extra, dict) else {}
        return int(extra.get("recipe_stage", i)), extra
    return 0, {}


def prebuild_stages(cfg: ExperimentConfig, device="cuda",
                    stages: "list[int] | None" = None) -> tuple[dict, dict]:
    """Build what the recipe's stages need before its first step: each
    stage's dataset (in `stages`, default all), and on the card every
    CUDA library, built (`build_all`, one nvcc a source at once) and
    loaded.

    Returns (built, report): ``built[i] = {"dataset": ...}`` is handed
    to stage i's Trainer (the same object: a mixture's draw counters
    then count that stage's draws); ``report`` is jsonable: per-stage
    dataset seconds, and each library's build seconds and whether it
    was compiled here or found built."""
    t0 = time.monotonic()
    built: dict[int, dict] = {}
    report: dict = {"device": str(device), "stages": []}
    for i, stage in enumerate(cfg.recipe.stages):
        if stages is not None and i not in stages:
            continue
        t = time.monotonic()
        scfg = stage_config(cfg, stage)
        built[i] = {"dataset": stage_dataset(scfg, stage)}
        report["stages"].append(
            {"stage": i, "name": stage.name, "model": scfg.model,
             "time_step": scfg.data.time_step,
             "dataset_s": round(time.monotonic() - t, 4)})
    if str(device).startswith("cuda"):
        from ..ops.cuda import build

        t = time.monotonic()
        info = build.build_all()
        for name in build.SOURCES:
            build.load(name)
        report["libraries"] = {
            name: {"built": v["built"], "seconds": round(v["seconds"], 4)}
            for name, v in info.items()}
        report["libraries_s"] = round(time.monotonic() - t, 4)
    report["seconds"] = round(time.monotonic() - t0, 4)
    return built, report


def run_recipe(cfg: ExperimentConfig, max_steps: int | None = None,
               num_epochs: int | None = None, device="cuda") -> dict:
    """Drive the staged recipe end to end (``train --recipe``).

    Resumes stage-correct from the newest stage checkpoint (manifest
    ``extra``), prebuilds every remaining stage's dataset and the CUDA
    libraries when ``recipe.warmup``, runs each stage's Trainer to its
    advance condition, and grafts weights forward across stage
    boundaries. ``max_steps`` bounds TOTAL optimizer steps across all
    stages this call (the CLI's --max-steps contract). Returns a
    jsonable summary: final stage/step, per-stage advance causes, the
    grafts, the last stage's fit summary scalars, and with warmup the
    prebuild report and the libraries built after it."""
    from ..ops.cuda import build
    from .checkpoint import transfer_params
    from .loop import Trainer

    stages = cfg.recipe.stages
    if not stages:
        raise ValueError("recipe.enabled with no recipe.stages declared")
    start_stage, resume_extra = find_resume_stage(cfg)
    built, prebuild = ({}, None)
    if cfg.recipe.warmup:
        built, prebuild = prebuild_stages(
            cfg, device=device, stages=list(range(start_stage, len(stages))))
    libraries_before = build.built_count()

    per_stage: list[dict] = []
    grafts: list[dict] = []
    advances = 0
    last_trigger = ""
    gstep = 0
    budget_left = max_steps  # total across every stage's fit
    prev_params = None
    summary: dict[str, float] = {}
    for i in range(start_stage, len(stages)):
        stage = stages[i]
        scfg = stage_config(cfg, stage)
        dataset = built.get(i, {}).get("dataset")
        if dataset is None:
            dataset = stage_dataset(scfg, stage)
        # stage_start_step: where this stage's step budget counts from —
        # for a resumed stage the value its manifests recorded, else the
        # global step the previous stage handed over
        if i == start_stage and resume_extra.get("recipe_stage") == i:
            stage_start = int(resume_extra.get("stage_start_step", gstep))
        else:
            stage_start = gstep

        evals: list[dict] = []
        trigger = {"cause": ""}

        def on_eval(step, metrics, _stage=stage, _evals=evals,
                    _trigger=trigger):
            if _stage.advance != "plateau":
                return False
            aee = metrics.get("aee")
            if aee is None or not math.isfinite(float(aee)):
                return False
            _evals.append({"step": int(step), "aee": float(aee)})
            del _evals[:-max(cfg.recipe.max_trigger_evals, 8)]
            if plateau_reached(_stage, _evals):
                _trigger["cause"] = "plateau"
                return True
            return False

        def recipe_stats(_i=i, _dataset=dataset):
            out = {"recipe_stage": _i, "recipe_stages": len(stages),
                   "recipe_advances": advances,
                   "recipe_last_trigger": last_trigger or None}
            if isinstance(_dataset, MixtureDataset):
                out.update(_dataset.mixture_stats())
            return out

        trainer = Trainer(
            scfg, dataset=dataset, device=device,
            ckpt_dir=stage_ckpt_dir(cfg, i),
            manifest_extra={"recipe_stage": i,
                            "recipe_stage_name": stage.name,
                            "stage_start_step": stage_start},
            extra_stats=recipe_stats, on_eval=on_eval,
            exec_names=(f"train_step_stage{i}", f"eval_step_stage{i}"))
        if int(trainer.state.step) == 0 and prev_params is not None:
            # fresh stage: graft the previous stage's weights (the trunk
            # transfers, shape-mismatched heads keep their fresh init)
            # and carry the global step
            params, n_copied, n_skipped = transfer_params(
                trainer.model.state_dict(), prev_params)
            trainer.model.load_state_dict(params)
            trainer.state.step = gstep
            grafts.append({"stage": i, "copied": n_copied,
                           "reinitialized": n_skipped})
            trainer.logger.log(
                "info", gstep,
                message=f"recipe stage {i} ({stage.name}): started at "
                        f"step {gstep}; {n_copied} tensors grafted from "
                        f"stage {i - 1}, {n_skipped} re-initialized")
        gstep = int(trainer.state.step)

        # step budget of this fit: the stage's own target (absolute:
        # stage_start + steps) intersected with the recipe-wide cap
        remaining = None
        if stage.steps > 0:
            remaining = stage_start + stage.steps - gstep
        if budget_left is not None:
            remaining = (budget_left if remaining is None
                         else min(remaining, budget_left))
        stage_out: dict[str, float] = {}
        if remaining is None or remaining > 0:
            # epochs sized so the epoch budget never truncates a
            # steps/plateau-bounded stage
            if remaining is not None:
                epochs = max(
                    -(-(gstep + remaining) // trainer.steps_per_epoch) + 1,
                    1)
            else:
                epochs = num_epochs or scfg.train.num_epochs
            stage_out = trainer.fit(num_epochs=epochs, max_steps=remaining)
        new_gstep = int(trainer.state.step)
        if budget_left is not None:
            budget_left -= max(new_gstep - gstep, 0)
        gstep = new_gstep
        prev_params = trainer.model.state_dict()
        summary = stage_out

        cause = trigger["cause"]
        if not cause and stage.steps > 0 and \
                gstep >= stage_start + stage.steps:
            cause = "steps"
        elif not cause:
            cause = "budget"  # epoch/--max-steps budget ended the fit
        per_stage.append({"stage": i, "name": stage.name,
                          "start_step": stage_start, "end_step": gstep,
                          "advance": cause})
        out_of_budget = budget_left is not None and budget_left <= 0
        if i + 1 < len(stages) and not out_of_budget \
                and cause in ("steps", "plateau"):
            advances += 1
            last_trigger = cause
            trainer.logger.log(
                "info", gstep,
                message=f"recipe advance: stage {i} ({stage.name}) -> "
                        f"stage {i + 1} ({stages[i + 1].name}) on "
                        f"'{cause}' at step {gstep}")
            continue
        break  # terminal stage, exhausted budget, or untriggered fit

    result = {"final_stage": per_stage[-1]["stage"] if per_stage else
              start_stage,
              "global_step": gstep, "advances": advances,
              "last_trigger": last_trigger or None,
              "per_stage": per_stage, "grafts": grafts,
              **{k: float(v) for k, v in summary.items()
                 if isinstance(v, (int, float))}}
    if prebuild is not None:
        result["prebuild"] = prebuild
        result["libraries_built_after_prebuild"] = (
            build.built_count() - libraries_before)
    return result
