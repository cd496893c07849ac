"""Start every process hot (port of `deepof_tpu/train/warmup.py`): the
`warmup` verb's functions.

What warms up here. The JAX package lowers and compiles each executable
ahead of time from shape specs alone, into its persistent XLA cache and,
for the serving lattice, into the artifact store; nothing executes. This
package compiles nothing per call: its only compile is a CUDA library's
`nvcc` run (`ops/cuda/build.py`, once per source hash), and a call
cannot be traced without running it. So its warmup builds the libraries
an executable launches and then runs ONE call of it on zero inputs,
traced into a ledger row (`obs/ledger.py::ExecutableLedger.record_aot`,
compile_kind "aot"), where JAX's executes nothing:

  warmup_compile(cfg)  the train step (and the eval step): the libraries
      they launch built (a second run shows 0 built), one traced call of
      each on a zero batch of the config's shapes;
  warmup_recipe(cfg)  every stage of a staged recipe, on
      `train/recipe.py::prebuild_stages` (each stage's dataset and every
      library), then one traced call a stage's train and eval step
      (`train_step_stage<i>`, `eval_step_stage<i>`);
  warmup_serve(cfg)  the whole serving lattice (`serve.buckets` x
      `serve.precisions` x the modes, {cold} or {cold, warm} under
      `serve.session.warm_start`, and the quality scorer a bucket when
      `obs.quality_sample_rate` > 0), with the model initialised from
      `train.seed` at the config's shapes (no checkpoint is needed, as
      in JAX), through an `InferenceEngine`'s own lattice, so each row
      has the fingerprint that engine's `warm()` records; with
      `serve.artifacts_dir`, each entry is published to the store (the
      single writer) and the index is written;
  deep_verify_serve(cfg)  the offline twin of the engine's deep verify
      (`artifacts verify --deep`): each lattice entry traced and its
      fingerprint held to the index's; `entries`, `ok`, `drift` and
      `unindexed` as JAX reports them.

The JAX module's compile-cache half (`enable_compile_cache`,
`cache_delta`, `train.compile_cache`) has no counterpart: a library's
hash is its cache key, and its build directory is the cache.
"""

from __future__ import annotations

import sys
import time
from typing import Any

import numpy as np

from ..core.config import ExperimentConfig


def train_libraries(cfg: ExperimentConfig) -> tuple[str, ...]:
    """The CUDA libraries a train or eval step of `cfg` launches: the
    correlation's forward and backward for a model with a cost volume,
    and the warp's for every model that a flow loss trains (all but the
    spatial-stream classifier)."""
    from ..models.registry import MODELS, _fields

    cls = MODELS.get(cfg.model)
    names = (["corr", "corr_bwd"]
             if cls is not None and "max_disp" in _fields(cls) else [])
    if cfg.model != "ucf101_spatial":
        names.append("warp")
    return tuple(names)


def build_libraries(names, device) -> dict[str, dict]:
    """Build (on the card, and load) each library of `names`: {name:
    {"built", "seconds"}}; {} on the CPU, which launches none."""
    import torch

    if torch.device(device).type != "cuda":
        return {}
    from ..ops.cuda import build

    out = {}
    for n in names:
        info = build.build(n)
        build.load(n)
        out[n] = {"built": info["built"],
                  "seconds": round(info["seconds"], 4)}
    return out


def _zeros(batch: dict) -> dict:
    """A host batch with every array zeroed (its dtypes and shapes
    kept; a non-array entry such as the augmentation seed as it is)."""
    return {k: np.zeros_like(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


def _report_entry(row: dict) -> dict:
    """The per-executable line of a warmup report (JAX's keys)."""
    return {"name": row["name"], "compile_s": row["compile_s"],
            "fingerprint": row["fingerprint"],
            "cache_hits": row["cache_hits"],
            "cache_misses": row["cache_misses"]}


def _trace_steps(trainer, ledger, names: tuple[str, str],
                 include_eval: bool) -> list[dict]:
    """One traced call of the trainer's train step (and eval step) on a
    zero batch of its shapes, staged as the loop stages one (on the
    device, augmented there, the call's first step beside it), so the
    train row's fingerprint is the one `fit`'s first call records: their
    ledger rows."""
    from .step import STEP_KEY, batch_to_device

    cfg = trainer.cfg
    k = max(cfg.train.steps_per_call, 1)
    rng = np.random.RandomState(0)
    one = _zeros(trainer._next_train_batch(0, rng))
    host = one if k == 1 else {
        key: np.stack([v] * k) if isinstance(v, np.ndarray) else v
        for key, v in one.items()}
    batch = {**host, **batch_to_device(host, trainer.device)}
    if trainer.augment is not None:
        batch = trainer.augment(batch)
    batch[STEP_KEY] = 0
    rows = []
    _, row = ledger.record_aot(
        names[0], lambda: trainer.train_step(trainer.state, batch),
        trainer.device,
        inputs=(list(trainer.model.parameters()),
                list(trainer.state.optimizer.state.values()), batch))
    rows.append(row)
    if include_eval:
        val = _zeros(trainer.dataset.sample_val(
            max(cfg.train.eval_batch_size, 1), 0))
        _, row = ledger.record_aot(
            names[1], lambda: trainer.eval_fn(trainer.model, val),
            trainer.device,
            inputs=(list(trainer.model.parameters()), val))
        rows.append(row)
    return rows


def _ledger(cfg: ExperimentConfig, device):
    import torch

    from ..obs.ledger import ExecutableLedger

    return ExecutableLedger(cfg.train.log_dir, enabled=cfg.obs.ledger,
                            backend=torch.device(device).type)


def warmup_compile(cfg: ExperimentConfig, include_eval: bool = True,
                   device="cuda") -> dict:
    """Build the libraries the train (and eval) step of `cfg` launches,
    then trace one call of each on zero inputs into a ledger row
    ("aot"). Returns JAX's report keys (`model`, `steps_per_call`,
    `backend`, `cache_dir` None, `executables`, `train_compile_s`,
    `eval_compile_s`, `cache`: the libraries requested, found built
    (hits) and built by this call (misses)) and `libraries` (each one's
    build)."""
    from ..ops.cuda import build
    from .loop import Trainer

    trainer = Trainer(cfg, device=device)
    before = build.built_count()
    libs = build_libraries(train_libraries(cfg), trainer.device)
    ledger = _ledger(cfg, trainer.device)
    rows = _trace_steps(trainer, ledger, ("train_step", "eval_step"),
                        include_eval)
    built = build.built_count() - before
    out: dict[str, Any] = {
        "model": cfg.model,
        "steps_per_call": max(cfg.train.steps_per_call, 1),
        "backend": trainer.device.type, "cache_dir": None,
        "executables": [_report_entry(r) for r in rows],
        "train_compile_s": rows[0]["compile_s"],
        "libraries": libs,
        "cache": {"requests": len(libs), "hits": len(libs) - built,
                  "misses": built}}
    if include_eval:
        out["eval_compile_s"] = rows[1]["compile_s"]
    return out


def warmup_recipe(cfg: ExperimentConfig, device="cuda") -> dict:
    """Every stage of the recipe: `prebuild_stages` (each stage's dataset,
    and on the card every library), then one traced call of each stage's
    train and eval step into `train_step_stage<i>` / `eval_step_stage<i>`
    rows, on the prebuilt dataset. Returns the prebuild report with
    `stages[i]["executables"]`."""
    from .loop import Trainer
    from .recipe import prebuild_stages, stage_config

    built, report = prebuild_stages(cfg, device)
    ledger = _ledger(cfg, device)
    for i, stage in enumerate(cfg.recipe.stages):
        trainer = Trainer(stage_config(cfg, stage),
                          dataset=built[i]["dataset"], device=device)
        rows = _trace_steps(trainer, ledger, (f"train_step_stage{i}",
                                              f"eval_step_stage{i}"), True)
        report["stages"][i]["executables"] = [_report_entry(r)
                                              for r in rows]
        del trainer
    return report


def _serve_engine(cfg: ExperimentConfig, device):
    """An engine of `cfg` for warmup: the model initialised from
    `train.seed` (no checkpoint), no store of its own (warmup is the
    writer), no ledger file (the caller records)."""
    import dataclasses

    from ..serve.engine import InferenceEngine

    return InferenceEngine(cfg.replace(
        serve=dataclasses.replace(cfg.serve, artifacts_dir=""),
        obs=dataclasses.replace(cfg.obs, ledger=False)), device=device)


def warmup_serve(cfg: ExperimentConfig, device="cuda") -> dict:
    """Trace every entry of the serving lattice of `cfg` (module
    docstring) into an "aot" row, in the engine's own `warm()` order and
    calls, after building the libraries it launches. With
    `serve.artifacts_dir`, each entry is published to the store under
    its fingerprint with the libraries its call launched (a rerun
    against a warm store finds each: compile_kind "artifact"), and one
    index entry per published entry is merged into `index.json` in one
    rename after the whole lattice. Returns JAX's report keys:
    `model`, `max_batch`, `backend`, `tiers`, `modes`, `buckets` (one
    entry per executable: bucket, tier, mode ("quality" for a scorer),
    compile_s, fingerprint, libraries, artifact verdict) and, with a
    store, `artifacts` (dir, published, exists, hits, errors,
    index_entries, config_digest)."""
    import torch

    from ..serve.artifacts import serve_config_digest, store_for_config
    from ..serve.engine import serve_libraries

    device = torch.device(device)
    libs = build_libraries(serve_libraries(cfg), device)
    eng = _serve_engine(cfg, device)
    ledger = _ledger(cfg, device)
    store = store_for_config(cfg, device)
    digest = serve_config_digest(cfg)
    index: dict[str, dict] = {}
    modes = ("cold", "warm") if cfg.serve.session.warm_start else ("cold",)
    out: dict[str, Any] = {"model": cfg.model, "max_batch": eng.max_batch,
                           "backend": device.type, "cache_dir": None,
                           "tiers": list(eng.tiers), "modes": list(modes),
                           "libraries": libs, "buckets": []}
    try:
        for entry in eng.lattice():
            _, row = ledger.record_aot(entry.name, entry.fn, device,
                                       entry.inputs, artifacts=store)
            rec = {"bucket": list(entry.bucket),
                   "tier": entry.key[1] if entry.key else "-",
                   "mode": entry.key[2] if entry.key else "quality",
                   "compile_s": row["compile_s"],
                   "fingerprint": row["fingerprint"],
                   "libraries": ledger.libraries[entry.name]}
            if store is not None:
                art = ("hit" if row["compile_kind"] == "artifact"
                       else store.publish(
                           row["fingerprint"], ledger.libraries[entry.name],
                           name=entry.name, compile_s=row["compile_s"]))
                rec["artifact"] = art
                if art in ("hit", "published", "exists"):
                    # only an entry that is in the store is indexed: one
                    # whose target is absent would reject at every boot
                    index[eng.index_key(entry)] = {
                        "name": entry.name, "fingerprint": row["fingerprint"],
                        "config_digest": digest,
                        "aval_sig": eng.signature(entry),
                        "backend": device.type, "torch": torch.__version__,
                        "libraries": ledger.libraries[entry.name],
                        "created": time.time()}
            out["buckets"].append(rec)
    finally:
        eng.close()
    if store is not None:
        from ..serve.artifacts import write_index

        arts = [b.get("artifact") for b in out["buckets"]]
        out["artifacts"] = {
            "dir": store.root,
            "published": arts.count("published"),
            "exists": arts.count("exists"), "hits": arts.count("hit"),
            "errors": sum(1 for a in arts
                          if isinstance(a, str) and a.startswith("error")),
            "config_digest": digest}
        try:
            write_index(store.root, index)
            out["artifacts"]["index_entries"] = len(index)
        except OSError as e:
            print(f"warmup: index publish failed: {e}", file=sys.stderr)
            out["artifacts"]["index_entries"] = 0
    return out


def deep_verify_serve(cfg: ExperimentConfig, device="cuda") -> dict:
    """Trace every lattice entry of `cfg` (as `warmup_serve` does) and
    hold each fingerprint to the one the store's index maps its key to:
    "ok", "drift" (an index boot would serve another computation than
    the index describes) or "unindexed" (it would take the traced path).
    Publishes and repairs nothing. Raises ValueError without a store."""
    import torch

    from ..obs.ledger import trace_call
    from ..serve.artifacts import serve_config_digest, store_for_config

    store = store_for_config(cfg, device)
    if store is None:
        raise ValueError("artifacts verify --deep needs "
                         "serve.artifacts_dir (or --dir) set")
    device = torch.device(device)
    eng = _serve_engine(cfg, device)
    entries = []
    try:
        for entry in eng.lattice():
            key = eng.index_key(entry)
            _, fields = trace_call(entry.fn, device, entry.inputs)
            indexed = (store.index_entry(key) or {}).get("fingerprint")
            local = fields["fingerprint"]
            entries.append({"name": entry.name, "key": key,
                            "indexed": indexed, "local": local,
                            "status": ("unindexed" if indexed is None
                                       else "ok" if indexed == local
                                       else "drift")})
    finally:
        eng.close()
    return {
        "dir": store.root, "backend": device.type,
        "config_digest": serve_config_digest(cfg),
        "entries": entries, "total": len(entries),
        "ok": sum(1 for e in entries if e["status"] == "ok"),
        "drift": [e["name"] for e in entries if e["status"] == "drift"],
        "unindexed": [e["name"] for e in entries
                      if e["status"] == "unindexed"],
    }
