"""Command-line entry point (port of the `train`, `eval`, `predict`,
`serve`, `config`, `warmup`, `bench`, `verify-ckpt`, `artifacts`,
`incidents`, `analyze` and `tail` verbs of `deepof_tpu/cli.py`; its
`lint` verb checks the JAX package and needs no port).

Usage:
    python -m deepof_tpu_torch train --preset flyingchairs --model flownet_s \
        --data-path /data/fc --log-dir /runs/fc1
    python -m deepof_tpu_torch eval --model flownet_s --data-path /data/fc \
        --log-dir /runs/fc1                       # newest checkpoint
    python -m deepof_tpu_torch predict --model flownet_s --log-dir /runs/fc1 \
        --pairs a.png:b.png --out /tmp/flows \
        --set "serve.precisions=('f32','int8')" --precision int8
    python -m deepof_tpu_torch train --preset sintel --model flownet_s \
        --data-path /data/MPI-Sintel --set train.dump_visuals=true
    python -m deepof_tpu_torch train --preset ucf101 --data-path /data/ucf \
        --log-dir /runs/u1          # st_single; --model st_baseline, ...
    python -m deepof_tpu_torch predict --preset ucf101 --log-dir /runs/u1 \
        --action --pairs a.ppm:b.ppm --out /tmp/act --labels classes.txt
    python -m deepof_tpu_torch serve --model flownet_c --log-dir /runs/c1
    python -m deepof_tpu_torch serve --model flownet_c --log-dir /runs/c1 \
        --input /data/frames --out /tmp/flows     # offline: a directory
    python -m deepof_tpu_torch serve --model flownet_c --log-dir /runs/c1 \
        --replicas 2                # a supervised fleet behind a router
    python -m deepof_tpu_torch serve --model flownet_c --log-dir /runs/c1 \
        --autoscale --min-replicas 1 --max-replicas 3
    python -m deepof_tpu_torch config --preset sintel
    python -m deepof_tpu_torch train --preset flyingchairs --synthetic
    python -m deepof_tpu_torch bench            # the headline train step
    python -m deepof_tpu_torch bench --data-only --workers 4
    python -m deepof_tpu_torch train --preset flyingchairs --data-path /data \
        --recipe recipe.json --log-dir /runs/r1   # staged: ckpt-stage<i>/
    python -m deepof_tpu_torch bench --data-only --recipe recipe.json
    torchrun --nproc_per_node 2 -m deepof_tpu_torch train --multihost \
        --model flownet_c --synthetic --log-dir /runs/ddp   # two ranks
    python -m deepof_tpu_torch train --model flownet_c --synthetic \
        --elastic 3 --max-steps 100 --log-dir /runs/el  # an elastic pool
    python -m deepof_tpu_torch analyze --log-dir /runs/r1 [--no-plot]
    python -m deepof_tpu_torch tail --log-dir /runs/c1 [--fleet] [--follow]
    python -m deepof_tpu_torch verify-ckpt /runs/fc1
    python -m deepof_tpu_torch warmup --model flownet_c --serve-only \
        --artifacts /stores/exec     # publish the serving lattice
    python -m deepof_tpu_torch serve --model flownet_c --log-dir /runs/c1 \
        --artifacts /stores/exec     # boot from it (index, no trace)
    python -m deepof_tpu_torch artifacts verify --dir /stores/exec [--deep]
    python -m deepof_tpu_torch incidents list --log-dir /runs/c1
    python -m deepof_tpu_torch incidents ack --log-dir /runs/c1 [--id ID]

The flags mean what they mean in the JAX package: `--preset`, `--model`,
`--data-path`, `--log-dir`, `--set section.field=value` (any config
field), `--synthetic` (the synthetic dataset at 64x64, batch 8),
`--epochs`, `--max-steps`/`--steps`, `--trace` (`obs.trace`: a span
timeline in <log-dir>/trace.json), `--profile` and `--profile-steps a:b`
(a `torch.profiler` Chrome trace of the run or of steps [a, b) under
<log-dir>/profile/), `--dump-visuals` (eval), `--pairs prev:next`,
`--out`, `--no-png` (predict, serve), `--precision` (a tier of
`serve.precisions`), `--action` (predict: classify each pair with an
action model's head into `<out>/actions.json`, top-5 classes and their
softmax probabilities), `--labels FILE` (class names, one a line) and
`--ckpt-dir DIR` (the checkpoint directory, default `<log-dir>/ckpt`; a
recipe's stage i is `<log-dir>/ckpt-stage<i>`), `--recipe FILE` (train:
a staged recipe, `train/recipe.py`; the file implies recipe.enabled and
`--set recipe.*` overrides it),
and for `serve` `--input` (offline mode: the
consecutive pairs of a directory of frames, written to `--out`; without
it, the HTTP server of `serve/server.py` on serve.host:serve.port),
`--session-ttl` and `--session-max` (`serve.session.ttl_s` and
`max_sessions`), `--replicas N` (N > 1: the fleet of `serve/fleet.py`,
N replica processes behind a router), `--autoscale` (the fleet sized by
`serve/autoscale.py` between `--min-replicas` and `--max-replicas`;
fleet mode even at one replica), `--artifacts DIR`
(`serve.artifacts_dir`: the artifact store, `serve/artifacts.py`).
`warmup` (`train/warmup.py`) builds the libraries of the train and
eval steps and traces one call of each on zero inputs into the ledger
(`--no-eval`, `--recipe FILE`: every stage), and with `--serve` or
`--serve-only` the serving lattice, published to `--artifacts DIR` with
its index. `artifacts {list,verify,gc}` reads a store without torch
(`--dir`, default `artifacts/exec_torch`; `--older-than-days`,
`--json-indent`): rc 1 when an entry is corrupt, 2 when the store is
empty; `verify --deep` (with the publishing config's `--preset`,
`--model`, `--set` and `--device`) traces the lattice and exits 1 on
drift, 2 when nothing is indexed. `bench` takes the JAX verb's flags
(`--model`, `--batch`, `--steps`, `--data-only`, `--workers`,
`--batches`, `--image-size`, `--dataset`, `--data-path`, `--recipe`:
the first stage's mixture) and `--device`; `analyze --log-dir DIR
[--no-plot]` prints the run's summary (`analyze.py`, the fleet's
children aggregated); `tail --log-dir DIR [--recent N] [--fleet]
[--follow] [--interval S] [--ledger-baseline PATH] [--ledger-compile-factor
X] [--ledger-compile-floor-s S] [--ledger-memory-factor X]` prints its
one-glance health and exits as the JAX verb does (`tail_code`: 8, 9, 3,
4, 5, 6, 7, 10, else 0; a missing or empty baseline is an error, never
rc 0). `analyze`, `tail`, `incidents` and `artifacts` (but `--deep`)
import no torch; `verify-ckpt DIR` prints the run's checkpoint report
and exits 1 on a corrupt checkpoint, 2 when there is none. `incidents
{list,show,ack,gc} --log-dir DIR` triages the incident bundles of a run
(`obs/incident.py`; `--id`, `--older-than-days`, `--acked`, `--keep`,
`--json-indent`): `list` exits 1 while a critical bundle is
unacknowledged and 2 when none is recorded; `show` and a named `ack`
exit 1 on an unknown bundle. `serve`
restores the newest checkpoint of `--log-dir` (none under `--set serve.fake_exec_ms=...`); a fleet's
replica restores the newest one of `<log-dir>/replica-<i>`. A train run in a log dir
that holds checkpoints resumes from the newest one; `train` latches a
SIGTERM from its start, and a SIGTERM stops it after a clean final
checkpoint. `--device {cuda,cpu}` (default cuda) is this package's own;
it takes the place of JAX_PLATFORMS. Without a card, cuda raises:
nothing falls back to the CPU. `--multihost` (any verb but the readers)
joins the `torch.distributed` world that torchrun describes before any
model is built (`parallel/mesh.py::init_distributed`: NCCL when each
rank has a card, gloo when ranks share one or run on the CPU); `train
--elastic N --max-steps T` (or `elastic.hosts` > 1) runs the elastic
coordinator (`train/elastic.py`) before anything makes a CUDA context,
and refuses `--multihost`, `--epochs` and a recipe, as the JAX command
line does; its children come back as `train --config-json ...
--host-index <i> --device <the coordinator's --device>`. Every JAX flag
is taken. `mesh.spatial` and `mesh.time` do what they do in the JAX
verbs: `train`, `eval`, `train --recipe` and `warmup` build the mesh (a
world whose size is not data x spatial x time raises ValueError) and
shard rows or pairs (`parallel/spatial.py`); `serve` reads no mesh.
Every family shards in float32 and in bf16 compute; the elastic pool
with a spatial or time axis (not ported yet) raises, naming ROADMAP
item 10.3.

Float32 means float32, as the JAX reference computes: the package's
entry points turn TF32 off (`core.device.disable_tf32`:
`torch.backends.cudnn.allow_tf32` and
`torch.backends.cuda.matmul.allow_tf32`). `main` does so before it
builds anything, `Trainer` for a float32 config and `InferenceEngine`
for every config (its bf16 tier computes in float32 too), so a library
caller gets the command line's numbers. Nothing turns TF32 back on.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import time

from .core.config import (PRESETS, ExperimentConfig, config_from_dict,
                          get_config)


def _parse_value(raw: str):
    if raw.lower() in ("true", "false"):  # accept lowercase bools
        return raw.lower() == "true"
    if raw.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def _apply_override(cfg: ExperimentConfig, dotted: str,
                    raw: str) -> ExperimentConfig:
    """Set a dotted config path (`field`, `section.field` or deeper) on
    the frozen config tree, returning a new config."""
    value = _parse_value(raw)

    def rec(node, parts: list[str]):
        name, rest = parts[0], parts[1:]
        if not (dataclasses.is_dataclass(node) and hasattr(node, name)):
            raise SystemExit(f"unknown config field {dotted!r}")
        new = rec(getattr(node, name), rest) if rest else value
        return dataclasses.replace(node, **{name: new})

    return rec(cfg, dotted.split("."))


def _recipe_from_file(cfg: ExperimentConfig, path: str) -> ExperimentConfig:
    """Load a `--recipe FILE` JSON (a RecipeConfig dict, train/recipe.py)
    into the config, as the JAX command line does: the file implies
    recipe.enabled; unknown keys are rejected at every nesting level
    (stages[i], stages[i].mixture[j])."""
    from .core.config import recipe_from_dict

    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"--recipe {path!r}: {e}")
    if not isinstance(d, dict):
        raise SystemExit(f"--recipe {path!r}: expected a JSON object "
                         '(a RecipeConfig dict with a "stages" list)')
    d.setdefault("enabled", True)
    try:
        return cfg.replace(recipe=recipe_from_dict(d))
    except (TypeError, ValueError) as e:
        raise SystemExit(f"--recipe {path!r}: {e}")


def _build_cfg(args) -> ExperimentConfig:
    if getattr(args, "config_json", None):
        # the fleet's parent -> replica handoff: the exact serialized
        # config tree, not a preset re-derivation (--set still wins)
        with open(args.config_json) as f:
            cfg = config_from_dict(json.load(f))
    else:
        cfg = get_config(args.preset)
    if args.model:
        cfg = cfg.replace(model=args.model)
    if args.data_path:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data,
                                                   data_path=args.data_path))
    if args.log_dir:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    log_dir=args.log_dir))
    if args.synthetic:
        # before --set, so explicit overrides win over the smoke defaults
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, dataset="synthetic", image_size=(64, 64),
            gt_size=(64, 64), batch_size=8, crop_size=None, time_step=2),
            train=dataclasses.replace(cfg.train, eval_batch_size=8,
                                      eval_amplifier=1.0))
    if getattr(args, "recipe", None):
        # before --set, so an explicit --set recipe.* wins over the file
        cfg = _recipe_from_file(cfg, args.recipe)
    # the serve sugar flags, before --set so an explicit --set wins
    for flag, dotted in (("session_ttl", "serve.session.ttl_s"),
                         ("session_max", "serve.session.max_sessions"),
                         ("min_replicas", "serve.fleet.min_replicas"),
                         ("max_replicas", "serve.fleet.max_replicas"),
                         ("artifacts", "serve.artifacts_dir")):
        value = getattr(args, flag, None)
        if value is not None:
            cfg = _apply_override(cfg, dotted, repr(value))
    if getattr(args, "autoscale", False):
        cfg = _apply_override(cfg, "serve.fleet.autoscale", "true")
    return apply_sets(cfg, args.set or [])


def apply_sets(cfg: ExperimentConfig, items) -> ExperimentConfig:
    """`cfg` with each `SECTION.FIELD=VALUE` of `items` (the `--set`
    flags) applied in order."""
    for item in items:
        if "=" not in item:
            raise SystemExit(f"bad --set {item!r}: use section.field=value")
        dotted, raw = item.split("=", 1)
        cfg = _apply_override(cfg, dotted, raw)
    return cfg


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", default="flyingchairs", choices=sorted(PRESETS))
    p.add_argument("--model", default=None)
    p.add_argument("--data-path", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--set", action="append", metavar="SECTION.FIELD=VALUE")
    p.add_argument("--synthetic", action="store_true",
                   help="the synthetic dataset at 64x64, batch 8 (smoke "
                        "runs; no data on disk)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs (default cuda, which raises "
                        "without a card)")
    p.add_argument("--multihost", action="store_true",
                   help="join the torch.distributed world that torchrun "
                        "describes (parallel/mesh.py::init_distributed): "
                        "NCCL when each rank has a card, gloo when ranks "
                        "share one or run on the CPU; --set "
                        "data.batch_size is the global batch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deepof_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a model")
    _add_common(p_train)
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("--max-steps", "--steps", dest="max_steps",
                         type=int, default=None)
    p_train.add_argument("--recipe", default=None, metavar="FILE",
                         help="a staged training recipe (a RecipeConfig "
                              "JSON, train/recipe.py); implies "
                              "recipe.enabled, --set recipe.* overrides it")
    p_train.add_argument("--elastic", type=int, default=None, metavar="N",
                         help="the elastic trainer pool (train/elastic.py): "
                              "supervise N single-host trainer processes "
                              "that survive the loss or preemption of a "
                              "host (barrier, re-form on the survivors, "
                              "resume from the newest verified checkpoint). "
                              "Needs --max-steps (the absolute target "
                              "step); overrides elastic.hosts; <= 1 trains "
                              "one process")
    p_train.add_argument("--host-index", type=int, default=None,
                         help=argparse.SUPPRESS)  # an elastic child's index
    p_train.add_argument("--config-json", default=None,
                         help=argparse.SUPPRESS)  # a config tree as JSON
    p_train.add_argument("--profile", action="store_true",
                         help="torch.profiler trace of the whole run")
    p_train.add_argument("--profile-steps", default=None, metavar="A:B",
                         help="torch.profiler trace of steps [A, B) only")
    p_train.add_argument("--trace", action="store_true",
                         help="span timeline (obs.trace=true)")

    p_eval = sub.add_parser("eval", help="evaluate the newest checkpoint")
    _add_common(p_eval)
    p_eval.add_argument("--dump-visuals", action="store_true",
                        help="write the first val batch's flow colours, "
                             "reconstruction and ground truth as PNGs "
                             "under <log-dir>/visuals")

    p_pred = sub.add_parser(
        "predict", help="run the newest checkpoint on image pairs; write "
                        ".flo files")
    _add_common(p_pred)
    p_pred.add_argument("--pairs", nargs="+", required=True,
                        metavar="PREV:NEXT",
                        help="image path pairs (PNG, JPEG, PPM or a .npy "
                             "BGR array), colon-separated")
    p_pred.add_argument("--out", required=True, help="output directory")
    p_pred.add_argument("--no-png", action="store_true",
                        help="write only the .flo, not its flow-colour PNG")
    p_pred.add_argument("--precision", default=None,
                        choices=("f32", "bf16", "int8"),
                        help="serving precision tier, one of "
                             "serve.precisions (default: its first)")
    p_pred.add_argument("--action", action="store_true",
                        help="classify each pair with a trained action "
                             "model (st_single, st_baseline, "
                             "ucf101_spatial) instead of predicting flow: "
                             "writes <out>/actions.json with the top-5 "
                             "classes and softmax probabilities a pair")
    p_pred.add_argument("--labels", default=None, metavar="FILE",
                        help="--action: class names, one a line in index "
                             "order, attached to the predictions")
    p_pred.add_argument("--ckpt-dir", "--ckpt", dest="ckpt_dir",
                        default=None, metavar="DIR",
                        help="--action: the checkpoint directory (default "
                             "<log-dir>/ckpt)")

    p_srv = sub.add_parser(
        "serve", help="serve the newest checkpoint: an HTTP server (POST "
                      "/v1/flow, POST /v1/flow/stream, GET /healthz, GET "
                      "/metrics), or with --input a directory of frames "
                      "to --out")
    _add_common(p_srv)
    p_srv.add_argument("--input", default=None,
                       help="offline mode: a directory of frames "
                            "(consecutive sorted pairs)")
    p_srv.add_argument("--out", default=None,
                       help="offline mode: where the .flo/.png go")
    p_srv.add_argument("--no-png", action="store_true")
    p_srv.add_argument("--session-ttl", type=float, default=None,
                       metavar="SECONDS",
                       help="--set serve.session.ttl_s=SECONDS")
    p_srv.add_argument("--session-max", type=int, default=None,
                       metavar="N",
                       help="--set serve.session.max_sessions=N")
    p_srv.add_argument("--replicas", type=int, default=None,
                       help="N > 1: a supervised fleet of N replica "
                            "processes behind a health-gated router "
                            "(serve.fleet.*); overrides "
                            "serve.fleet.replicas")
    p_srv.add_argument("--autoscale", action="store_true",
                       help="size the fleet from its load between "
                            "--min-replicas and --max-replicas "
                            "(--set serve.fleet.autoscale=true); fleet "
                            "mode even without --replicas")
    p_srv.add_argument("--min-replicas", type=int, default=None,
                       metavar="N",
                       help="--set serve.fleet.min_replicas=N")
    p_srv.add_argument("--max-replicas", type=int, default=None,
                       metavar="N",
                       help="--set serve.fleet.max_replicas=N")
    p_srv.add_argument("--artifacts", default=None, metavar="DIR",
                       help="boot from this artifact store (`warmup "
                            "--serve --artifacts DIR` publishes it): the "
                            "libraries fetched instead of built, the "
                            "lattice resolved through its index with no "
                            "trace; --set serve.artifacts_dir=DIR")
    p_srv.add_argument("--config-json", default=None,
                       help=argparse.SUPPRESS)  # a fleet replica's config

    p_cfg = sub.add_parser("config", help="print the resolved config")
    _add_common(p_cfg)

    p_warm = sub.add_parser(
        "warmup", help="build the CUDA libraries a config's train and eval "
                       "steps launch and trace one call of each into the "
                       "executable ledger (with --serve, the serving "
                       "lattice, published to an artifact store)")
    _add_common(p_warm)
    p_warm.add_argument("--no-eval", action="store_true",
                        help="skip the eval step")
    p_warm.add_argument("--recipe", default=None, metavar="FILE",
                        help="every stage of this training recipe: its "
                             "dataset and libraries, and one traced train "
                             "and eval call a stage")
    p_warm.add_argument("--serve", action="store_true",
                        help="also the serving lattice (serve.buckets x "
                             "serve.precisions x the modes, and the "
                             "quality scorer) at serve.max_batch")
    p_warm.add_argument("--serve-only", action="store_true",
                        help="only the serving lattice")
    p_warm.add_argument("--artifacts", default=None, metavar="DIR",
                        help="publish each serving entry (its libraries "
                             "under its fingerprint) and the index into "
                             "this store; --set serve.artifacts_dir=DIR")

    p_bench = sub.add_parser(
        "bench", help="throughput benchmark: the headline train step, or "
                      "with --data-only the host input pipeline alone")
    p_bench.add_argument("--model", default="inception_v3")
    p_bench.add_argument("--batch", type=int, default=16)
    p_bench.add_argument("--steps", type=int, default=20)
    p_bench.add_argument("--data-only", action="store_true",
                         help="time the host input pipeline alone "
                              "(batches/s, MB/s; no model, no device)")
    p_bench.add_argument("--workers", type=int, default=0,
                         help="data-only mode: pipeline worker threads")
    p_bench.add_argument("--batches", type=int, default=32,
                         help="data-only mode: batches to time")
    p_bench.add_argument("--image-size", default="64x64", metavar="HxW",
                         help="data-only mode: decoded image size")
    p_bench.add_argument("--dataset", default="synthetic",
                         help="data-only mode: synthetic, flyingchairs, "
                              "ucf101 or "
                              "sintel")
    p_bench.add_argument("--data-path", default="",
                         help="data-only mode: dataset root on disk")
    p_bench.add_argument("--recipe", default=None, metavar="FILE",
                         help="data-only mode: time the recipe's first "
                              "stage's weighted mixture (data/mixture.py) "
                              "in place of a single --dataset")
    p_bench.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                         help="train mode: where the step runs (default "
                              "cuda, which raises without a card)")

    p_vck = sub.add_parser(
        "verify-ckpt",
        help="check every checkpoint of a run against its manifest "
             "(nonzero exit on corruption)")
    p_vck.add_argument("dir",
                       help="a run's --log-dir or its ckpt/ subdirectory")

    p_an = sub.add_parser("analyze", help="summarize a run's metrics log")
    p_an.add_argument("--log-dir", required=True)
    p_an.add_argument("--no-plot", action="store_true")

    p_tail = sub.add_parser(
        "tail", help="one-glance health of a live or finished run: step, "
                     "loss, recent vs overall throughput, phase shares, "
                     "starvation, resilience counters, heartbeat age; "
                     "exits 8 when the executable ledger drifted "
                     "against its baseline (fingerprint drift, a "
                     "library rebuilt that the baseline found built, a "
                     "first-call blowup, memory growth; with --fleet, "
                     "any replica's ledger), 9 while a critical incident "
                     "bundle is unacknowledged, 3 when the heartbeat "
                     "reports wedged, 4 when a serving fleet evicted or "
                     "broke a replica, 5 when an elastic run re-formed, "
                     "6 when the SLO error budget is exhausted, 7 when "
                     "the flow-quality drift verdict is exhausted (with "
                     "--fleet, any replica's), 10 when the brownout "
                     "controller held L3 past serve.degrade."
                     "l3_sustained_s, else 0, checked in that order")
    p_tail.add_argument("--log-dir", required=True)
    p_tail.add_argument("--recent", type=int, default=10,
                        help="train records in the throughput-trend window")
    p_tail.add_argument("--fleet", action="store_true",
                        help="also aggregate the run dir's supervised "
                             "children (fleet replicas) into per-process "
                             "blocks and an exact merged latency "
                             "histogram")
    p_tail.add_argument("--follow", action="store_true",
                        help="re-print every --interval seconds until ^C "
                             "or a nonzero code")
    p_tail.add_argument("--interval", type=float, default=10.0)
    p_tail.add_argument("--ledger-baseline", default=None, metavar="PATH",
                        help="baseline ledger.jsonl (or a run dir holding "
                             "one) for the executable ledger's drift "
                             "verdict (exit 8). Default: <log-dir>/"
                             "ledger_baseline.jsonl when present; no "
                             "baseline = no verdict")
    p_tail.add_argument("--ledger-compile-factor", type=float,
                        default=None, metavar="X",
                        help="first-call blowup bound: fail when an "
                             "executable's compile_s exceeds max(floor, "
                             "baseline * X) (default 2.0)")
    p_tail.add_argument("--ledger-compile-floor-s", type=float,
                        default=None, metavar="S",
                        help="the blowup floor in seconds: below it no "
                             "first-call time fails (default 1.0)")
    p_tail.add_argument("--ledger-memory-factor", type=float,
                        default=None, metavar="X",
                        help="memory-growth bound: fail when argument + "
                             "output + temp bytes exceed baseline * X "
                             "(default 1.2)")

    p_art = sub.add_parser(
        "artifacts",
        help="the artifact store (serve/artifacts.py): list / verify / gc "
             "the entries `warmup --serve` publishes (no torch; rc 1 = "
             "corrupt entries or drift, rc 2 = empty or unindexed store)")
    p_art.add_argument("action", choices=("list", "verify", "gc"),
                       help="list: one line an entry; verify: each entry's "
                            "manifest, fingerprint and library sizes and "
                            "crc32s; gc: remove corrupt entries and "
                            "orphaned staging")
    p_art.add_argument("--deep", action="store_true",
                       help="verify only: trace every serving entry of the "
                            "config (--preset/--model/--set, as published) "
                            "and hold its fingerprint to the index's; rc 1 "
                            "on drift, 2 on an empty or unindexed store")
    p_art.add_argument("--preset", default="flyingchairs",
                       choices=sorted(PRESETS),
                       help="--deep only: the publishing config's preset")
    p_art.add_argument("--model", default=None,
                       help="--deep only: model override")
    p_art.add_argument("--set", action="append",
                       metavar="SECTION.FIELD=VALUE",
                       help="--deep only: config overrides (the publishing "
                            "warmup's)")
    p_art.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="--deep only: where the entries are traced")
    p_art.add_argument("--dir", default=None,
                       help="store root (default <repo>/artifacts/"
                            "exec_torch)")
    p_art.add_argument("--older-than-days", type=float, default=None,
                       metavar="DAYS",
                       help="gc: also remove valid entries older than this "
                            "(the index's targets stay)")
    p_art.add_argument("--json-indent", type=int, default=2)

    p_inc = sub.add_parser(
        "incidents",
        help="incident triage: list / show / ack / gc the bundles under "
             "<log-dir>/incidents/ (rc 1 = unacknowledged critical "
             "incidents, rc 2 = none recorded)")
    p_inc.add_argument("action", choices=("list", "show", "ack", "gc"),
                       help="list: a line a committed bundle and the "
                            "summary; show: one bundle's manifest and "
                            "files; ack: acknowledge bundle(s); gc: remove "
                            "old or acknowledged bundles and orphaned "
                            "staging dirs")
    p_inc.add_argument("--log-dir", required=True)
    p_inc.add_argument("--id", default=None, metavar="ID",
                       help="show: required; ack: one bundle (default: "
                            "all)")
    p_inc.add_argument("--older-than-days", type=float, default=None,
                       metavar="DAYS",
                       help="gc: remove bundles older than this")
    p_inc.add_argument("--acked", action="store_true",
                       help="gc: also remove acknowledged bundles")
    p_inc.add_argument("--keep", type=int, default=None, metavar="N",
                       help="gc: keep at most the newest N bundles")
    p_inc.add_argument("--json-indent", type=int, default=2)

    args = parser.parse_args(argv)
    # the verbs that read a run import no torch: reading a run must not
    # create a CUDA context next to a live trainer or server
    if args.cmd == "incidents":
        return _incidents(args)
    if args.cmd == "artifacts" and not args.deep:
        return _artifacts(args)
    if args.cmd == "tail":
        return _tail(args)
    if args.cmd == "analyze":
        return _analyze(args)
    cfg = None
    if args.cmd == "train":
        # the elastic coordinator makes no CUDA context and trains
        # nothing: dispatched before the torch import, so its children
        # start at once (it refuses --multihost)
        cfg = _build_cfg(args)
        rc = _maybe_elastic(cfg, args)
        if rc is not None:
            return rc
    from .core.supervise import process_age_s

    # a server's boot split (serve/server.py): what came before main,
    # and the torch import the next line makes
    age = process_age_s()
    boot = {"process_to_main_s": None if age is None else round(age, 4)}
    t_torch = time.monotonic()
    from .core.device import disable_tf32

    boot["torch_import_s"] = round(time.monotonic() - t_torch, 4)
    disable_tf32()
    if args.cmd == "verify-ckpt":
        return _verify_ckpt(args.dir)
    if args.cmd == "bench":
        return _bench(args)
    if args.cmd == "artifacts":
        return _artifacts_deep(args)
    if args.multihost:
        # before any model: the trainer's world is the process group's
        from .parallel.mesh import init_distributed, shutdown_distributed

        init_distributed(device=args.device)
        try:
            return _main(args, boot, cfg)
        finally:
            shutdown_distributed()
    return _main(args, boot, cfg)


def _main(args, boot: dict, cfg: ExperimentConfig | None) -> int:
    """`main` after the process group (if any) is joined; `cfg` the
    config `train` built for its elastic dispatch (None: build it)."""
    cfg = cfg if cfg is not None else _build_cfg(args)
    if getattr(args, "trace", False):
        cfg = cfg.replace(obs=dataclasses.replace(cfg.obs, trace=True))
    if args.cmd == "config":
        print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        return 0

    if args.cmd == "serve":
        return _serve(cfg, args, boot)
    if args.cmd == "warmup":
        return _warmup(cfg, args)

    if args.cmd == "predict":
        from .predict import predict_action, predict_pairs, restore_params

        from .serve.quant import resolve_precisions

        pairs = []
        for item in args.pairs:
            if ":" not in item:
                raise SystemExit(f"bad --pairs {item!r}: use prev.ppm:next.ppm")
            pairs.append(tuple(item.split(":", 1)))
        if args.action:
            labels = None
            if args.labels:
                with open(args.labels) as f:
                    labels = [ln.strip() for ln in f if ln.strip()]
            rows = predict_action(cfg, pairs, args.out, labels=labels,
                                  ckpt_dir=args.ckpt_dir, device=args.device)
            print(json.dumps(
                {"written": [os.path.join(args.out, "actions.json")],
                 "actions": rows}))
            return 0
        tiers = resolve_precisions(cfg)
        if args.precision is not None and args.precision not in tiers:
            raise SystemExit(f"--precision {args.precision} is not in "
                             f"serve.precisions {list(tiers)}")
        model = restore_params(cfg, device=args.device)
        written = predict_pairs(cfg, pairs, args.out, model=model,
                                device=args.device,
                                precision=args.precision,
                                write_png=not args.no_png)
        print(json.dumps({"written": written}))
        return 0

    if args.cmd == "train":
        if args.host_index is not None:  # an elastic child's identity
            cfg = cfg.replace(elastic=dataclasses.replace(
                cfg.elastic, host_index=args.host_index))

    from .train.loop import Trainer, install_preemption_latch

    profile_steps = None
    if getattr(args, "profile_steps", None):
        try:
            a, b = (int(x) for x in args.profile_steps.split(":"))
        except ValueError:
            raise SystemExit(f"bad --profile-steps {args.profile_steps!r}: "
                             "use A:B (start:stop global steps)")
        if not 0 <= a < b:
            raise SystemExit(f"bad --profile-steps {args.profile_steps!r}: "
                             "need 0 <= A < B")
        profile_steps = (a, b)
    if args.cmd == "train":
        # before Trainer(): a SIGTERM during the model and kernel build is
        # kept, and fit() turns it into a save-and-stop
        install_preemption_latch()
        if cfg.recipe.enabled and cfg.recipe.stages:
            # a staged recipe (train/recipe.py): one Trainer a stage, the
            # stage index riding the checkpoint manifests
            from .train.recipe import run_recipe

            print(json.dumps(run_recipe(cfg, max_steps=args.max_steps,
                                        num_epochs=args.epochs,
                                        device=args.device)))
            return 0
    trainer = Trainer(cfg, device=args.device,
                      profile=getattr(args, "profile", False),
                      profile_steps=profile_steps)
    if args.cmd == "train":
        out = trainer.fit(num_epochs=args.epochs, max_steps=args.max_steps)
    else:  # eval
        out = trainer.evaluate(dump=args.dump_visuals)
    print(json.dumps({k: (float(v) if isinstance(v, (int, float)) else v)
                      for k, v in out.items()}))
    return 0


def _maybe_elastic(cfg: ExperimentConfig, args) -> int | None:
    """`train --elastic N` (or `elastic.hosts` > 1) outside an elastic
    child (`--host-index`): run the coordinator (train/elastic.py) and
    return its rc, before anything makes a CUDA context; None for a
    plain run."""
    if args.host_index is not None:
        return None
    hosts = args.elastic if args.elastic is not None else cfg.elastic.hosts
    if not (hosts and hosts > 1 and cfg.elastic.host_index < 0):
        return None
    if args.multihost:
        raise SystemExit(
            "train: --elastic and --multihost are exclusive: the elastic "
            "pool supervises one single-host trainer process a host itself")
    if args.epochs is not None:
        raise SystemExit("train: elastic mode needs an absolute target step "
                         "(--max-steps), not --epochs")
    if cfg.recipe.enabled and cfg.recipe.stages:
        raise SystemExit(
            "train: --elastic and --recipe are exclusive: the recipe engine "
            "drives staged single-pool runs (train/recipe.py); run each "
            "stage elastically from a config of its own instead")
    if cfg.mesh.spatial > 1 or cfg.mesh.time > 1:
        # each host is a world of one: rows or pairs to shard refuse
        from .parallel.spatial import check_context_parallel

        check_context_parallel(cfg, elastic=True)
    from .train.elastic import run_elastic

    try:
        return run_elastic(cfg, hosts=hosts, max_steps=args.max_steps,
                           device=args.device)
    except ValueError as e:
        raise SystemExit(f"train --elastic: {e}")


def _warmup(cfg: ExperimentConfig, args) -> int:
    """The `warmup` verb: one JSON line (`train/warmup.py`); rc 0 when it
    completed (a warm tree is the goal, not a failure)."""
    from .train import warmup

    if args.serve_only:
        res = warmup.warmup_serve(cfg, device=args.device)
    else:
        if cfg.recipe.enabled and cfg.recipe.stages:
            res = warmup.warmup_recipe(cfg, device=args.device)
        else:
            res = warmup.warmup_compile(cfg, include_eval=not args.no_eval,
                                        device=args.device)
        if args.serve:
            res["serve"] = warmup.warmup_serve(cfg, device=args.device)
    print(json.dumps(res))
    return 0


def _artifacts(args) -> int:
    """The `artifacts` verb (no torch), as the JAX verb: stdout the JSON
    report; rc 1 when an entry is corrupt, 2 (a note on stderr) when the
    store is empty; gc 0."""
    import sys

    from .serve.artifacts import DEFAULT_STORE_DIR, gc_store, verify_store

    root = args.dir or DEFAULT_STORE_DIR
    if args.action == "gc":
        print(json.dumps(gc_store(root, older_than_days=args.older_than_days),
                         indent=args.json_indent))
        return 0
    report = verify_store(root)
    if args.action == "list":
        print(json.dumps(
            {"dir": report["dir"], "total": report["total"],
             "ok": report["ok"], "corrupt": report["corrupt"],
             "entries": [{"fingerprint": e["fingerprint"],
                          "name": e["name"], "ok": e["ok"],
                          "size": e["size"], "created": e["created"]}
                         for e in report["entries"]]},
            indent=args.json_indent))
    else:
        print(json.dumps(report, indent=args.json_indent))
    if report["corrupt"]:
        return 1
    if not report["entries"]:
        print(f"artifacts: empty store at {root!r}", file=sys.stderr)
        return 2
    return 0


def _artifacts_deep(args) -> int:
    """`artifacts verify --deep`: `deep_verify_serve`'s report; rc 1 on
    drift, 2 on an empty or unindexed store, as the JAX verb."""
    import sys

    from .serve.artifacts import DEFAULT_STORE_DIR
    from .train.warmup import deep_verify_serve

    if args.action != "verify":
        raise SystemExit("artifacts: --deep goes with verify")
    root = args.dir or DEFAULT_STORE_DIR
    args.data_path = args.log_dir = None  # _build_cfg's common args
    args.synthetic = False
    cfg = _apply_override(_build_cfg(args), "serve.artifacts_dir",
                          repr(root))
    report = deep_verify_serve(cfg, device=args.device)
    print(json.dumps(report, indent=args.json_indent))
    if report["drift"]:
        return 1
    if not report["entries"] or report["ok"] == 0:
        print(f"artifacts: nothing indexed to deep-verify at {root!r}",
              file=sys.stderr)
        return 2
    return 0


def _incidents(args) -> int:
    """The `incidents` verb, as the JAX package's: stdout the JSON
    report; rc 1 = attention (unacknowledged critical bundles, or an
    unknown id), rc 2 = no bundle recorded."""
    import sys

    from .obs import incident

    if args.action == "show":
        if not args.id:
            print("incidents show: --id required", file=sys.stderr)
            return 1
        try:
            detail = incident.show_incident(args.log_dir, args.id)
        except FileNotFoundError:
            print(f"incidents: no committed bundle {args.id!r} under "
                  f"{args.log_dir!r}", file=sys.stderr)
            return 1
        print(json.dumps(detail, indent=args.json_indent))
        return 0
    if args.action == "ack":
        acked = incident.ack_incidents(args.log_dir, incident_id=args.id)
        print(json.dumps({"acked": acked}, indent=args.json_indent))
        if args.id is not None and not acked:
            print(f"incidents: no unacknowledged bundle {args.id!r} under "
                  f"{args.log_dir!r}", file=sys.stderr)
            return 1
        return 0
    if args.action == "gc":
        report = incident.gc_incidents(
            args.log_dir, older_than_days=args.older_than_days,
            acked=args.acked, keep=args.keep)
        print(json.dumps(report, indent=args.json_indent))
        return 0
    rows = incident.list_incidents(args.log_dir)
    summary = incident.incident_summary(args.log_dir)
    print(json.dumps(
        {"dir": incident.incidents_dir(args.log_dir), "summary": summary,
         "incidents": [
             {"id": r.get("id"), "kind": r.get("kind"),
              "severity": r.get("severity"), "role": r.get("role"),
              "time": r.get("iso_time"), "acked": r.get("acked"),
              "origin": r.get("origin")} for r in rows]},
        indent=args.json_indent))
    if summary is None:
        print(f"incidents: none recorded under {args.log_dir!r}",
              file=sys.stderr)
        return 2
    return 1 if summary["unacked_critical"] else 0


def _analyze(args) -> int:
    """The `analyze` verb: `analyze.analyze`'s summary as JSON."""
    from .analyze import analyze

    try:
        summary = analyze(args.log_dir, plot=not args.no_plot)
    except FileNotFoundError:
        raise SystemExit(f"no metrics.jsonl under {args.log_dir!r} — is "
                         "this a run's --log-dir?")
    print(json.dumps(summary, indent=2))
    return 0


def tail_code(summary: dict) -> int:
    """The `tail` verb's exit code for one `tail_summary`, as the JAX
    verb's, checked in this order: 8 the executable ledger drifted
    against its baseline (a live verdict, re-derived on every call, so
    it keeps its code ahead of the bundle it records); 9 an
    unacknowledged critical incident bundle (it outranks the cumulative
    counters below, which the same anomaly usually trips too); 3 the
    heartbeat reports a wedge; 4 a
    fleet evicted or broke a replica (scale-downs are not sickness); 5
    an elastic run re-formed or lost hosts; 6 the SLO error budget is
    exhausted (the engine's or the router's block); 7 the flow-quality
    drift verdict is exhausted (with --fleet, any replica's); 10 the
    brownout controller held L3 past its budget; 0 otherwise."""
    if (summary.get("ledger_diff") or {}).get("failed"):
        return 8
    if (summary.get("incidents") or {}).get("unacked_critical"):
        return 9
    if (summary.get("heartbeat") or {}).get("wedged"):
        return 3
    fleet = summary.get("fleet") or {}
    if fleet.get("broken") or fleet.get("evictions"):
        return 4
    elastic = summary.get("elastic") or {}
    if elastic.get("reforms") or elastic.get("lost_hosts"):
        return 5
    slo = ((summary.get("serve") or {}).get("slo")
           or fleet.get("slo") or {})
    if slo.get("exhausted"):
        return 6
    quality = [(summary.get("serve") or {}).get("quality")]
    quality += [(child.get("serve") or {}).get("quality")
                for child in (summary.get("processes") or {}).values()]
    if any((q or {}).get("exhausted") for q in quality):
        return 7
    if (summary.get("degrade") or {}).get("l3_sustained"):
        return 10
    return 0


def _check_ledger_baseline(args) -> None:
    """A requested ledger gate never passes silently, as in the JAX
    verb: SystemExit when `--ledger-baseline` names no ledger file (or
    run dir holding one), or when the baseline found (that one, or the
    convention file <log-dir>/ledger_baseline.jsonl) holds no rows. A
    baseline cannot become valid later, so even --follow fails it up
    front."""
    from .obs.ledger import find_baseline, load_ledger, resolve_ledger_path

    base = args.ledger_baseline
    if base is not None:
        path = resolve_ledger_path(base)
        if not os.path.isfile(path):
            raise SystemExit(f"tail: --ledger-baseline {base!r} does not "
                             "exist (expected a ledger.jsonl or a run dir "
                             "holding one)")
    else:
        path = find_baseline(args.log_dir)
    if path is not None:
        try:
            rows = load_ledger(path)
        except OSError as e:
            raise SystemExit(f"tail: ledger baseline {path!r} unreadable: "
                             f"{e}")
        if not rows:
            raise SystemExit(f"tail: ledger baseline {path!r} contains no "
                             "ledger rows")


def _tail(args) -> int:
    """The `tail` verb: one `tail_summary` JSON line (a line every
    --interval seconds with --follow, until a nonzero code); the exit
    code of `tail_code`. On rc 8 the verdict is kept as a `ledger_drift`
    incident bundle (one a distinct verdict)."""
    import time

    from .analyze import tail_summary

    bounds = {k: v for k, v in (
        ("compile_factor", args.ledger_compile_factor),
        ("compile_floor_s", args.ledger_compile_floor_s),
        ("memory_factor", args.ledger_memory_factor)) if v is not None}
    _check_ledger_baseline(args)
    while True:
        try:
            summary = tail_summary(args.log_dir, recent=args.recent,
                                   fleet=args.fleet,
                                   ledger_baseline=args.ledger_baseline,
                                   ledger_bounds=bounds)
        except FileNotFoundError:
            raise SystemExit(f"no metrics.jsonl under {args.log_dir!r} — "
                             "is this a run's --log-dir?")
        print(json.dumps(summary), flush=True)
        if (args.ledger_baseline is not None
                and "ledger_diff" not in summary and not args.follow):
            # the explicit gate could not run (the run recorded no
            # ledger): loud, never rc 0; --follow waits for the first row
            raise SystemExit(f"tail: --ledger-baseline given but no verdict "
                             f"could be computed: is {args.ledger_baseline!r}"
                             f" a ledger and does {args.log_dir!r} hold a "
                             "ledger.jsonl (obs.ledger on)?")
        rc = tail_code(summary)
        if rc == 8:
            from .obs import incident

            verdict = summary["ledger_diff"]
            condensed = {cls: sorted(e.get("name", "?")
                                     for e in (verdict.get(cls) or []))
                         for cls in ("fingerprint_drift",
                                     "unexpected_recompiles",
                                     "compile_blowups", "memory_growth")}
            incident.record_offline(
                args.log_dir, "ledger_drift", "critical", trigger=condensed,
                dedup_key=json.dumps(condensed, sort_keys=True))
        if rc or not args.follow:
            return rc
        time.sleep(max(args.interval, 0.1))


def _verify_ckpt(path: str) -> int:
    """The `verify-ckpt` verb: `verify_run`'s report as JSON; 1 when a
    checkpoint is corrupt, 2 (with a note on stderr) when there is
    none."""
    import sys

    from .resilience.verify import verify_run

    report = verify_run(path)
    print(json.dumps(report, indent=2))
    if report["corrupt_steps"]:
        return 1
    if not report["checkpoints"]:
        print(f"verify-ckpt: no checkpoints under {path!r}", file=sys.stderr)
        return 2
    return 0


def _bench(args) -> int:
    """The `bench` verb: one JSON line (`bench.py`)."""
    from . import bench

    if args.data_only or args.recipe:
        res = bench.data_bench(num_workers=args.workers, batch=args.batch,
                               batches=args.batches,
                               image_size=bench.parse_image_size(
                                   args.image_size),
                               dataset=args.dataset,
                               data_path=args.data_path,
                               recipe_path=args.recipe or "")
    else:
        res = bench.bench(model_name=args.model, batch=args.batch,
                          steps=args.steps, device=args.device)
    print(json.dumps(res))
    return 0


def _serve(cfg: ExperimentConfig, args, boot: dict | None = None) -> int:
    """The `serve` verb: offline mode with --input and --out, else the
    fleet (--replicas N > 1 or --autoscale), else the HTTP server, each
    until SIGTERM; `boot` goes to the server's boot split."""
    from .core.config import check_servable

    check_servable(cfg)
    if (args.input is None) != (args.out is None):
        raise SystemExit("serve: offline mode needs both --input and --out "
                         "(neither = the HTTP server)")
    replicas = (args.replicas if args.replicas is not None
                else cfg.serve.fleet.replicas)
    fleet = (replicas is not None and replicas > 1) \
        or cfg.serve.fleet.autoscale
    if args.input is not None:
        if fleet:
            raise SystemExit("serve: --replicas/--autoscale are "
                             "HTTP-fleet only (offline mode already "
                             "parallelizes via serve.workers)")
        from .serve.server import run_offline

        print(json.dumps(run_offline(cfg, args.input, args.out,
                                     write_png=not args.no_png,
                                     device=args.device)))
        return 0
    if fleet:
        # --autoscale is fleet mode even at --replicas 1: the pool needs
        # the supervisor and the router to grow from its floor
        from .serve.fleet import run_fleet

        return run_fleet(cfg, replicas, device=args.device)
    from .serve.server import run_server

    return run_server(cfg, device=args.device, boot=boot)
