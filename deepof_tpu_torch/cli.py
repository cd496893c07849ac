"""Command-line entry point (port of the `train`, `eval`, `predict`,
`serve`, `config`, `bench`, `verify-ckpt` and `incidents` verbs of
`deepof_tpu/cli.py`).

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
    python -m deepof_tpu_torch verify-ckpt /runs/fc1
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
`--ckpt-dir DIR` (the checkpoint directory, default `<log-dir>/ckpt`),
and for `serve` `--input` (offline mode: the
consecutive pairs of a directory of frames, written to `--out`; without
it, the HTTP server of `serve/server.py` on serve.host:serve.port),
`--session-ttl` and `--session-max` (`serve.session.ttl_s` and
`max_sessions`), `--replicas N` (N > 1: the fleet of `serve/fleet.py`,
N replica processes behind a router), `--autoscale` (the fleet sized by
`serve/autoscale.py` between `--min-replicas` and `--max-replicas`;
fleet mode even at one replica). `bench` takes the JAX verb's flags
(`--model`, `--batch`, `--steps`, `--data-only`, `--workers`,
`--batches`, `--image-size`, `--dataset`, `--data-path`) and
`--device`; `verify-ckpt DIR` prints the run's checkpoint report and
exits 1 on a corrupt checkpoint, 2 when there is none. `incidents
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
nothing falls back to the CPU. The JAX package's other flags raise,
naming the ROADMAP item that ports them.

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

from .core.config import (PRESETS, ExperimentConfig, config_from_dict,
                          get_config, raise_unported)

#: The JAX package's flags this package does not take yet -> the ROADMAP
#: Queue A item that ports them.
_UNPORTED_FLAGS = {
    "--recipe": "9 (recipes)",
    "--elastic": "10 (elastic training)",
    "--multihost": "10 (parallelism)",
    "--artifacts": "8 (artifacts)",
}


def _add_unported(p: argparse.ArgumentParser, flag: str,
                  takes_value: bool = False) -> None:
    kw = {} if takes_value else {"action": "store_true"}
    p.add_argument(flag, default=None, **kw,
                   help=f"not ported (ROADMAP Queue A item "
                        f"{_UNPORTED_FLAGS[flag]})")


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
    # the serve sugar flags, before --set so an explicit --set wins
    for flag, dotted in (("session_ttl", "serve.session.ttl_s"),
                         ("session_max", "serve.session.max_sessions"),
                         ("min_replicas", "serve.fleet.min_replicas"),
                         ("max_replicas", "serve.fleet.max_replicas")):
        value = getattr(args, flag, None)
        if value is not None:
            cfg = _apply_override(cfg, dotted, repr(value))
    if getattr(args, "autoscale", False):
        cfg = _apply_override(cfg, "serve.fleet.autoscale", "true")
    for item in args.set or []:
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
    _add_unported(p, "--multihost")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="deepof_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_train = sub.add_parser("train", help="train a model")
    _add_common(p_train)
    p_train.add_argument("--epochs", type=int, default=None)
    p_train.add_argument("--max-steps", "--steps", dest="max_steps",
                         type=int, default=None)
    for flag in ("--recipe", "--elastic"):
        _add_unported(p_train, flag, takes_value=True)
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
    _add_unported(p_srv, "--artifacts", takes_value=True)
    p_srv.add_argument("--config-json", default=None,
                       help=argparse.SUPPRESS)  # a fleet replica's config

    p_cfg = sub.add_parser("config", help="print the resolved config")
    _add_common(p_cfg)

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
                         help="not ported (ROADMAP Queue A item 9.5)")
    p_bench.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                         help="train mode: where the step runs (default "
                              "cuda, which raises without a card)")

    p_vck = sub.add_parser(
        "verify-ckpt",
        help="check every checkpoint of a run against its manifest "
             "(nonzero exit on corruption)")
    p_vck.add_argument("dir",
                       help="a run's --log-dir or its ckpt/ subdirectory")

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
    if args.cmd == "incidents":
        return _incidents(args)
    from .core.device import disable_tf32

    disable_tf32()
    if args.cmd == "verify-ckpt":
        return _verify_ckpt(args.dir)
    if args.cmd == "bench":
        return _bench(args)
    raise_unported([(flag, item) for flag, item in _UNPORTED_FLAGS.items()
                     if getattr(args, flag[2:].replace("-", "_"), None)])
    cfg = _build_cfg(args)
    if getattr(args, "trace", False):
        cfg = cfg.replace(obs=dataclasses.replace(cfg.obs, trace=True))
    if args.cmd == "config":
        print(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
        return 0

    if args.cmd == "serve":
        return _serve(cfg, args)

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
    trainer = Trainer(cfg, device=args.device,
                      profile=getattr(args, "profile", False),
                      profile_steps=profile_steps)
    if args.cmd == "train":
        out = trainer.fit(num_epochs=args.epochs, max_steps=args.max_steps)
    else:  # eval
        out = trainer.evaluate(dump=args.dump_visuals)
    print(json.dumps({k: float(v) for k, v in out.items()}))
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


def _serve(cfg: ExperimentConfig, args) -> int:
    """The `serve` verb: offline mode with --input and --out, else the
    fleet (--replicas N > 1 or --autoscale), else the HTTP server, each
    until SIGTERM."""
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

    return run_server(cfg, device=args.device)
