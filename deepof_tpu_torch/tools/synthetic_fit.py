"""Learning evidence: train a flow model on the procedural dataset until
its held-out AEE falls below a target (port of the JAX package's
`tools/synthetic_fit.py`).

The quality proxy is `data/datasets.py::SyntheticData`, whose ground
truth is exact: on its pairs the unsupervised objective's minimiser is
the true flow. The tool trains `--model` under the default FlyingChairs
loss (Charbonnier, canonical smoothness, lambda 1, weights
16/8/4/2/1/1; the escalation levers opt-in) with Adam and a step decay,
evaluates with the FlyingChairs protocol (pr1 x 2, clipped, AEE at the
ground truth's resolution, `train/evaluate.py::evaluate_aee`) every
`--eval-every` steps, and appends one JSON record a line to `--out`:

  meta     the settings, the zero-flow EPE of the val split (the AEE a
           model that predicts no motion scores), where a run resumed;
  eval     step, aee, aae, val_loss, lr, wall_s;
  outcome  best_aee and its step, where it stopped and why, wall_s;

the same keys and rounding as the JAX tool, so the two artifacts read
alike. A run stops at the first eval below `--target-epe` or after
`--steps`; the outcome is written on every exit path, SIGTERM included
(exit 143). It checkpoints at every eval into `<out>.ckpt` and resumes
from there when rerun with the same `--out` and the same settings (a
fingerprint of the settings guards the lineage; another fingerprint
starts fresh).

Differences from the JAX tool: `--device` (default "cuda"; "cpu" runs
the plain PyTorch path) in place of `--devices`; `--seed`, the
initialisation's seed (default 0, the JAX tool's fixed seed; a lineage
records it), and `--init-from`, a state_dict to start from instead (say
the JAX package's init, converted by `convert.py`); the default `--out` is `artifacts/synthetic_fit_torch.jsonl`,
so a run never overwrites the JAX tool's artifact; and the draws of the
initialisation are torch's, so a run is compared with the JAX one by
outcome, never step by step (the data are the JAX package's: the same
numpy draws).

Run: python -m deepof_tpu_torch.tools.synthetic_fit [--steps N] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the settings whose change starts a lineage afresh
FP_KEYS = (
    "model", "max_disp", "corr_stride",
    "lr", "lr_decay_every", "feature_scale", "max_shift", "style",
    "blobs", "batch", "photometric", "smoothness_order", "occlusion",
    "lambda_smooth", "width_mult", "curriculum_steps",
    "curriculum_start", "num_train", "seed", "init_from")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m deepof_tpu_torch.tools.synthetic_fit",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (cpu: the plain PyTorch "
                         "path)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-decay-every", type=int, default=1500,
                    help="halve lr every N steps (0 = constant)")
    ap.add_argument("--feature-scale", type=int, default=16)
    ap.add_argument("--max-shift", type=float, default=4.0)
    ap.add_argument("--style", default="blobs",
                    choices=("noise", "blobs", "affine"))
    ap.add_argument("--blobs", type=int, default=8,
                    help="blob count of the blobs/affine canvases")
    ap.add_argument("--target-epe", type=float, default=1.0)
    ap.add_argument("--fresh", action="store_true",
                    help="remove any checkpoint of this --out instead of "
                         "resuming from it")
    ap.add_argument("--width-mult", type=float, default=1.0,
                    help="channel multiplier of the models that take one")
    ap.add_argument("--model", default="flownet_s",
                    choices=("flownet_s", "flownet_c", "inception_v3",
                             "vgg16"))
    ap.add_argument("--max-disp", type=int, default=4,
                    help="flownet_c's correlation radius (feature pixels "
                         "x stride)")
    ap.add_argument("--corr-stride", type=int, default=2,
                    help="flownet_c's displacement stride in feature "
                         "pixels")
    ap.add_argument("--num-train", type=int, default=8192,
                    help="distinct procedural training samples")
    ap.add_argument("--curriculum-start", type=float, default=1.0,
                    help="the TRAIN displacement bound at step 0 of the "
                         "curriculum ramp")
    ap.add_argument("--curriculum-steps", type=int, default=0,
                    help="ramp the TRAIN max_shift from --curriculum-start "
                         "to --max-shift over this many steps (0 = off); "
                         "eval always runs at --max-shift")
    ap.add_argument("--photometric", default="charbonnier",
                    choices=("charbonnier", "census"))
    ap.add_argument("--smoothness-order", type=int, default=1,
                    choices=(1, 2))
    ap.add_argument("--occlusion", action="store_true")
    ap.add_argument("--lambda-smooth", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="the initialisation's seed (0: the JAX tool's)")
    ap.add_argument("--init-from", default="",
                    help="a state_dict file (torch.save) to start a fresh "
                         "lineage from in place of the seeded init, e.g. "
                         "the JAX package's init converted by convert.py")
    ap.add_argument("--out", default=os.path.join(
        REPO, "artifacts", "synthetic_fit_torch.jsonl"))
    return ap


def curriculum_shift(args, s: int) -> float:
    """The TRAIN displacement bound at step s: from --curriculum-start
    to --max-shift, linear over --curriculum-steps (the integer-shift
    styles round it). Eval and the zero-flow baseline use --max-shift."""
    if not args.curriculum_steps:
        return args.max_shift
    frac = min(s / args.curriculum_steps, 1.0)
    start = args.curriculum_start
    return min(start + (args.max_shift - start) * frac, args.max_shift)


def zero_flow_epe(ds) -> float:
    """The mean end-point error of predicting no motion on the val split
    (batches 0 and 1 of 8): the level a collapsed model scores."""
    import numpy as np

    vflows = np.concatenate([ds.sample_val(8, i)["flow"] for i in range(2)])
    return float(np.sqrt((vflows ** 2).sum(-1)).mean())


def _stale_lineage(ap, args, ckpt_dir: str, fingerprint: dict) -> bool:
    """True when `ckpt_dir` holds a lineage trained under other settings
    (or --fresh): a key missing from an old lineage's fingerprint is
    compared at its value of the time, as in the JAX tool."""
    if args.fresh:
        return True
    fp_defaults = {k: ap.get_default(k) for k in FP_KEYS}
    fp_defaults["num_train"] = 64
    fp_defaults["canvas_version"] = 1
    try:
        with open(os.path.join(ckpt_dir, "config_fingerprint.json")) as f:
            loaded = json.load(f)
    except (OSError, ValueError):
        return True
    return {**fp_defaults, **loaded} != fingerprint


def _prior_best(path: str) -> tuple[float, int, bool]:
    """(best aee, its step, whether the file ends mid-line) of an
    artifact being resumed: the outcome reports the whole lineage."""
    best, best_step = float("inf"), 0
    with open(path, "rb") as prev:
        raw = prev.read()
    for line in raw.decode("utf-8", errors="replace").splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # a fragment a killed run left
        if rec.get("kind") == "eval" and rec.get("aee") is not None:
            if rec["aee"] < best:
                best, best_step = rec["aee"], rec["step"]
    return best, best_step, bool(raw) and not raw.endswith(b"\n")


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    # SIGTERM runs the finally path (the outcome record) as SIGINT does
    signal.signal(signal.SIGTERM,
                  lambda *_: (_ for _ in ()).throw(SystemExit(143)))

    import numpy as np
    import torch

    from ..core.config import (DataConfig, ExperimentConfig, LossConfig,
                               OptimConfig, TrainConfig)
    from ..core.device import disable_tf32, resolve_device
    from ..data.datasets import SyntheticData
    from ..models.registry import build_model
    from ..train.checkpoint import CheckpointManager
    from ..train.evaluate import evaluate_aee
    from ..train.state import create_train_state
    from ..train.step import make_eval_fn, make_train_step

    device = resolve_device(args.device)
    disable_tf32()  # float32 means float32 on the card
    h = w = 64
    batch = args.batch
    flownet_c = args.model == "flownet_c"
    cfg = ExperimentConfig(
        name="synthetic_fit",
        model=args.model,
        width_mult=args.width_mult,
        corr_max_disp=args.max_disp if flownet_c else 20,
        corr_stride=args.corr_stride if flownet_c else 2,
        loss=LossConfig(weights=(16, 8, 4, 2, 1, 1),
                        photometric=args.photometric,
                        smoothness_order=args.smoothness_order,
                        occlusion=args.occlusion,
                        lambda_smooth=args.lambda_smooth),
        optim=OptimConfig(learning_rate=args.lr),
        data=DataConfig(dataset="synthetic", image_size=(h, w),
                        gt_size=(h, w), batch_size=batch),
        train=TrainConfig(seed=0, eval_amplifier=2.0, eval_clip=(-300, 250),
                          eval_batch_size=8,
                          log_dir=os.path.dirname(args.out) or "."),
    )
    ds = SyntheticData(cfg.data, num_train=args.num_train,
                       feature_scale=args.feature_scale,
                       max_shift=args.max_shift, style=args.style,
                       n_blobs=args.blobs)
    model = build_model(args.model, width_mult=args.width_mult,
                        corr_max_disp=cfg.corr_max_disp,
                        corr_stride=cfg.corr_stride, seed=args.seed,
                        device=device)

    def schedule(s):
        if not args.lr_decay_every:
            return args.lr
        return args.lr * 0.5 ** (s // args.lr_decay_every)

    if args.init_from:
        model.load_state_dict(torch.load(args.init_from, map_location=device,
                                         weights_only=True))
    state = create_train_state(model, cfg.optim, schedule)
    ckpt_dir = args.out + ".ckpt"
    fingerprint = {k: getattr(args, k) for k in FP_KEYS}
    fingerprint["canvas_version"] = SyntheticData.CANVAS_VERSION
    if os.path.isdir(ckpt_dir) and _stale_lineage(ap, args, ckpt_dir,
                                                  fingerprint):
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = CheckpointManager(ckpt_dir, keep=1)
    start_step = 0
    if ckpt.restore(state) is not None:
        start_step = state.step
    with open(os.path.join(ckpt_dir, "config_fingerprint.json"), "w") as f:
        json.dump(fingerprint, f)
    step = make_train_step(model, cfg, ds.mean)
    eval_fn = make_eval_fn(cfg, ds.mean)
    zero_epe = zero_flow_epe(ds)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    t0 = time.time()
    prior_best, prior_best_step, needs_newline = float("inf"), 0, False
    if start_step and os.path.exists(args.out):
        prior_best, prior_best_step, needs_newline = _prior_best(args.out)
    step_ms: list[float] = []  # the mean step of each eval interval
    interval = {"s": 0.0, "n": 0}
    with open(args.out, "a" if start_step else "w") as f:
        if needs_newline:
            f.write("\n")
        f.write(json.dumps({
            "kind": "meta", "model": cfg.model, "dataset": "synthetic",
            "resumed_from": start_step,
            "image_size": [h, w], "batch": batch, "lr": args.lr,
            "lr_decay_every": args.lr_decay_every,
            "feature_scale": args.feature_scale,
            "max_shift": args.max_shift,
            "style": args.style,
            "blobs": args.blobs,
            "width_mult": args.width_mult,
            "curriculum_steps": args.curriculum_steps,
            "curriculum_start": args.curriculum_start,
            "num_train": args.num_train,
            "zero_flow_epe": round(zero_epe, 4),
            "loss": (f"{args.photometric}, canonical order="
                     f"{args.smoothness_order}, lambda="
                     f"{args.lambda_smooth}, occlusion={args.occlusion}, "
                     "weights 16/8/4/2/1/1"),
            "eval": "pr1 x2, AEE at GT res, held-out synthetic val",
        }) + "\n")
        # seeded by the start step: a resume draws a fresh data stream
        rng = np.random.RandomState(start_step)
        best_aee, best_step = prior_best, prior_best_step
        done = {"written": False}

        def outcome(stopped_at: int, note: str) -> None:
            done["written"] = True
            f.write(json.dumps({
                "kind": "outcome",
                "best_aee": round(best_aee, 4) if np.isfinite(best_aee)
                else None,
                "best_step": best_step, "stopped_at_step": stopped_at,
                "zero_flow_epe": round(zero_epe, 4), "note": note,
                "wall_s": round(time.time() - t0, 1)}) + "\n")
            f.flush()
            if step_ms:
                # the step as the loop paid it (the draw, the copy and
                # the step), evals and saves excluded: the median over
                # the eval intervals of their mean step; stdout only
                print(json.dumps({"step_ms_median": round(
                    statistics.median(step_ms), 3),
                    "intervals": len(step_ms)}), flush=True)

        s = start_step
        completed = False
        try:
            for s in range(start_step, args.steps + 1):
                if s % args.eval_every == 0:
                    res = evaluate_aee(eval_fn, model, ds, cfg)
                    rec = {"kind": "eval", "step": s,
                           "aee": round(res["aee"], 4),
                           "aae": round(res["aae"], 4),
                           "val_loss": round(res["val_loss"], 4),
                           "lr": schedule(s),
                           "wall_s": round(time.time() - t0, 1)}
                    if res["aee"] < best_aee:
                        best_aee, best_step = res["aee"], s
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    print(rec, flush=True)
                    if res["aee"] < args.target_epe:
                        print(f"target EPE {args.target_epe} reached at "
                              f"step {s}", flush=True)
                        outcome(s, f"target {args.target_epe} px reached")
                        # the lineage is complete: a rerun starts fresh
                        shutil.rmtree(ckpt_dir, ignore_errors=True)
                        return 0
                    if s > start_step:  # the resume point of a killed run
                        ckpt.save(state)
                    if interval["n"]:
                        step_ms.append(interval["s"] / interval["n"] * 1e3)
                    interval.update(s=0.0, n=0)
                if s == args.steps:
                    break  # the JAX loop trains one more step, unseen
                t1 = time.perf_counter()
                step(state, ds.sample_train(
                    batch, rng=rng, max_shift=curriculum_shift(args, s)))
                if (s + 1) % args.eval_every == 0 and device.type == "cuda":
                    torch.cuda.synchronize(device)  # the interval's end
                interval["s"] += time.perf_counter() - t1
                interval["n"] += 1
            completed = True
        finally:
            if not done["written"]:
                note = ("step budget exhausted before target" if completed
                        else f"interrupted at step {s}")
                outcome(s, note)
    print("step budget exhausted before target EPE", flush=True)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
