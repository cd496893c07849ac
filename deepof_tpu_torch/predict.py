"""Inference over image pairs through the serving engine, writing `.flo`
files and their flow-colour PNGs, and the classification of frame pairs
by an action model (port of `restore_params`, `restore_action_params`,
`write_outputs`, `predict_pairs` and `predict_action` in
`deepof_tpu/predict.py`).

The parameters come from the newest checkpoint of a run that verifies
(`restore_params`). Pairs are decoded BGR arrays or image paths (PNG,
JPEG, PPM, or `.npy` arrays), decoded by the engine; `predict_action`
reads paths (the same formats) itself.
"""

from __future__ import annotations

import json
import os
from collections import deque

import numpy as np
import torch
from torch import nn

from .core.config import ACTION_MODELS, ExperimentConfig
from .io import png
from .io.flo import write_flo
from .serve.engine import InferenceEngine, build_serve_model
from .utils.flowviz import flow_to_color


def restore_params(cfg: ExperimentConfig,
                   device: str | torch.device = "cuda") -> nn.Module:
    """The serving model of `cfg` with the parameters of the newest
    checkpoint under `<train.log_dir>/ckpt` that verifies and loads (a
    candidate that fails warns, and the next older one is tried). Raises
    RuntimeError when checkpoints exist but none restores, and
    FileNotFoundError when there is none."""
    return _restore_verified(cfg, build_serve_model(cfg, device))


def restore_action_params(cfg: ExperimentConfig,
                          ckpt_dir: str | None = None,
                          device: str | torch.device = "cuda") -> nn.Module:
    """The full training model of an action config (st_single,
    st_baseline or ucf101_spatial; ValueError otherwise), built as the
    Trainer builds it, with the parameters of the newest checkpoint that
    verifies under `ckpt_dir` (default `<train.log_dir>/ckpt`), as
    `restore_params` restores them."""
    from .models.registry import build_model
    from .train.step import compute_dtype

    if cfg.model not in ACTION_MODELS:
        raise ValueError(
            f"model {cfg.model!r} has no action head: the action predict "
            f"path needs one of {list(ACTION_MODELS)}")
    model = build_model(
        cfg.model, flow_channels=2 * (cfg.data.time_step - 1),
        width_mult=cfg.width_mult, corr_max_disp=cfg.corr_max_disp,
        corr_stride=cfg.corr_stride, seed=cfg.train.seed, device=device,
        dtype=compute_dtype(cfg),
        image_size=cfg.data.crop_size or cfg.data.image_size)
    return _restore_verified(cfg, model, ckpt_dir)


def _restore_verified(cfg: ExperimentConfig, model: nn.Module,
                      ckpt_dir: str | None = None) -> nn.Module:
    """`model` with the parameters of the newest checkpoint under
    `ckpt_dir` (default `<train.log_dir>/ckpt`) that verifies and
    loads."""
    from .train.checkpoint import CheckpointManager
    from .train.schedule import step_decay_schedule
    from .train.state import create_train_state

    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    ckpt_dir = ckpt_dir or os.path.join(cfg.train.log_dir, "ckpt")
    mgr = CheckpointManager(ckpt_dir, create=False,
                            verify=cfg.resilience.verify_checkpoints)
    if mgr.restore(state) is None:
        candidates = mgr.all_steps()
        if candidates:
            raise RuntimeError(
                f"checkpoints exist under {ckpt_dir} (steps {candidates}) "
                "but none restored: all candidates failed verification or "
                "the read itself")
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return model


def write_outputs(out_dir: str, stem: str, flow, write_png: bool = True
                  ) -> list[str]:
    """Write one native-resolution flow as `<stem>_flow.flo` and, unless
    `write_png` is False, its flow colours as `<stem>_flow.png`;
    returns the written paths."""
    written = [os.path.join(out_dir, f"{stem}_flow.flo")]
    write_flo(written[0], flow)
    if write_png:
        written.append(os.path.join(out_dir, f"{stem}_flow.png"))
        png.write_png(written[1], flow_to_color(flow))
    return written


def output_stem(src, idx: int, many: bool) -> str:
    if not isinstance(src, (str, os.PathLike)):
        return f"{idx:04d}"
    stem = os.path.splitext(os.path.basename(src))[0]
    # basenames may collide across dirs once there is more than one pair
    return f"{idx:04d}_{stem}" if many else stem


def predict_pairs(cfg: ExperimentConfig, pairs: list[tuple], out_dir: str,
                  mean=None, model: nn.Module | None = None,
                  device: str | torch.device = "cuda",
                  precision: str | None = None,
                  write_png: bool = True) -> list[str]:
    """Predict native-resolution flow for (prev, next) pairs and write
    `<stem>_flow.flo` and, with `write_png`, `<stem>_flow.png` per pair;
    returns the written paths in pair order.

    The pairs go through the micro-batching engine, so they execute in
    batches of up to `serve.max_batch`. model: optional nn.Module with
    its weights; None builds `cfg.model` from `cfg.train.seed`.
    precision: the serving tier of every pair, one of
    `serve.precisions` (None: its first)."""
    os.makedirs(out_dir, exist_ok=True)
    written: list[str] = []
    many = len(pairs) > 1
    with InferenceEngine(cfg, model=model, mean=mean, device=device) as eng:
        # bounded outstanding-futures window: a resolved future holds a
        # native-resolution flow, so write while submitting
        window = max(4 * eng.max_batch, 16)
        buf: deque = deque()

        def drain_one() -> None:
            idx, src, fut = buf.popleft()
            written.extend(write_outputs(out_dir,
                                         output_stem(src, idx, many),
                                         fut.result()["flow"], write_png))

        for idx, (src, tgt) in enumerate(pairs):
            buf.append((idx, src, eng.submit(src, tgt, precision)))
            if len(buf) >= window:
                drain_one()
        while buf:
            drain_one()
    return written


def _read_image(path: str) -> np.ndarray:
    """A `.npy` BGR array or a PNG, JPEG or PPM file -> (H, W, 3) BGR."""
    from .data.datasets import _imread_bgr

    if not os.path.exists(path):
        raise FileNotFoundError(f"cannot read image {path!r}")
    return (np.load(path, allow_pickle=False) if path.endswith(".npy")
            else _imread_bgr(path))


def predict_action(cfg: ExperimentConfig, pairs: list[tuple[str, str]],
                   out_dir: str, model: nn.Module | None = None,
                   labels: list[str] | None = None, top_k: int = 5,
                   ckpt_dir: str | None = None,
                   device: str | torch.device = "cuda") -> list[dict]:
    """Classify (prev, next) frame pairs with a trained action model
    (st_single, st_baseline, or ucf101_spatial, which reads the prev
    frame only). Each pair becomes one network input at
    `data.image_size` through the trainer's preprocess
    (`serve/buckets.py::prepare_pair`, or `prepare_frame` for the
    classifier); the softmax of the logits, in float32, gives the top_k
    classes. Returns the rows, one a pair, and writes them to
    `<out_dir>/actions.json` in the JAX package's layout.

    model: a restored action model (None: `restore_action_params` from
    `ckpt_dir`). labels: class names in index order, attached to the
    classes they name."""
    from .data.datasets import DATASET_MEANS
    from .serve.buckets import prepare_frame, prepare_pair

    if model is None:
        model = restore_action_params(cfg, ckpt_dir, device)
    dev = next(model.parameters()).device
    mean = DATASET_MEANS.get(cfg.data.dataset, DATASET_MEANS["flyingchairs"])
    hw = tuple(cfg.data.image_size)
    spatial_only = getattr(model, "classifier_only", False)
    model.eval()
    rows: list[dict] = []
    for src_path, tgt_path in pairs:
        src, tgt = _read_image(src_path), _read_image(tgt_path)
        x = (prepare_frame(src, hw, mean) if spatial_only
             else prepare_pair(src, tgt, hw, mean))
        x = torch.from_numpy(x).permute(2, 0, 1)[None].to(dev)
        with torch.no_grad():
            out = model(x)
            logits = out if spatial_only else out[1]
            probs = torch.softmax(logits.float(), -1)[0].cpu().numpy()
        order = np.argsort(probs)[::-1][:max(top_k, 1)]
        top = [{"class": int(i),
                **({"label": labels[i]} if labels and i < len(labels)
                   else {}),
                "prob": round(float(probs[i]), 6)} for i in order]
        rows.append({"source": src_path, "target": tgt_path,
                     **{k: top[0][k] for k in ("class", "label", "prob")
                        if k in top[0]},
                     "top": top})
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "actions.json"), "w") as f:
        json.dump(rows, f, indent=2)
    return rows
