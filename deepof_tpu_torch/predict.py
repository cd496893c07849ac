"""Inference over image pairs through the serving engine, writing `.flo`
files and their flow-colour PNGs (port of `restore_params`,
`write_outputs` and `predict_pairs` in `deepof_tpu/predict.py`).

The parameters come from the newest checkpoint of a run that verifies
(`restore_params`). Pairs are decoded BGR arrays or image paths (PNG,
JPEG, PPM, or `.npy` arrays), decoded by the engine.
"""

from __future__ import annotations

import os
from collections import deque

import torch
from torch import nn

from .core.config import ExperimentConfig
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
    from .train.checkpoint import CheckpointManager
    from .train.schedule import step_decay_schedule
    from .train.state import create_train_state

    model = build_serve_model(cfg, device)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    ckpt_dir = os.path.join(cfg.train.log_dir, "ckpt")
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
