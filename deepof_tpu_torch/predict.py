"""Inference over image pairs through the serving engine, writing `.flo`
files (port of `predict_pairs` in `deepof_tpu/predict.py`).

This package has no image decoder and no PNG writer: pairs are decoded
BGR arrays or `.npy` paths, and the output is the Middlebury `.flo` only.
"""

from __future__ import annotations

import os
from collections import deque

import torch
from torch import nn

from .core.config import ExperimentConfig
from .io.flo import write_flo
from .serve.engine import InferenceEngine


def output_stem(src, idx: int, many: bool) -> str:
    if not isinstance(src, (str, os.PathLike)):
        return f"{idx:04d}"
    stem = os.path.splitext(os.path.basename(src))[0]
    # basenames may collide across dirs once there is more than one pair
    return f"{idx:04d}_{stem}" if many else stem


def predict_pairs(cfg: ExperimentConfig, pairs: list[tuple], out_dir: str,
                  mean=None, model: nn.Module | None = None,
                  device: str | torch.device = "cuda") -> list[str]:
    """Predict native-resolution flow for (prev, next) pairs and write one
    `<stem>_flow.flo` per pair; returns the written paths in pair order.

    The pairs go through the micro-batching engine, so they execute in
    batches of up to `serve.max_batch`. model: optional nn.Module with
    its weights; None builds `cfg.model` from `cfg.train.seed`."""
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
            path = os.path.join(out_dir,
                                f"{output_stem(src, idx, many)}_flow.flo")
            write_flo(path, fut.result()["flow"])
            written.append(path)

        for idx, (src, tgt) in enumerate(pairs):
            buf.append((idx, src, eng.submit(src, tgt)))
            if len(buf) >= window:
                drain_one()
        while buf:
            drain_one()
    return written
