"""Evaluation protocols (port of `deepof_tpu/train/evaluate.py`): the
AEE protocol with its visual dumps, and the UCF-101 action accuracy
(`evaluate_ucf101`).

The finest prediction (already multiplied by its flow scale) is
multiplied by `train.eval_amplifier`, clipped to `train.eval_clip` and
bilinearly resized to the native resolution, then compared with the
ground truth by mean endpoint and angular error. The resize is
PyTorch's bilinear interpolation (half-pixel centres, no antialiasing),
which samples as cv2's INTER_LINEAR does. A T-frame volume's flows are
scored pair by pair, over all T-1 pairs, at the native size.

`dump_visuals` writes what the JAX package writes with cv2.imwrite, under
the same names: flow colours (`utils/flowviz.py`), the reconstruction and
the ground truth's colours, as PNGs (`io/png.py`).

Over a world of ranks (`parallel/mesh.py`) every rank loads the same
full val batch, evaluates its own rows, and `gathered_eval_fn` gathers
the outputs in rank order, so both protocols see the whole batch on
every rank, as the JAX loop's allgathered eval does.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import ExperimentConfig
from ..io.png import write_png
from ..parallel.mesh import (World, gather_rows, local_rows_of,
                             mean_over_ranks)
from ..utils.flowviz import flow_to_color
from ..utils.metrics import flow_aae, flow_epe


def postprocess_flow(flow: np.ndarray, cfg: ExperimentConfig,
                     gt_hw: tuple[int, int]) -> np.ndarray:
    """(B, h, w, 2k) net output -> amplified/clipped/native-res flow."""
    lo, hi = cfg.train.eval_clip
    flow = np.clip(flow * cfg.train.eval_amplifier, lo, hi)
    if flow.shape[1:3] == tuple(gt_hw):
        return flow
    t = torch.from_numpy(np.ascontiguousarray(flow, np.float32))
    out = F.interpolate(t.permute(0, 3, 1, 2), size=tuple(gt_hw),
                        mode="bilinear", align_corners=False, antialias=False)
    return out.permute(0, 2, 3, 1).contiguous().numpy()


def dump_visuals(out_dir: str, tag: str, flow: np.ndarray,
                 recon: np.ndarray | None = None,
                 gt: np.ndarray | None = None,
                 max_samples: int = 8) -> None:
    """Write `<tag>_s<i>_flow.png` (the first pair's flow colours),
    `_gt.png` and `_recon.png` (the first reconstructed frame, x255,
    clipped) for up to `max_samples` samples. The colour images hold
    `flow_to_color`'s RGB where cv2.imwrite would read BGR, as the JAX
    package's files do."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(min(flow.shape[0], max_samples)):
        write_png(os.path.join(out_dir, f"{tag}_s{i}_flow.png"),
                  flow_to_color(flow[i, :, :, :2]))
        if gt is not None:
            write_png(os.path.join(out_dir, f"{tag}_s{i}_gt.png"),
                      flow_to_color(gt[i, :, :, :2]))
        if recon is not None:
            img = np.clip(recon[i, :, :, :3] * 255.0, 0, 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"{tag}_s{i}_recon.png"), img)


def gathered_eval_fn(eval_fn, world: World):
    """`eval_fn` over a world of ranks: each rank evaluates its rows of
    the full batch it is given, and the outputs (flow, recon, logits) are
    gathered in rank order and the objective averaged over the ranks
    (equal rows a rank, so the mean of the means is the batch's mean).
    `eval_fn` itself on a world of one."""
    if not world.distributed:
        return eval_fn

    def run(model, batch: dict) -> dict:
        out = eval_fn(model, local_rows_of(batch, world))
        return {k: (mean_over_ranks(v, world) if k == "total"
                    else gather_rows(np.asarray(v), world))
                for k, v in out.items()}

    return run


def _wmean(pairs: list[tuple[float, int]]) -> float:
    """Row-weighted mean of per-batch (value, valid_rows) pairs."""
    vals, ws = zip(*pairs)
    return float(np.average(vals, weights=ws))


def evaluate_aee(eval_fn, model, dataset, cfg: ExperimentConfig,
                 dump_dir: str | None = None) -> dict[str, float]:
    """The AEE protocol over the full validation split, each val sample
    counted once for any `train.eval_batch_size`.

    Batches are ceil-divided; the final, short one (v unseen rows) is
    evaluated by tiling its rows cyclically across L = v / gcd(v, bs)
    full-shape calls, so every row appears exactly bs / gcd times and
    the mean of the L batch-mean losses is the uniform mean over the v
    rows: `val_loss` is exact for any batch size (the loss is
    row-separable). `eval_fn(model, batch)` only ever sees the full
    batch shape. With `dump_dir`, the first batch's visuals are written
    there (`dump_visuals`, tag "val0")."""
    bs = cfg.train.eval_batch_size
    n_val = max(dataset.num_val, 1)
    epes, aaes, totals = [], [], []
    # running aggregates: the val split at native resolution is large
    p_sum = g_sum = 0.0
    p_n = g_n = 0
    p_max = g_max = 0.0
    for bid in range(-(-n_val // bs)):
        batch = dataset.sample_val(bs, bid)
        valid = min(bs, n_val - bid * bs)
        if valid < bs:
            # replace sample_val's wrap-to-head padding (rows of other
            # batches) with the cyclic self-tiling of the docstring
            vrows = {k: np.asarray(v)[:valid] for k, v in batch.items()}
            tile_totals = []
            out = None
            for j in range(valid // math.gcd(valid, bs)):
                idx = np.arange(j * bs, (j + 1) * bs) % valid
                o = eval_fn(model, {k: v[idx] for k, v in vrows.items()})
                if j == 0:
                    out = o  # rows 0..valid-1 are the unseen rows in order
                tile_totals.append(o["total"])
            batch_total = float(np.mean(tile_totals))
        else:
            out = eval_fn(model, batch)
            batch_total = out["total"]
        gt = batch["flow"][:valid]
        pred = postprocess_flow(out["flow"][:valid], cfg, gt.shape[1:3])
        # AEE per flow pair, row-weighted so a short final batch counts
        # per sample
        for p in range(0, gt.shape[-1], 2):
            epes.append((float(flow_epe(pred[..., p:p + 2],
                                        gt[..., p:p + 2])), valid))
            aaes.append((float(flow_aae(pred[..., p:p + 2],
                                        gt[..., p:p + 2])), valid))
        totals.append((batch_total, valid))
        pa, ga = np.abs(pred), np.abs(gt)
        p_sum += float(pa.sum())
        p_n += pa.size
        p_max = max(p_max, float(pa.max()))
        g_sum += float(ga.sum())
        g_n += ga.size
        g_max = max(g_max, float(ga.max()))
        if dump_dir and bid == 0:
            dump_visuals(dump_dir, f"val{bid}", pred, out.get("recon"), gt)

    # flow-statistics report
    return {
        "aee": _wmean(epes),
        "aae": _wmean(aaes),
        "val_loss": _wmean(totals),
        "pred_abs_mean": p_sum / max(p_n, 1),
        "pred_abs_max": p_max,
        "gt_abs_mean": g_sum / max(g_n, 1),
        "gt_abs_max": g_max,
    }


def evaluate_ucf101(eval_fn, model, dataset, cfg: ExperimentConfig,
                    n_classes: int = 101) -> dict[str, float]:
    """Action accuracy over one val batch a class, min(n_classes, val
    classes) batches (`dataset.sample_val` gives batch i the i-th
    class); a dataset without classes (synthetic) covers its val split
    once, its last batch's wrapped rows unscored. `val_loss` is the
    batches' objective weighted by their scored rows."""
    bs = cfg.train.eval_batch_size
    correct, seen, totals = 0, 0, []
    per_class = hasattr(dataset, "val_clips")
    if per_class:
        n = min(n_classes, max(len(dataset.val_clips), 1))
    else:
        n = -(-max(dataset.num_val, 1) // bs)
    for bid in range(n):
        batch = dataset.sample_val(bs, bid)
        valid = bs if per_class else min(bs, dataset.num_val - bid * bs)
        out = eval_fn(model, batch)
        logits = np.asarray(out["logits"])[:valid]
        correct += int(np.sum(np.argmax(logits, -1)
                              == np.asarray(batch["label"])[:valid]))
        seen += logits.shape[0]
        totals.append((float(out["total"]), valid))
    return {"accuracy": correct / max(seen, 1), "val_loss": _wmean(totals)}
