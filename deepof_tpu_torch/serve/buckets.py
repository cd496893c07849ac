"""Shape bucketing (port of `deepof_tpu/serve/buckets.py`).

Every request maps to one of a few (H, W) network-input buckets. The
native image is resized to the bucket, the net runs at the bucket shape,
and the finest flow is amplified/clipped/resized back to native
resolution with its u/v vectors rescaled by (W_native/W_bucket,
H_native/H_bucket) into native pixel units.

Bucket choice: the smallest-area bucket that covers the native
resolution in both dimensions, else the largest bucket.
"""

from __future__ import annotations

import numpy as np

from ..core.config import ExperimentConfig
from ..data.datasets import _resize
from ..train.evaluate import postprocess_flow


def resolve_buckets(cfg: ExperimentConfig) -> tuple[tuple[int, int], ...]:
    """Explicit `serve.buckets` (deduplicated, sorted by area then H), or
    the single `data.image_size` bucket."""
    raw = cfg.serve.buckets or (tuple(cfg.data.image_size),)
    buckets = []
    for b in raw:
        h, w = int(b[0]), int(b[1])
        if h <= 0 or w <= 0:
            raise ValueError(f"serve.buckets entry {b!r} must be positive (H, W)")
        buckets.append((h, w))
    return tuple(sorted(set(buckets), key=lambda b: (b[0] * b[1], b[0])))


def pick_bucket(native_hw: tuple[int, int],
                buckets: tuple[tuple[int, int], ...]) -> tuple[int, int]:
    """Smallest-area bucket covering `native_hw` in both axes, else the
    largest bucket in the ladder."""
    h, w = native_hw
    for bh, bw in buckets:
        if bh >= h and bw >= w:
            return (bh, bw)
    return buckets[-1]


def next_smaller_bucket(bucket: tuple[int, int],
                        buckets: tuple[tuple[int, int], ...]
                        ) -> tuple[int, int]:
    """One rung down the ladder from `bucket` (the brownout fold at
    level 2): the next-smaller-area bucket, or `bucket` itself when it
    is the smallest or not on the ladder. Any bucket serves any native
    size (the flow is rescaled to native pixels), so only accuracy
    drops."""
    bucket = tuple(bucket)
    if bucket not in buckets:
        return bucket
    idx = buckets.index(bucket)
    return buckets[idx - 1] if idx > 0 else bucket


def prepare_frame(img_raw: np.ndarray, bucket: tuple[int, int],
                  mean) -> np.ndarray:
    """One decoded BGR frame -> (H, W, 3) float32 at the bucket
    resolution: resize, subtract the BGR mean, divide by 255."""
    m = np.asarray(mean, np.float32)
    return ((_resize(img_raw, bucket).astype(np.float32) - m)
            / np.float32(255.0))


def prepare_pair(src_raw: np.ndarray, tgt_raw: np.ndarray,
                 bucket: tuple[int, int], mean) -> np.ndarray:
    """Decoded BGR pair -> one network-input row (H, W, 6) float32."""
    return np.concatenate([prepare_frame(img, bucket, mean)
                           for img in (src_raw, tgt_raw)], axis=-1)


def flow_to_native(flow: np.ndarray, cfg: ExperimentConfig,
                   bucket: tuple[int, int],
                   native_hw: tuple[int, int]) -> np.ndarray:
    """Finest scaled flow (H_b, W_b, 2) at bucket resolution -> native-
    resolution flow in native pixel units."""
    bh, bw = bucket
    out = postprocess_flow(flow[None].astype(np.float32, copy=False),
                           cfg, native_hw)[0, :, :, :2]
    out[..., 0] *= native_hw[1] / bw  # u: native horizontal px
    out[..., 1] *= native_hw[0] / bh  # v: native vertical px
    return out
