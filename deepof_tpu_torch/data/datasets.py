"""Dataset constants, the host-side resize, the FlyingChairs loader and
the procedural dataset (subset of `deepof_tpu/data/datasets.py`).

The JAX package resizes with cv2's INTER_LINEAR. This package has no
cv2: `_resize` is PyTorch's bilinear interpolation with half-pixel
centres and no antialiasing, which is the same sampling rule. It returns
float32 where cv2 rounds a uint8 image back to uint8, so the two differ
by at most a grey level. `SyntheticData`'s "noise" canvas upsamples with
PyTorch's bicubic filter in place of cv2's INTER_CUBIC (the same
a = -0.75 kernel with half-pixel centres; they agree to ~1e-4 grey
levels).

FlyingChairs frames are binary PPMs, read in numpy (`io/ppm.py`, BGR as
cv2.imread gives them); flows are `.flo` files (`io/flo.py`). Still to
port (ROADMAP Queue A item 5): the Sintel and UCF-101 loaders, which
need a PNG/JPEG decoder; `build_dataset` raises for them.
"""

from __future__ import annotations

import collections
import os
import re
import threading

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import DataConfig
from ..io.flo import read_flo
from ..io.ppm import read_ppm_bgr

FLYINGCHAIRS_MEAN = (97.533, 99.238, 97.056)  # BGR
SINTEL_MEAN = (70.1433, 83.1915, 92.8827)
UCF101_MEAN = (104.0, 117.0, 123.0)

DATASET_MEANS = {
    "flyingchairs": FLYINGCHAIRS_MEAN,
    "sintel": SINTEL_MEAN,
    "ucf101": UCF101_MEAN,
    "synthetic": (0.0, 0.0, 0.0),
}


def _resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) array -> (hw[0], hw[1], C) float32, bilinear.

    An image already at `hw` is returned as it is (dtype unchanged)."""
    if img.shape[:2] == tuple(hw):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t.permute(2, 0, 1)[None]
    out = F.interpolate(t, size=tuple(hw), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


def _bicubic(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) float32 -> (hw[0], hw[1], C) float32, bicubic with
    half-pixel centres (cv2.INTER_CUBIC's rule)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    out = F.interpolate(t.permute(2, 0, 1)[None], size=tuple(hw),
                        mode="bicubic", align_corners=False)
    return out[0].permute(1, 2, 0).contiguous().numpy()


class _DecodedCache:
    """Byte-bounded LRU of decoded native-resolution images.

    Thread-safe: the input pipeline's workers share one cache. Misses
    decode outside the lock, so workers never serialize on a decode; two
    threads missing the same path decode it twice (the same result, the
    last insert wins, the bytes counted once)."""

    def __init__(self, enabled: bool, reader, max_bytes: int = 4 << 30):
        self._enabled = enabled
        self._reader = reader
        self._max_bytes = max_bytes
        self._bytes = 0
        self._store: collections.OrderedDict[str, np.ndarray] = (
            collections.OrderedDict())
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def __call__(self, path: str) -> np.ndarray:
        if not self._enabled:
            return self._reader(path)
        with self._lock:
            hit = self._store.pop(path, None)
            if hit is not None:
                self._hits += 1
                self._store[path] = hit  # re-insert as most recent
                return hit
            self._misses += 1
        decoded = self._reader(path)  # off-lock: decode is the slow part
        with self._lock:
            prev = self._store.pop(path, None)  # racing double-decode
            if prev is None:
                self._bytes += decoded.nbytes
            while self._bytes > self._max_bytes and self._store:
                _, old = self._store.popitem(last=False)
                self._bytes -= old.nbytes
                self._evictions += 1
            self._store[path] = decoded
        return decoded

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions, "bytes": self._bytes,
                    "entries": len(self._store)}


class FlyingChairsData:
    """FlyingChairs pairs under `cfg.data_path`: `XXXXX_img1.ppm`,
    `XXXXX_img2.ppm`, `XXXXX_flow.flo`.

    Images are resized to `cfg.image_size`; the ground-truth flow stays
    at its native resolution. The split is `FlyingChairs_train_val.txt`
    (one marker per sample, 1 = train, 2 = val) in the data directory or
    its parent; without it, the last min(640, 10%) samples (at least
    one) are val. Batches are sequential (`iteration`) or random
    (`rng`)."""

    mean = FLYINGCHAIRS_MEAN

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = cfg.data_path
        ids = sorted(m.group(1) for f in os.listdir(root)
                     if (m := re.match(r"(\d+)_img1\.ppm$", f)))
        if not ids:
            raise FileNotFoundError(f"no *_img1.ppm under {root}")
        split_file = os.path.join(root, "FlyingChairs_train_val.txt")
        if not os.path.exists(split_file):
            split_file = os.path.join(os.path.dirname(root),
                                      "FlyingChairs_train_val.txt")
        if os.path.exists(split_file):
            markers = np.loadtxt(split_file, dtype=int)[: len(ids)]
        else:  # no split file: the last 640 (capped at 10%, min 1) are val
            n_val = min(640, max(1, len(ids) // 10))
            markers = np.ones(len(ids), dtype=int)
            markers[-n_val:] = 2
        self.train_ids = [i for i, m in zip(ids, markers) if m == 1]
        self.val_ids = [i for i, m in zip(ids, markers) if m == 2]
        self.num_train, self.num_val = len(self.train_ids), len(self.val_ids)
        self._root = root
        self._cache = _DecodedCache(cfg.cache_decoded, read_ppm_bgr,
                                    max_bytes=cfg.cache_bytes)

    def _load(self, sid: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        p = os.path.join(self._root, sid)
        src = _resize(self._cache(p + "_img1.ppm"), self.cfg.image_size)
        tgt = _resize(self._cache(p + "_img2.ppm"), self.cfg.image_size)
        return src, tgt, read_flo(p + "_flow.flo")

    def _batch(self, sids: list[str]) -> dict:
        srcs, tgts, flows = zip(*(self._load(s) for s in sids))
        return {
            "source": np.stack(srcs).astype(np.float32),
            "target": np.stack(tgts).astype(np.float32),
            "flow": np.stack(flows).astype(np.float32),
        }

    def sample_train(self, batch_size, iteration=None, rng=None):
        if iteration is not None:  # sequential
            # wraps like sample_val, so a batch is never short
            if not self.num_train:
                raise ValueError(
                    f"empty FlyingChairs train split under {self._root} "
                    "(split file marks every pair as val)")
            start = (iteration * batch_size) % self.num_train
            sids = [self.train_ids[(start + k) % self.num_train]
                    for k in range(batch_size)]
        else:
            rng = rng or np.random
            sids = [self.train_ids[i]
                    for i in rng.randint(0, self.num_train, batch_size)]
        return self._batch(sids)

    def sample_val(self, batch_size, batch_id):
        start = (batch_id * batch_size) % max(self.num_val, 1)
        sids = [self.val_ids[(start + k) % self.num_val]
                for k in range(batch_size)]
        return self._batch(sids)

    def cache_stats(self) -> dict:
        return self._cache.stats()


class SyntheticData:
    """Procedural dataset with exact ground-truth flow (port of the JAX
    package's `SyntheticData`, styles "noise" and "blobs"). The numpy
    draws are made in the same order, so a batch for a given seed is the
    JAX batch.

    Each sample: a smooth random canvas; the target is the source
    translated by a per-sample integer (u, v), so the ground-truth flow
    is uniform, (-u, -v), and minimises the unsupervised loss. "noise"
    upsamples random noise by `feature_scale`; "blobs" draws multi-octave
    Gaussian blobs on a linear-gradient background. The "affine" style
    needs cv2.remap and has no route here yet.
    """

    mean = (0.0, 0.0, 0.0)

    def __init__(self, cfg: DataConfig, num_train: int = 64,
                 num_val: int = 16, max_shift: float = 4.0,
                 feature_scale: int = 8, style: str = "noise",
                 n_blobs: int = 8):
        if style == "affine":
            raise NotImplementedError(
                "SyntheticData style 'affine' needs cv2.remap, which this "
                "package does not have: ROADMAP Queue A item 5")
        if style not in ("noise", "blobs"):
            raise ValueError(f"unknown SyntheticData style {style!r}")
        self.cfg = cfg
        self.num_train, self.num_val = num_train, num_val
        self._max_shift = max_shift
        self._feature_scale = feature_scale
        self._style = style
        self._n_blobs = n_blobs

    def _sample(self, seed: int, shift_bound: float | None = None
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        rng = np.random.RandomState(seed)
        h, w = self.cfg.image_size
        if self._style == "blobs":
            img = self._blob_canvas(rng, h + 16, w + 16)
        else:
            fs = self._feature_scale
            base = rng.rand(h // fs + 2, w // fs + 2, 3).astype(
                np.float32) * 255.0
            img = _bicubic(base, (h + 16, w + 16))
        bound = int(round(self._max_shift if shift_bound is None
                          else shift_bound))
        u, v = rng.randint(-bound, bound + 1, 2)
        src = img[8:8 + h, 8:8 + w]
        tgt = img[8 + v:8 + v + h, 8 + u:8 + u + w]
        # tgt[y, x] == src[y+v, x+u]: the ground-truth flow is (-u, -v)
        flow = np.broadcast_to(
            np.asarray([-u, -v], np.float32), (h, w, 2)).copy()
        return src, tgt, flow

    def _blob_canvas(self, rng, ch: int, cw: int) -> np.ndarray:
        """Linear-gradient background plus Gaussian blobs whose sigmas are
        log-uniform from ~max_shift to ~1/3 of the canvas."""
        yy, xx = np.mgrid[0:ch, 0:cw].astype(np.float32)
        gdir = rng.rand(2) * 2 - 1
        bg = 60.0 + 60.0 * (gdir[0] * yy / ch + gdir[1] * xx / cw + 1.0)
        img = np.repeat(bg[..., None], 3, axis=-1)
        s_lo = max(self._max_shift, 3.0)
        s_hi = max(min(ch, cw) / 3.0, s_lo + 1.0)
        for _ in range(self._n_blobs):
            cy, cx = rng.rand(2) * [ch - 1, cw - 1]
            color = rng.rand(3) * 200.0 - 100.0
            s = float(np.exp(rng.uniform(np.log(s_lo), np.log(s_hi))))
            amp = (s_lo / s) ** 0.5
            blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
            img += blob[..., None] * color * amp
        return np.clip(img, 0.0, 255.0).astype(np.float32)

    def _batch(self, seeds, shift_bound: float | None = None) -> dict:
        srcs, tgts, flows = zip(*(self._sample(int(s), shift_bound)
                                  for s in seeds))
        t = self.cfg.time_step
        out = {
            "source": np.stack(srcs),
            "target": np.stack(tgts),
            "flow": np.stack(flows),
            "label": np.asarray([int(s) % 101 for s in seeds], np.int32),
        }
        if t > 2:  # volume mode: the pair repeated into a T-frame volume
            vol = [out["source"], out["target"]] * ((t + 1) // 2)
            out["volume"] = np.concatenate(vol[:t], axis=-1)
            out["flow"] = np.concatenate([out["flow"]] * (t - 1), axis=-1)
        return out

    def sample_train(self, batch_size, iteration=None, rng=None,
                     max_shift: float | None = None) -> dict:
        if iteration is not None:
            seeds = [(iteration * batch_size + k) % self.num_train
                     for k in range(batch_size)]
        else:
            rng = rng or np.random
            seeds = rng.randint(0, self.num_train, batch_size)
        return self._batch(seeds, shift_bound=max_shift)

    def sample_val(self, batch_size, batch_id) -> dict:
        seeds = [self.num_train + (batch_id * batch_size + k) % self.num_val
                 for k in range(batch_size)]
        return self._batch(seeds)


def build_dataset(cfg: DataConfig):
    """The dataset `cfg.dataset` names ("synthetic" or "flyingchairs")."""
    if cfg.dataset == "synthetic":
        return SyntheticData(cfg)
    if cfg.dataset == "flyingchairs":
        return FlyingChairsData(cfg)
    if cfg.dataset in ("sintel", "ucf101"):
        raise NotImplementedError(
            f"dataset {cfg.dataset!r} is not ported to deepof_tpu_torch "
            "yet: ROADMAP Queue A item 5 (data path: the Sintel and "
            "UCF-101 loaders need a PNG/JPEG decoder)")
    raise KeyError(f"unknown dataset {cfg.dataset!r}")
