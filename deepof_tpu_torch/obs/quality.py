"""Label-free flow-quality scoring of served requests (port of
`deepof_tpu/obs/quality.py`).

Flow quality is measurable without ground truth: warp the second frame
backward by the served flow and score the photometric error against the
first frame (the training objective as a serving metric). Three proxies
a sampled request, off the hot path:

  photo    mean generalised-Charbonnier photometric error of
           warp(frame2, flow) against frame1 over the border-mask
           interior (lower is better);
  census   mean soft census distance (`ops/census.py`) between the
           warped frame and frame1: a brightness change moves `photo`
           but not `census`;
  smooth   mean first-difference magnitude of the flow: a collapsing or
           exploding flow head moves it.

The contract, as in the JAX package:

  - sampling is deterministic: `QualitySampler` decides by a crc32 hash
    of (seed, accepted-request index), so the sampled set depends only
    on the submission order;
  - scoring never blocks a response: a sampled row goes onto a bounded
    queue consumed by one scorer thread; a full queue drops the sample
    and counts it (`serve_quality_dropped`);
  - fixed-bound histograms (`obs/export.py` QUALITY_BUCKETS) and
    per-(tier, mode) sums merge exactly at the fleet's router;
  - the drift verdict: the first `quality_ref_samples` scored requests
    freeze a reference median of `photo`; afterwards a sample above
    `ref_p50 * quality_drift_factor` is a breach, and breaches over the
    post-reference samples burn `obs.quality_budget` (exhausted at burn
    >= 1, which the incident plane records as `quality_drift`).

Two scorers compute the same triple: `score_pair_np`, numpy (the JAX
package's reference, with a half-pixel bilinear resize of its own in
place of cv2's), which an engine with a stand-in executor uses; and
`make_score_fn`, torch on the engine's device, which a model engine
uses in place of the JAX package's jitted scorer: the resize is
`F.interpolate(bilinear, align_corners=False, antialias=False)` (the
JAX scorer does not antialias, `deepof_tpu/obs/quality.py:231-237`,
F2), the warp is `ops/warp.py` (on a card tensor one launch of the
float32 warp kernel, counted on `warp_fwd_quality`), and the census is
`ops/census.py`.
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from collections import deque
from typing import Callable

import numpy as np

from .export import QUALITY_BUCKETS, ValueHistogram, percentile_ms

#: Charbonnier parameters of the photometric proxy: the loss's defaults,
#: fixed so the proxy compares across configs and replicas
PHOTO_EPS = 1e-4
PHOTO_ALPHA = 0.25
#: border-mask ratio left out of the photometric and census means
BORDER_RATIO = 0.1
#: census window of the proxy (`ops/census.py`'s default)
CENSUS_WINDOW = 7

#: grayscale weights on BGR channels (`ops/smoothness.py`)
_GRAY = np.array([0.2989, 0.587, 0.114], np.float32)


class QualitySampler:
    """Deterministic seeded Bernoulli sampler over request indices:
    `sample(i)` maps crc32("q:<seed>:<i>") to [0, 1) and compares it with
    the rate, so two replicas given the same stream sample the same
    requests."""

    def __init__(self, rate: float, seed: int = 0):
        self.rate = min(max(float(rate), 0.0), 1.0)
        self.seed = int(seed)

    def sample(self, index: int) -> bool:
        if self.rate <= 0.0:
            return False
        if self.rate >= 1.0:
            return True
        h = zlib.crc32(f"q:{self.seed}:{int(index)}".encode())
        return h / 2**32 < self.rate


# ------------------------------------------- the proxy (numpy reference)


def _border_interior(h: int, w: int, extra: int = 0) -> tuple[slice, slice]:
    """The border mask's interior as a slice pair (width ceil(ratio * h),
    widened by `extra`, at most (min(h, w) - 1) // 2)."""
    bw = int(np.ceil(h * BORDER_RATIO)) + max(int(extra), 0)
    bw = min(bw, max((min(h, w) - 1) // 2, 0))
    return slice(bw, h - bw or None), slice(bw, w - bw or None)


def _resize_axis(img: np.ndarray, n: int, axis: int) -> np.ndarray:
    """Half-pixel-centred linear resampling of one axis to n samples,
    the source coordinate clamped to the image."""
    m = img.shape[axis]
    src = (np.arange(n, dtype=np.float64) + 0.5) * (m / n) - 0.5
    src = np.clip(src, 0.0, m - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, m - 1)
    shape = [1] * img.ndim
    shape[axis] = n
    frac = (src - lo).reshape(shape)
    a, b = np.take(img, lo, axis=axis), np.take(img, hi, axis=axis)
    return a + (b - a) * frac


def _resize_np(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """(H, W, C) -> (h, w, C) half-pixel bilinear, no antialiasing: the
    samples cv2.INTER_LINEAR and `jax.image.resize(antialias=False)`
    take, in float64, returned as float32."""
    if img.shape[:2] == tuple(hw):
        return img
    out = _resize_axis(_resize_axis(img.astype(np.float64), hw[0], 0),
                       hw[1], 1)
    return out.astype(np.float32)


def warp_bilinear_np(image: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward warp (H, W, C) by (H, W, 2), each neighbour clipped to
    the border on its own (the numpy twin of `ops/warp.py`)."""
    h, w = image.shape[:2]
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    fx = xs + flow[..., 0]
    fy = ys + flow[..., 1]
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    x0c = np.clip(x0, 0, w - 1)
    x1c = np.clip(x0 + 1, 0, w - 1)
    y0c = np.clip(y0, 0, h - 1)
    y1c = np.clip(y0 + 1, 0, h - 1)
    ia = image[y0c, x0c]
    ib = image[y1c, x0c]
    ic = image[y0c, x1c]
    id_ = image[y1c, x1c]
    return (ia * (1 - wx) * (1 - wy) + ib * (1 - wx) * wy
            + ic * wx * (1 - wy) + id_ * wx * wy)


def census_descriptors_np(gray255: np.ndarray, window: int = CENSUS_WINDOW,
                          eps: float = 0.81) -> np.ndarray:
    """(H, W, 1) grayscale intensities -> (H, W, window**2) soft census
    descriptors (edge padding, normalised differences)."""
    h, w = gray255.shape[:2]
    r = window // 2
    padded = np.pad(gray255, ((r, r), (r, r), (0, 0)), mode="edge")
    shifted = [padded[dy:dy + h, dx:dx + w, :]
               for dy in range(window) for dx in range(window)]
    d = np.concatenate(shifted, axis=-1) - gray255
    return d / np.sqrt(eps + np.square(d))


def census_distance_np(a: np.ndarray, b: np.ndarray,
                       thresh: float = 0.1) -> np.ndarray:
    d2 = np.square(a - b)
    return np.sum(d2 / (thresh + d2), axis=-1, keepdims=True)


def score_pair_np(x: np.ndarray, flow: np.ndarray,
                  census_window: int = CENSUS_WINDOW
                  ) -> tuple[float, float, float]:
    """The (photo, smooth, census) triple of one served request, numpy.

    x: (H, W, 6) the preprocessed input row (frame 1 in channels 0:3,
       frame 2 in 3:6, `serve/buckets.py::prepare_pair`);
    flow: (fh, fw, 2) the raw dispatch output, the finest scaled flow on
       the head's grid: the frames are resized down to that grid first,
       as the loss resizes them."""
    fh, fw = flow.shape[:2]
    f1 = _resize_np(np.ascontiguousarray(x[..., :3], np.float32), (fh, fw))
    f2 = _resize_np(np.ascontiguousarray(x[..., 3:6], np.float32), (fh, fw))
    recon = warp_bilinear_np(f2, flow.astype(np.float32))
    ys, xs = _border_interior(fh, fw)
    diff = 255.0 * (recon - f1)
    photo = float(np.mean(
        np.power(np.square(diff[ys, xs]) + PHOTO_EPS ** 2, PHOTO_ALPHA)))
    du = flow[:, :-1, :] - flow[:, 1:, :]
    dv = flow[:-1, :, :] - flow[1:, :, :]
    smooth = float((np.mean(np.abs(du)) + np.mean(np.abs(dv))) / 2.0)
    g1 = np.tensordot(f1 * 255.0, _GRAY, axes=[[-1], [0]])[..., None]
    gr = np.tensordot(recon * 255.0, _GRAY, axes=[[-1], [0]])[..., None]
    cys, cxs = _border_interior(fh, fw, extra=census_window // 2)
    dist = census_distance_np(
        census_descriptors_np(gr, census_window),
        census_descriptors_np(g1, census_window))
    census = float(np.mean(dist[cys, cxs]))
    return photo, smooth, census


# ------------------------------------------- the proxy (torch, on device)


def make_score_fn(device, census_window: int = CENSUS_WINDOW) -> Callable:
    """(x [B, H, W, 6], flow [B, fh, fw, 2]) numpy -> (photo, smooth,
    census) floats, means over the batch, computed in float32 on
    `device`: the same arithmetic as `score_pair_np`, on the port's
    ops. On a card the warp is one launch of the float32 warp kernel,
    counted on the `warp_fwd_quality` counter."""
    import torch
    import torch.nn.functional as F

    from ..ops.census import census_distance, census_transform
    from ..ops.warp import warp_levels_forward

    def resize(img, fh, fw):
        if tuple(img.shape[1:3]) == (fh, fw):
            return img
        return F.interpolate(img.permute(0, 3, 1, 2), size=(fh, fw),
                             mode="bilinear", align_corners=False,
                             antialias=False).permute(0, 2, 3, 1)

    def score(x, flow):
        with torch.inference_mode():
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
                device)
            ft = torch.from_numpy(np.ascontiguousarray(flow, np.float32)).to(
                device)
            fh, fw = ft.shape[1], ft.shape[2]
            f1 = resize(xt[..., :3], fh, fw)
            f2 = resize(xt[..., 3:6], fh, fw)
            recon = warp_levels_forward([f2], [ft], impl="xla",
                                        site="quality")[0]
            ys, xs = _border_interior(fh, fw)
            diff = 255.0 * (recon - f1)
            photo = (diff[:, ys, xs, :].square() + PHOTO_EPS ** 2).pow(
                PHOTO_ALPHA).mean()
            du = ft[:, :, :-1, :] - ft[:, :, 1:, :]
            dv = ft[:, :-1, :, :] - ft[:, 1:, :, :]
            smooth = (du.abs().mean() + dv.abs().mean()) / 2.0
            dist = census_distance(census_transform(recon, census_window),
                                   census_transform(f1, census_window))
            cys, cxs = _border_interior(fh, fw, extra=census_window // 2)
            census = dist[:, cys, cxs, :].mean()
            out = torch.stack([photo, smooth, census]).float().cpu()
        return tuple(float(v) for v in out)

    return score


# -------------------------------------------------------------- scorer


class QualityScorer:
    """Sampled quality scoring for one engine, off the hot path (see the
    module docstring).

    score_fn: (bucket, x [1, H, W, 6], flow [1, fh, fw, 2]) -> (photo,
        smooth, census). The other arguments are the `obs.quality_*`
        settings."""

    def __init__(self, score_fn: Callable, sample_rate: float,
                 seed: int = 0, queue_depth: int = 128,
                 ref_samples: int = 64, window: int = 256,
                 drift_factor: float = 2.0, budget: float = 0.1):
        self.sampler = QualitySampler(sample_rate, seed)
        self._score_fn = score_fn
        self._ref_samples = max(int(ref_samples), 1)
        self._drift_factor = max(float(drift_factor), 1.0)
        self._budget = max(float(budget), 1e-9)
        self._q: queue.Queue = queue.Queue(maxsize=max(int(queue_depth), 1))
        self._lock = threading.Lock()
        self._sampled = 0   # accepted onto the queue
        self._dropped = 0   # queue full: sample lost, response unaffected
        self._scored = 0
        self._errors = 0    # the scorer raised (counted; the thread lives)
        self._breaches = 0  # post-reference photo > ref_p50 * factor
        self._post_ref = 0  # scored samples after the reference froze
        self._ref: list[float] = []
        self._ref_p50: float | None = None
        self._window: deque = deque(maxlen=max(int(window), 8))
        self._hists = {"photo": ValueHistogram(QUALITY_BUCKETS),
                       "smooth": ValueHistogram(QUALITY_BUCKETS),
                       "census": ValueHistogram(QUALITY_BUCKETS)}
        # per "<tier>/<mode>" sums and counts: they merge key-wise at the
        # router, and a mean re-derives as sum / scored anywhere
        self._scored_by_key: dict[str, int] = {}
        self._photo_sum_by_key: dict[str, float] = {}
        self._smooth_sum_by_key: dict[str, float] = {}
        self._census_sum_by_key: dict[str, float] = {}
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-quality-scorer")
        self._thread.start()

    def should_sample(self, index: int) -> bool:
        return self.sampler.sample(index)

    def submit(self, x_row: np.ndarray, flow_row: np.ndarray,
               bucket: tuple[int, int], tier: str, mode: str) -> bool:
        """Hand one sampled request's (input row, raw flow) to the scorer
        thread; never blocks: a full queue drops the sample and counts
        it. The caller copies the rows off its reusable buffers."""
        try:
            self._q.put_nowait((x_row, flow_row, tuple(bucket), str(tier),
                                str(mode)))
        except queue.Full:
            with self._lock:
                self._dropped += 1
            return False
        with self._lock:
            self._sampled += 1
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            x_row, flow_row, bucket, tier, mode = item
            try:
                photo, smooth, census = self._score_fn(
                    bucket, x_row[None], flow_row[None])
            except Exception:  # noqa: BLE001 - scoring must not die; counted
                with self._lock:
                    self._errors += 1
                continue
            self._observe(float(photo), float(smooth), float(census),
                          f"{tier}/{mode}")

    def _observe(self, photo: float, smooth: float, census: float,
                 key: str) -> None:
        self._hists["photo"].observe(photo)
        self._hists["smooth"].observe(smooth)
        self._hists["census"].observe(census)
        with self._lock:
            self._scored += 1
            self._scored_by_key[key] = self._scored_by_key.get(key, 0) + 1
            for sums, v in ((self._photo_sum_by_key, photo),
                            (self._smooth_sum_by_key, smooth),
                            (self._census_sum_by_key, census)):
                sums[key] = round(sums.get(key, 0.0) + v, 6)
            if self._ref_p50 is None:
                self._ref.append(photo)
                if len(self._ref) >= self._ref_samples:
                    self._ref_p50 = float(np.median(self._ref))
                return
            self._post_ref += 1
            self._window.append(photo)
            if photo > self._ref_p50 * self._drift_factor:
                self._breaches += 1

    def stats(self) -> dict:
        """The serve_quality_* block (the engine adds it to its stats()
        only when sampling is on, so a rate of 0 keeps the schema)."""
        with self._lock:
            scored = self._scored
            post = self._post_ref
            breaches = self._breaches
            ref_p50 = self._ref_p50
            cur = list(self._window)
            out = {
                "serve_quality_sample_rate": self.sampler.rate,
                "serve_quality_sampled": self._sampled,
                "serve_quality_dropped": self._dropped,
                "serve_quality_scored": scored,
                "serve_quality_errors": self._errors,
                "serve_quality_breaches": breaches,
                "serve_quality_scored_by_key": dict(self._scored_by_key),
                "serve_quality_photo_sum_by_key":
                    dict(self._photo_sum_by_key),
                "serve_quality_smooth_sum_by_key":
                    dict(self._smooth_sum_by_key),
                "serve_quality_census_sum_by_key":
                    dict(self._census_sum_by_key),
            }
        hists = {k: h.snapshot() for k, h in self._hists.items()}
        out["serve_quality_photo_hist"] = hists["photo"]
        out["serve_quality_smooth_hist"] = hists["smooth"]
        out["serve_quality_census_hist"] = hists["census"]
        out["serve_quality_photo_p50"] = percentile_ms(hists["photo"], 0.50)
        out["serve_quality_smooth_p50"] = percentile_ms(hists["smooth"], 0.50)
        out["serve_quality_census_p50"] = percentile_ms(hists["census"], 0.50)
        bad_fraction = (breaches / post) if post else 0.0
        cur_p50 = float(np.median(cur)) if cur else None
        out["serve_quality"] = {
            "sample_rate": self.sampler.rate,
            "scored": scored,
            "ref_samples": min(scored, self._ref_samples),
            "ref_p50": round(ref_p50, 6) if ref_p50 is not None else None,
            "current_p50": (round(cur_p50, 6) if cur_p50 is not None
                            else None),
            "drift_ratio": (round(cur_p50 / ref_p50, 4)
                            if cur_p50 is not None and ref_p50 else None),
            "drift_factor": self._drift_factor,
            "breaches": breaches,
            "bad_fraction": round(bad_fraction, 6),
            "budget": round(self._budget, 6),
            "burn": round(bad_fraction / self._budget, 4),
            "exhausted": bool(post and bad_fraction >= self._budget),
        }
        return out

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Wait, bounded, until every accepted sample is scored (tests and
        measurements; never on the serving path)."""
        deadline = time.monotonic() + max(float(timeout_s), 0.0)
        while time.monotonic() < deadline:
            with self._lock:
                if self._scored + self._errors >= self._sampled:
                    return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        try:
            # behind the queued samples: the scorer drains, then exits; a
            # wedged scorer's full queue does not block close (the thread
            # is a daemon)
            self._q.put_nowait(None)
        except queue.Full:
            pass
        self._thread.join(timeout=10.0)
