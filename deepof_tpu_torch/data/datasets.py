"""Dataset constants, the host-side resize, the FlyingChairs, MPI-Sintel
and UCF-101 loaders and the procedural dataset (port of
`deepof_tpu/data/datasets.py`).

The JAX package resizes with cv2's INTER_LINEAR. This package has no
cv2: `_resize` is PyTorch's bilinear interpolation with half-pixel
centres and no antialiasing, which is the same sampling rule. It returns
float32 where cv2 rounds a uint8 image back to uint8, so the two differ
by at most a grey level. `SyntheticData`'s "noise" canvas upsamples with
PyTorch's bicubic filter in place of cv2's INTER_CUBIC (the same
a = -0.75 kernel with half-pixel centres; they agree to ~1e-4 grey
levels); its "affine" source, cv2.remap in the JAX package, is
`remap_linear_replicate`, OpenCV 5's remap arithmetic in numpy (equal
bit for bit to the installed cv2 5.0.0).

Decoding, two routes as in the JAX package:
  - cached (`data.cache_decoded=True`): each frame is decoded at its own
    size into a byte-bounded LRU, then `_resize`d. FlyingChairs' PPMs
    are read in numpy (`io/ppm.py`); other frames by the native decoder
    (`deepof_tpu_torch.native`, the JAX package's C++ copied), or, for a
    PNG when that build has no PNG codec, by `io/png.py`;
  - streaming (`data.cache_decoded=False`): a whole batch is decoded by
    the native decoder's thread pool with its fused bilinear resize
    (`resize_bilinear_bgr`), and the `.flo` files read there too.
A failed decode raises. Flows are `.flo` files (`io/flo.py`). UCF-101's
frames (`UCF101Data`) go the same two routes: cached through
`_imread_bgr`, or streaming through the native decoder when its build
has the frames' codec (the card's machine links PPM only: PNG frames
there take the cached route's `io/png.py`, JPEG frames are refused).
"""

from __future__ import annotations

import collections
import os
import re
import threading

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from ..core.config import DataConfig
from ..io.flo import read_flo
from ..io.png import SIGNATURE as PNG_SIGNATURE
from ..io.png import parse_png_bgr, read_png_bgr
from ..io.ppm import parse_ppm_bgr, read_ppm_bgr

FLYINGCHAIRS_MEAN = (97.533, 99.238, 97.056)  # BGR
SINTEL_MEAN = (70.1433, 83.1915, 92.8827)
UCF101_MEAN = (104.0, 117.0, 123.0)

DATASET_MEANS = {
    "flyingchairs": FLYINGCHAIRS_MEAN,
    "sintel": SINTEL_MEAN,
    "ucf101": UCF101_MEAN,
    "synthetic": (0.0, 0.0, 0.0),
}


def _imread_bgr(path: str) -> np.ndarray:
    """A PPM, PNG or JPEG file at its own size -> (H, W, 3) uint8 BGR,
    as cv2.imread(path, IMREAD_COLOR) gives it: the native decoder when
    its build has the file's codec, `io/png.py` for a PNG when it has no
    PNG codec; OSError naming the codecs otherwise."""
    if native.image_supported(path):
        return native.imread_bgr(path)
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE))
    if head == PNG_SIGNATURE:
        return read_png_bgr(path)
    raise OSError(f"{path}: no decoder for this file; the native decoder "
                  f"has {sorted(native.codecs())}")


def decode_image_bytes(data: bytes) -> np.ndarray:
    """An encoded PPM, PNG or JPEG held in memory -> (H, W, 3) uint8 BGR,
    as cv2.imdecode(buf, IMREAD_COLOR) gives it: the native decoder when
    its build has the codec, `io/png.py` / `io/ppm.py` for a PNG / PPM
    otherwise. Raises ValueError on corrupt bytes, and on a codec no
    route decodes, naming the native decoder's codecs (the card's
    machine links PPM only, so a JPEG there is refused, not guessed)."""
    kind = native.sniff(data)
    if kind is None:
        raise ValueError(f"not a PPM, PNG or JPEG image ({len(data)} "
                         f"bytes)")
    if kind in native.codecs():
        try:
            return native.imdecode_bgr(data)
        except OSError as e:
            raise ValueError(str(e)) from e
    if kind == "png":
        return parse_png_bgr(data)
    if kind == "ppm":
        return parse_ppm_bgr(data)
    raise ValueError(f"no {kind} decoder in this build: the native "
                     f"decoder has {sorted(native.codecs())}")


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
    (`rng`). With `cfg.cache_decoded` False a batch is decoded whole by
    the native decoder (streaming mode)."""

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
        self._flo_hw: tuple[int, int] | None = None  # streaming probe

    def _load(self, sid: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        p = os.path.join(self._root, sid)
        src = _resize(self._cache(p + "_img1.ppm"), self.cfg.image_size)
        tgt = _resize(self._cache(p + "_img2.ppm"), self.cfg.image_size)
        return src, tgt, read_flo(p + "_flow.flo")

    def _native_batch(self, sids: list[str]) -> dict:
        """Streaming mode: the batch's PPMs decoded and resized, and its
        `.flo` files read, on the native decoder's thread pool."""
        paths = [os.path.join(self._root, s) for s in sids]
        if self._flo_hw is None:
            self._flo_hw = native.flo_dims(paths[0] + "_flow.flo")
        imgs = native.decode_image_batch(
            [p + sfx for sfx in ("_img1.ppm", "_img2.ppm") for p in paths],
            self.cfg.image_size)
        flows = native.read_flo_batch([p + "_flow.flo" for p in paths],
                                      self._flo_hw)
        n = len(paths)
        return {"source": imgs[:n], "target": imgs[n:], "flow": flows}

    def _batch(self, sids: list[str]) -> dict:
        if not self.cfg.cache_decoded:
            return self._native_batch(sids)
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


class SintelData:
    """MPI-Sintel T-frame sliding-window volumes.

    Layout: `training/<pass>/<clip>/frame_XXXX.png` and
    `training/flow/<clip>/frame_XXXX.flo` under `cfg.data_path`. Every
    window of `time_step` consecutive frames of a clip is a sample. A
    batch is {"volume": (B, H, W, 3T) float32, the frames stacked
    frame-major, BGR within each, "flow": (B, H_gt, W_gt, 2(T-1)), the
    T-1 flows at their native resolution, (u, v) per pair}. Train draws
    are randomly cropped to `cfg.crop_size`; val draws are not.

    Val is the first window of each clip in sorted-clip order, plus one
    more `bamboo_2` window that starts at frame `time_step`; with
    `cfg.sintel_pair_split_file` (time_step 2 only) the k-th line labels
    the k-th consecutive pair instead ("1" train, "2" val).

    `decode_route` names how frames are decoded: "native" (own size,
    cached, then `_resize`), "python-png" (the same with `io/png.py`,
    when the native build has no PNG codec) or, with
    `cfg.cache_decoded` False and a PNG codec, "native-batch" (a whole
    batch on the decoder's thread pool with its fused resize)."""

    mean = SINTEL_MEAN

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.t = cfg.time_step
        if cfg.sintel_pair_split_file is not None and self.t != 2:
            raise ValueError(
                "data.sintel_pair_split_file is the gen-1 PAIR split "
                "(`version1/loader/sintelLoader.py:38-70`) and requires "
                f"time_step=2; got time_step={self.t}")
        img_root = os.path.join(cfg.data_path, "training", cfg.sintel_pass)
        flow_root = os.path.join(cfg.data_path, "training", "flow")
        self.windows: list[list[str]] = []  # absolute frame paths
        self.flow_windows: list[list[str]] = []
        val: list[int] = []
        for clip in sorted(os.listdir(img_root)):
            frames = sorted(os.path.join(img_root, clip, f)
                            for f in os.listdir(os.path.join(img_root, clip))
                            if f.endswith(".png"))
            flows = sorted(os.path.join(flow_root, clip, f)
                           for f in os.listdir(os.path.join(flow_root, clip))
                           if f.endswith(".flo"))
            clip_start = len(self.windows)
            n_windows = len(frames) - self.t + 1
            for k in range(n_windows):
                self.windows.append(frames[k:k + self.t])
                self.flow_windows.append(flows[k:k + self.t - 1])
            if n_windows > 0:
                val.append(clip_start)
            if clip == "bamboo_2" and n_windows > self.t:
                val.append(clip_start + self.t)
        if cfg.sintel_pair_split_file is not None:
            with open(cfg.sintel_pair_split_file) as sf:
                labels = [ln.strip()[:1] for ln in sf if ln.strip()]
            if len(labels) != len(self.windows):
                raise ValueError(
                    f"pair split file {cfg.sintel_pair_split_file!r} has "
                    f"{len(labels)} entries but the dataset has "
                    f"{len(self.windows)} consecutive pairs")
            bad = sorted(set(labels) - {"1", "2"})
            if bad:
                raise ValueError(
                    f"pair split file {cfg.sintel_pair_split_file!r} has "
                    f"entries {bad}; expected '1' (train) or '2' (val)")
            val = [i for i, c in enumerate(labels) if c == "2"]
        self.val_idx = val
        val_set = set(val)
        self.train_idx = [i for i in range(len(self.windows))
                          if i not in val_set]
        self.num_train, self.num_val = len(self.train_idx), len(self.val_idx)
        has_png = "png" in native.codecs()
        if not has_png:
            self.decode_route = "python-png"
        elif cfg.cache_decoded:
            self.decode_route = "native"
        else:
            self.decode_route = "native-batch"
        self._cache = _DecodedCache(
            cfg.cache_decoded, native.imread_bgr if has_png else read_png_bgr,
            max_bytes=cfg.cache_bytes)
        self._flo_hw: tuple[int, int] | None = None  # streaming probe

    def _crop_origin(self, rng: np.random.RandomState, h: int, w: int
                     ) -> tuple[int, int]:
        ch, cw = self.cfg.crop_size
        y = rng.randint(0, h - ch + 1)
        x = rng.randint(0, w - cw + 1)
        return y, x

    def _window(self, i: int, crop_rng) -> tuple[np.ndarray, np.ndarray]:
        imgs = [_resize(self._cache(p), self.cfg.image_size)
                for p in self.windows[i]]
        vol = np.concatenate(imgs, axis=-1).astype(np.float32)  # (H,W,3T)
        if crop_rng is not None and self.cfg.crop_size is not None:
            y, x = self._crop_origin(crop_rng, *vol.shape[:2])
            ch, cw = self.cfg.crop_size
            vol = vol[y:y + ch, x:x + cw]
        flows = np.concatenate([read_flo(p) for p in self.flow_windows[i]],
                               axis=-1).astype(np.float32)
        return vol, flows

    def _native_batch(self, idxs, crop_rng) -> dict:
        """Streaming mode: the batch's frames decoded with the fused
        resize and its `.flo` files read on the native decoder's thread
        pool; the crops draw from `crop_rng` in `_window`'s order."""
        t, b = self.t, len(idxs)
        h, w = self.cfg.image_size
        imgs = native.decode_image_batch(
            [p for i in idxs for p in self.windows[i]], (h, w))
        flow_paths = [p for i in idxs for p in self.flow_windows[i]]
        if self._flo_hw is None:
            self._flo_hw = native.flo_dims(flow_paths[0])
        fh, fw = self._flo_hw
        flo = native.read_flo_batch(flow_paths, (fh, fw))
        # each window's T frames stacked on channels, frame-major
        vols = (imgs.reshape(b, t, h, w, 3).transpose(0, 2, 3, 1, 4)
                .reshape(b, h, w, 3 * t))
        if crop_rng is not None and self.cfg.crop_size is not None:
            ch, cw = self.cfg.crop_size
            out = np.empty((b, ch, cw, 3 * t), np.float32)
            for k in range(b):
                y, x = self._crop_origin(crop_rng, h, w)
                out[k] = vols[k, y:y + ch, x:x + cw]
            vols = out
        flows = (flo.reshape(b, t - 1, fh, fw, 2).transpose(0, 2, 3, 1, 4)
                 .reshape(b, fh, fw, 2 * (t - 1)))
        return {"volume": vols, "flow": flows}

    def _batch(self, idxs, crop_rng=None) -> dict:
        if self.decode_route == "native-batch":
            return self._native_batch(idxs, crop_rng)
        vols, flows = zip(*(self._window(i, crop_rng) for i in idxs))
        return {"volume": np.stack(vols), "flow": np.stack(flows)}

    def sample_train(self, batch_size, iteration=None, rng=None):
        # windows have no sequential mode: `iteration` seeds the draw
        if rng is None:
            rng = np.random.RandomState(iteration)  # None: OS entropy
        idxs = [self.train_idx[i]
                for i in rng.randint(0, self.num_train, batch_size)]
        return self._batch(idxs, crop_rng=rng)

    def sample_val(self, batch_size, batch_id):
        start = (batch_id * batch_size) % max(self.num_val, 1)
        idxs = [self.val_idx[(start + k) % self.num_val]
                for k in range(batch_size)]
        return self._batch(idxs)

    def cache_stats(self) -> dict:
        return self._cache.stats()


class UCF101Data:
    """UCF-101 frame pairs for joint flow and action learning (port of the
    JAX package's `UCF101Data`).

    Layout: `frames/<class>/<clip>/<frame>` under `cfg.data_path`,
    classes, clips and frames sorted; a clip name's `_gNN_` group above 7
    is train, at most 7 val, and a name without one is group 99 (train).
    A clip with fewer than two frames is skipped. A train batch is one
    random consecutive pair from each of B random classes (drawn with
    replacement only when B exceeds the classes), labelled with the
    class index; a val batch is B pairs of one class, `batch_id`'s, drawn
    from `RandomState(batch_id)`. Clip, frame and label come from one
    draw order for both decode routes. Batches are {"source", "target":
    (B, H, W, 3) float32 BGR at `cfg.image_size`, "label": (B,) int32}.
    """

    mean = UCF101_MEAN

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = os.path.join(cfg.data_path, "frames")
        self.classes = sorted(os.listdir(root))
        self.train_clips: dict[int, list[list[str]]] = {}
        self.val_clips: dict[int, list[list[str]]] = {}
        for ci, cls in enumerate(self.classes):
            for clip in sorted(os.listdir(os.path.join(root, cls))):
                frames = sorted(
                    os.path.join(root, cls, clip, f)
                    for f in os.listdir(os.path.join(root, cls, clip)))
                if len(frames) < 2:
                    continue
                m = re.search(r"_g(\d+)_", clip)
                group = int(m.group(1)) if m else 99
                (self.train_clips if group > 7 else self.val_clips
                 ).setdefault(ci, []).append(frames)
        self.num_train = sum(len(v) for v in self.train_clips.values())
        self.num_val = sum(len(v) for v in self.val_clips.values())
        self._cache = _DecodedCache(cfg.cache_decoded, _imread_bgr,
                                    max_bytes=cfg.cache_bytes)
        self._native_ok: bool | None = None  # streaming codec probe, once

    def _batch_from(self, clips: dict[int, list[list[str]]], class_ids,
                    rng: np.random.RandomState) -> dict:
        # every path is drawn first (one draw order for both routes), then
        # the batch is decoded in one call
        paths, labels = [], []
        for ci in class_ids:
            pool = clips[ci]
            frames = pool[rng.randint(0, len(pool))]
            i = rng.randint(0, len(frames) - 1)
            paths += [frames[i], frames[i + 1]]
            labels.append(ci)
        imgs = self._decode_many(paths)
        return {"source": imgs[0::2], "target": imgs[1::2],
                "label": np.asarray(labels, np.int32)}

    def _decode_many(self, paths: list[str]) -> np.ndarray:
        """(N, H, W, 3) float32 BGR: the native decoder's thread pool with
        its fused resize in streaming mode when it has the codec, the
        cached route otherwise."""
        if not self.cfg.cache_decoded:
            if self._native_ok is None:
                self._native_ok = native.image_supported(paths[0])
            if self._native_ok:
                return native.decode_image_batch(paths, self.cfg.image_size)
        return np.stack([_resize(self._cache(p), self.cfg.image_size)
                         for p in paths]).astype(np.float32)

    def sample_train(self, batch_size, iteration=None, rng=None) -> dict:
        # sequential callers: `iteration` seeds the draw
        if rng is None:
            rng = np.random.RandomState(iteration)  # None: OS entropy
        avail = list(self.train_clips)
        class_ids = rng.choice(avail, size=batch_size,
                               replace=batch_size > len(avail))
        return self._batch_from(self.train_clips, class_ids, rng)

    def sample_val(self, batch_size, batch_id) -> dict:
        """B pairs of one class: the reference evaluates the classes one
        batch each, in turn."""
        rng = np.random.RandomState(batch_id)
        avail = sorted(self.val_clips)
        ci = avail[batch_id % len(avail)]
        return self._batch_from(self.val_clips, [ci] * batch_size, rng)

    def cache_stats(self) -> dict:
        return self._cache.stats()


def _fma(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """a * b + c rounded once to float32 (a fused multiply-add): the
    float32 product is exact in float64, so only the sum rounds there."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def remap_linear_replicate(img: np.ndarray, map_x: np.ndarray,
                           map_y: np.ndarray) -> np.ndarray:
    """`cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_REPLICATE)` on a
    float32 (H, W, C) image with float32 maps (H', W'), in numpy, as
    OpenCV 5 computes it: the coordinate split into floor(x) and its
    float32 fraction (no fixed-point table), the four taps each clamped
    to the image, and two lerps along x then one along y, each a fused
    multiply-add in float32: a + fx (b - a)."""
    h, w = img.shape[:2]
    mx, my = map_x.astype(np.float32), map_y.astype(np.float32)
    x0f, y0f = np.floor(mx), np.floor(my)
    fx = (mx - x0f)[..., None]
    fy = (my - y0f)[..., None]
    x0, y0 = x0f.astype(np.int64), y0f.astype(np.int64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya, yb = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    img = img.astype(np.float32, copy=False)
    v0, v1, v2, v3 = img[ya, xa], img[ya, xb], img[yb, xa], img[yb, xb]
    top = _fma(fx, v1 - v0, v0)
    bottom = _fma(fx, v3 - v2, v2)
    return _fma(fy, bottom - top, top)


class SyntheticData:
    """Procedural dataset with exact ground-truth flow (port of the JAX
    package's `SyntheticData`, styles "noise", "blobs" and "affine"). The
    numpy draws are made in the same order, so a batch for a given seed
    is the JAX batch.

    Each sample: a smooth random canvas; the target is the source
    translated by a per-sample integer (u, v), so the ground-truth flow
    is uniform, (-u, -v), and minimises the unsupervised loss. "noise"
    upsamples random noise by `feature_scale`; "blobs" draws multi-octave
    Gaussian blobs on a linear-gradient background. "affine" takes the
    blob canvas as the target and a spatially varying affine field as
    the flow, and builds the source as the target warped by it
    (`remap_linear_replicate`, OpenCV's remap in numpy): the flow and the
    target are the JAX package's bit for bit, the source within the
    bound that `tests/test_torch_gather_bf16.py` measures against cv2.
    """

    mean = (0.0, 0.0, 0.0)

    def __init__(self, cfg: DataConfig, num_train: int = 64,
                 num_val: int = 16, max_shift: float = 4.0,
                 feature_scale: int = 8, style: str = "noise",
                 n_blobs: int = 8):
        if style not in ("noise", "blobs", "affine"):
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
        if self._style == "affine":
            return self._sample_affine(rng, h, w, shift_bound)
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

    def _sample_affine(self, rng, h: int, w: int,
                       shift_bound: float | None = None):
        """The JAX package's `_sample_affine`
        (`deepof_tpu/data/datasets.py:607-642`), draw for draw: the
        target is the blob canvas; the flow g = A (p - c) + t, a small
        rotation, log-scale and shear about a random centre plus a
        translation, rescaled so max |g| <= the bound; the source is the
        target warped backward by g, src[p] = tgt[p + g(p)]."""
        bound = self._max_shift if shift_bound is None else shift_bound
        tgt = self._blob_canvas(rng, h, w)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cy, cx = rng.rand(2) * [h - 1, w - 1]
        ang = (rng.rand() - 0.5) * 0.2
        scale = 1.0 + (rng.rand() - 0.5) * 0.1
        shear = (rng.rand() - 0.5) * 0.1
        a = np.asarray([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]], np.float32)
        a = a @ np.asarray([[scale, shear], [0.0, 1.0 / scale]], np.float32)
        a -= np.eye(2, dtype=np.float32)
        tu, tv = (rng.rand(2) * 2 - 1) * bound * 0.5
        gu = a[0, 0] * (xx - cx) + a[0, 1] * (yy - cy) + tu
        gv = a[1, 0] * (xx - cx) + a[1, 1] * (yy - cy) + tv
        mag = float(np.sqrt(gu**2 + gv**2).max())
        if mag > bound:
            gu *= bound / mag
            gv *= bound / mag
        gu = gu.astype(np.float32)  # tu, tv are Python floats: float64
        gv = gv.astype(np.float32)
        src = remap_linear_replicate(tgt, xx + gu, yy + gv)
        flow = np.stack([gu, gv], axis=-1)
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

    def cache_stats(self) -> dict:
        """Procedural data decodes nothing; a zeroed record keeps the
        observability schema uniform across datasets (the JAX package's:
        train records carry decode_cache_* = 0, and a mixture sums its
        members' counters)."""
        return {"hits": 0, "misses": 0, "evictions": 0, "bytes": 0,
                "entries": 0}


def build_dataset(cfg: DataConfig):
    """The dataset `cfg.dataset` names ("synthetic", "flyingchairs",
    "sintel" or "ucf101")."""
    if cfg.dataset == "synthetic":
        return SyntheticData(cfg)
    if cfg.dataset == "flyingchairs":
        return FlyingChairsData(cfg)
    if cfg.dataset == "sintel":
        return SintelData(cfg)
    if cfg.dataset == "ucf101":
        return UCF101Data(cfg)
    raise KeyError(f"unknown dataset {cfg.dataset!r}")
