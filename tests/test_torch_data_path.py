"""The PyTorch port's data path against the JAX package's: the input
pipeline's ordered stream, the self-healing sampler, the prefetcher's
CPU path, the PPM reader and the FlyingChairs loader.

Tolerances, each with its reason:
  - streams, splits, flows and native-size images: exact. The same
    numpy draws, the same files.
  - resized FlyingChairs images: 1.0 grey level. cv2 resizes a uint8
    image in fixed point and rounds to uint8; the port resizes in
    float32 with PyTorch and keeps the float.
"""

import sys
import threading
import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")  # the JAX side's image reader and resize

from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.data.datasets import FlyingChairsData as JaxChairs
from deepof_tpu.data.pipeline import InputPipeline as JaxPipeline
from deepof_tpu.data.pipeline import resolve_num_workers as jax_resolve
from deepof_tpu.resilience.healing import HealingSampler as JaxHealer
from deepof_tpu_torch.core.config import DataConfig
from deepof_tpu_torch.data.datasets import (FlyingChairsData, SyntheticData,
                                            _DecodedCache)
from deepof_tpu_torch.data.pipeline import (InputPipeline, derive_batch_rng,
                                            resolve_num_workers)
from deepof_tpu_torch.data.prefetch import Prefetcher
from deepof_tpu_torch.io.flo import write_flo
from deepof_tpu_torch.io.ppm import read_ppm_bgr, write_ppm_bgr
from deepof_tpu_torch.resilience.healing import (HealingSampler,
                                                 QuarantineError)

SEED = np.array([3, 5], np.uint32)


def _make_batch():
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=(32, 32)),
                       style="blobs")
    return lambda i: ds.sample_train(2, rng=derive_batch_rng(SEED, i))


def _stream(pipe, n):
    try:
        return [pipe.get() for _ in range(n)]
    finally:
        pipe.close()


def _assert_same_stream(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("num_workers", [0, 1, 4])
def test_pipeline_stream_matches_jax(num_workers):
    make = _make_batch()
    want = _stream(JaxPipeline(make, num_workers=0), 8)
    _assert_same_stream(
        _stream(InputPipeline(make, num_workers=num_workers), 8), want)
    _assert_same_stream(
        _stream(JaxPipeline(make, num_workers=num_workers), 8), want)


def test_resolve_num_workers_matches_jax():
    for n, cpus in [(0, 8), (3, 8), (-1, 1), (-1, 2), (-1, 3), (-1, 64)]:
        assert resolve_num_workers(n, cpus) == jax_resolve(n, cpus)
    with pytest.raises(ValueError):
        resolve_num_workers(-2)


@pytest.mark.parametrize("num_workers", [0, 3])
def test_pipeline_errors_surface_on_get(num_workers):
    def make(i):
        if i == 2:
            raise KeyError("boom")  # not retryable: surfaces at once
        return {"i": np.asarray([i])}

    pipe = InputPipeline(make, num_workers=num_workers, retries=2)
    try:
        assert [int(pipe.get()["i"][0]) for _ in range(2)] == [0, 1]
        with pytest.raises(KeyError, match="boom"):
            pipe.get()
    finally:
        pipe.close()
    assert pipe.stats()["retries"] == 0


def test_pipeline_retries_a_transient_error():
    failed = set()

    def make(i):
        if i == 1 and i not in failed:
            failed.add(i)
            raise OSError("flaky read")
        return {"i": np.asarray([i])}

    pipe = InputPipeline(make, num_workers=2, retries=1, backoff_s=0.0)
    assert [int(b["i"][0]) for b in _stream(pipe, 4)] == [0, 1, 2, 3]
    assert pipe.stats()["retries"] == 1


def test_healing_sampler_matches_jax():
    """A draw that fails every attempt of round 0 is quarantined and
    substituted from the salted stream, in both packages alike."""
    ds = SyntheticData(DataConfig(dataset="synthetic", image_size=(32, 32)),
                       style="blobs")

    def make_rng(i, rnd):
        return rnd, derive_batch_rng(SEED, i, salt=rnd)

    def sample(index, rnd_rng):
        rnd, rng = rnd_rng
        if index == 1 and rnd == 0:
            raise ValueError("corrupt sample")
        return ds.sample_train(2, rng=rng)

    port = HealingSampler(make_rng, sample, retries=1, backoff_s=0.0)
    jax_h = JaxHealer(make_rng, sample, retries=1, backoff_s=0.0)
    got = [port(i) for i in range(3)]
    _assert_same_stream(got, [jax_h(i) for i in range(3)])
    assert port.stats() == jax_h.stats() == {
        "sample_retries": 1, "quarantined": 1, "substituted": 1}
    np.testing.assert_array_equal(
        got[1]["source"],
        ds.sample_train(2, rng=derive_batch_rng(SEED, 1, salt=1))["source"])
    assert port.quarantine_log[0]["error"] == "ValueError: corrupt sample"

    def down(index, rnd_rng):
        raise OSError("down")

    with pytest.raises(QuarantineError, match="data path is down"):
        HealingSampler(make_rng, down, retries=0, substitutes=2,
                       backoff_s=0.0)(0)


def test_pipeline_and_healer_hold_under_thread_stress():
    """16 workers on 8 cores with a 1 us switch interval: delivery stays in
    index order and no retry count is lost."""
    failed, lock = set(), threading.Lock()

    def sample(index, rng):
        with lock:
            first = index % 3 == 0 and index not in failed
            if first:
                failed.add(index)
        if first:
            raise OSError("flaky read")
        return {"i": index}

    healer = HealingSampler(lambda i, rnd: None, sample, retries=1,
                            backoff_s=0.0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pipe = InputPipeline(healer, num_workers=16, reorder_depth=32)
        got = [pipe.get()["i"] for _ in range(300)]
    finally:
        sys.setswitchinterval(interval)
        pipe.close()
    assert got == list(range(300))
    assert not any(t.is_alive() for t in pipe._threads)
    assert healer.stats()["sample_retries"] == len(failed) >= 100


def test_prefetcher_keeps_order_and_closes_promptly():
    make = _make_batch()
    pipe = InputPipeline(make, num_workers=2)
    pre = Prefetcher(pipe.get, depth=2, device="cpu")
    try:
        got = [pre.get() for _ in range(6)]
    finally:
        pipe.close()
        t0 = time.perf_counter()
        pre.close()
        assert time.perf_counter() - t0 < 2.0
    assert not pre._thread.is_alive()
    _assert_same_stream(got, [make(i) for i in range(6)])
    assert 1 <= pre.stats()["max_staged_depth"] <= 2


def test_prefetcher_raises_the_producer_error():
    def next_batch():
        raise RuntimeError("producer failed")

    pre = Prefetcher(next_batch, depth=2, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="producer failed"):
            pre.get()
    finally:
        pre.close()


# ------------------------------------------------------------------ PPM


def test_ppm_reader_matches_cv2(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (7, 11, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "cv.ppm"), img)
    write_ppm_bgr(tmp_path / "port.ppm", img)
    # a header with a comment and CRLF-free odd whitespace
    rgb = np.ascontiguousarray(img[..., ::-1])
    (tmp_path / "comment.ppm").write_bytes(
        b"P6 # made by hand\n11\t7\n# maxval next\n255\n" + rgb.tobytes())
    for name in ("cv.ppm", "port.ppm", "comment.ppm"):
        got = read_ppm_bgr(tmp_path / name)
        np.testing.assert_array_equal(got, img)
        np.testing.assert_array_equal(
            got, cv2.imread(str(tmp_path / name), cv2.IMREAD_COLOR))
    (tmp_path / "short.ppm").write_bytes(b"P6\n11 7\n255\n" + b"\0" * 10)
    with pytest.raises(ValueError, match="truncated"):
        read_ppm_bgr(tmp_path / "short.ppm")
    (tmp_path / "p3.ppm").write_bytes(b"P3\n1 1\n255\n0 0 0\n")
    with pytest.raises(ValueError, match="P6"):
        read_ppm_bgr(tmp_path / "p3.ppm")


# --------------------------------------------------------- FlyingChairs

NATIVE = (24, 40)


def _make_chairs(root, n=6, split=True):
    rs = np.random.RandomState(1)
    for i in range(1, n + 1):
        sid = f"{i:05d}"
        for k in (1, 2):
            write_ppm_bgr(root / f"{sid}_img{k}.ppm",
                          rs.randint(0, 256, (*NATIVE, 3), np.uint8))
        write_flo(root / f"{sid}_flow.flo",
                  rs.randn(*NATIVE, 2).astype(np.float32) * 5)
    if split:
        (root / "FlyingChairs_train_val.txt").write_text(
            "\n".join(["1", "2", "1", "1", "2", "1"][:n]) + "\n")


def _chairs_pair(root, image_size):
    kw = dict(dataset="flyingchairs", data_path=str(root),
              image_size=image_size, gt_size=NATIVE)
    return FlyingChairsData(DataConfig(**kw)), JaxChairs(JaxDataConfig(**kw))


@pytest.mark.parametrize("image_size,tol", [(NATIVE, 0.0), ((16, 32), 1.0)])
def test_flyingchairs_matches_jax(tmp_path, image_size, tol):
    _make_chairs(tmp_path)
    port, jax_ds = _chairs_pair(tmp_path, image_size)
    assert (port.train_ids, port.val_ids) == (jax_ds.train_ids,
                                              jax_ds.val_ids)
    assert (port.num_train, port.num_val) == (4, 2)
    assert port.mean == jax_ds.mean
    draws = [(lambda d: d.sample_train(3, iteration=1)),
             (lambda d: d.sample_train(3, rng=derive_batch_rng(SEED, 0))),
             (lambda d: d.sample_val(3, 0))]
    for draw in draws:
        got, want = draw(port), draw(jax_ds)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["flow"], want["flow"])
        for k in ("source", "target"):
            assert got[k].dtype == np.float32
            assert got[k].shape == want[k].shape == (3, *image_size, 3)
            np.testing.assert_allclose(got[k], want[k], atol=tol, rtol=0)
    assert port.cache_stats()["misses"] == jax_ds.cache_stats()["misses"]


def test_flyingchairs_fallback_split_matches_jax(tmp_path):
    _make_chairs(tmp_path, n=5, split=False)
    port, jax_ds = _chairs_pair(tmp_path, NATIVE)
    assert (port.train_ids, port.val_ids) == (jax_ds.train_ids,
                                              jax_ds.val_ids)
    assert (port.num_train, port.num_val) == (4, 1)


def test_decoded_cache_counts_and_evicts():
    reads = []

    def reader(path):
        reads.append(path)
        return np.zeros(100, np.uint8)

    cache = _DecodedCache(True, reader, max_bytes=250)
    for p in ("a", "b", "a", "c", "b"):
        cache(p)
    # a, b miss; a hits; c evicts b (LRU); b misses again and evicts a
    assert reads == ["a", "b", "c", "b"]
    assert cache.stats() == {"hits": 1, "misses": 4, "evictions": 2,
                             "bytes": 200, "entries": 2}
    off = _DecodedCache(False, reader)
    off("a")
    off("a")
    assert off.stats()["misses"] == 0 and reads[-2:] == ["a", "a"]
