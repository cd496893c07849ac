"""Multi-worker host batch assembly with deterministic ordered delivery
(port of `deepof_tpu/data/pipeline.py`).

`InputPipeline` runs `make_batch(i)` on a pool of worker threads, out of
order, and delivers the batches in index order through a bounded
reorder buffer. Every batch index has its own rng,
`derive_batch_rng(base, i)`, so the delivered stream is bit-identical
for any `num_workers`, including 0, where `get()` assembles inline on
the caller's thread (the Prefetcher's producer thread in the train
loop). Workers are threads, as in the JAX package: numpy's copies and
PyTorch's resizes release the GIL, the rest of a draw holds it.

`stats()` reports batches assembled, assemble seconds, reorder-queue
depth, consumer waits and worker utilization; the train loop puts them
in every train record (`data_*`).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable

import numpy as np

from ..obs import trace as obs_trace
from ..resilience.healing import retry_bounded


def resolve_num_workers(num_workers: int,
                        cpu_count: int | None = None) -> int:
    """`data.num_workers` -> a pool size. >= 0 passes through; -1 (auto)
    is 0 on hosts with <= 2 cores, else min(4, cpu_count - 2).

    cpu_count: test override for the host probe."""
    n = int(num_workers)
    if n >= 0:
        return n
    if n != -1:  # a typo'd worker count must not silently become auto
        raise ValueError(f"num_workers must be >= 0 or -1 (auto), got {n}")
    cpus = cpu_count if cpu_count is not None else (os.cpu_count() or 1)
    if cpus <= 2:
        return 0
    return min(4, cpus - 2)


def derive_batch_rng(base_seed, batch_index: int,
                     salt: int = 0) -> np.random.RandomState:
    """(stream seed, batch index) -> rng, independent of the order in
    which batches are assembled. `base_seed` is an int or a uint32 array;
    base words and the index are carried as uint32 pairs, so 64-bit
    values fold in losslessly. `salt` selects a sibling stream; 0 appends
    nothing."""
    base = np.atleast_1d(np.asarray(base_seed, dtype=np.uint64))
    words = np.empty(2 * base.size + 2, np.uint32)
    words[0:-2:2] = (base & 0xFFFFFFFF).astype(np.uint32)
    words[1:-2:2] = (base >> 32).astype(np.uint32)
    idx = int(batch_index)
    words[-2] = idx & 0xFFFFFFFF
    words[-1] = (idx >> 32) & 0xFFFFFFFF
    if salt:
        s = int(salt)
        words = np.concatenate([
            words,
            np.asarray([s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF], np.uint32),
        ])
    return np.random.RandomState(words)


class InputPipeline:
    """Ordered delivery of `make_batch(i)` results over a worker pool.

    make_batch: batch index -> batch dict, a pure function of the index;
        with `num_workers > 0` it runs concurrently on pool threads.
    num_workers: pool size; 0 = assemble inline in `get()`; -1 = auto
        (`resolve_num_workers`).
    reorder_depth: how many indices past the delivery cursor workers may
        claim (bounds in-flight and buffered batches); 0 = 2 x workers.
    retries: re-attempts of a failed `make_batch(i)` (OSError,
        RuntimeError, ValueError) before the error dooms delivery; a
        retry reproduces the same batch.
    backoff_s: initial sleep before a retry; doubles per attempt.
    """

    def __init__(self, make_batch: Callable[[int], dict],
                 num_workers: int = 0, reorder_depth: int = 0,
                 retries: int = 0, backoff_s: float = 0.05):
        self._make = make_batch
        self._n = resolve_num_workers(num_workers)
        self._depth = (int(reorder_depth) if reorder_depth > 0
                       else max(2 * self._n, 1))
        self._retries = max(int(retries), 0)
        self._backoff = max(float(backoff_s), 0.0)
        self._cv = threading.Condition()
        self._next_claim = 0  # next index a worker will take
        self._next_out = 0  # next index get() delivers
        self._ready: dict[int, dict] = {}
        self._exc: BaseException | None = None
        self._fail_idx: int | None = None  # lowest index that errored
        self._stop = False
        # counters, guarded by _cv
        self._batches = 0
        self._assemble_s = 0.0
        self._waits = 0
        self._wait_s = 0.0
        self._retry_count = 0
        self._max_depth = 0
        self._t0 = time.perf_counter()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"pipeline-worker-{i}")
            for i in range(self._n)
        ]
        for t in self._threads:
            t.start()

    def _count_retry(self) -> None:
        with self._cv:
            self._retry_count += 1

    def _make_traced(self, i: int) -> dict:
        with obs_trace.span("assemble", index=i):
            return self._make(i)

    def _assemble(self, i: int) -> dict:
        """`make_batch(i)` on the retry ladder (an ``assemble`` span an
        attempt), counted; an error is kept to surface on `get()` and
        re-raised."""
        t0 = time.perf_counter()
        try:
            batch = retry_bounded(lambda: self._make_traced(i),
                                  retries=self._retries,
                                  backoff_s=self._backoff,
                                  on_retry=self._count_retry)
        except BaseException as e:  # noqa: BLE001 - surfaced on get()
            with self._cv:
                if self._exc is None:
                    self._exc = e
                if self._fail_idx is None or i < self._fail_idx:
                    self._fail_idx = i
                self._cv.notify_all()
            raise
        with self._cv:
            self._batches += 1
            self._assemble_s += time.perf_counter() - t0
        return batch

    def _worker(self) -> None:
        while True:
            with self._cv:
                while (not self._stop and self._exc is None
                       and self._next_claim >= self._next_out + self._depth):
                    self._cv.wait()
                if self._stop or self._exc is not None:
                    return
                i = self._next_claim
                self._next_claim += 1
            try:
                batch = self._assemble(i)
            except BaseException:  # noqa: BLE001 - kept for get()
                return
            with self._cv:
                self._ready[i] = batch
                self._max_depth = max(self._max_depth, len(self._ready))
                self._cv.notify_all()

    def get(self) -> dict:
        """Deliver the next batch, in index order."""
        if self._n == 0:
            with self._cv:
                if self._exc is not None:
                    raise self._exc
                i = self._next_out
                self._next_out += 1
            return self._assemble(i)
        with self._cv:
            i = self._next_out
            if i not in self._ready:
                # the consumer outran the pool (the host side of device
                # starvation)
                self._waits += 1
                t0 = time.perf_counter()
                while i not in self._ready:
                    # an error dooms delivery only from the failed index
                    # on: lower indices still arrive, in order
                    if (self._exc is not None
                            and (self._fail_idx is None
                                 or i >= self._fail_idx)):
                        raise self._exc
                    if self._stop:
                        raise RuntimeError("InputPipeline closed during get()")
                    if not self._cv.wait(timeout=5.0):
                        if not any(t.is_alive() for t in self._threads):
                            if self._exc is not None:
                                raise self._exc
                            raise RuntimeError(
                                "all pipeline workers died without error")
                self._wait_s += time.perf_counter() - t0
            batch = self._ready.pop(i)
            self._next_out += 1
            self._cv.notify_all()  # a claim slot opened
            return batch

    def stats(self) -> dict:
        """Counter snapshot (plain ints and floats)."""
        with self._cv:
            wall = max(time.perf_counter() - self._t0, 1e-9)
            return {
                "num_workers": self._n,
                "batches": self._batches,
                "assemble_s": round(self._assemble_s, 4),
                "assemble_s_mean": round(
                    self._assemble_s / self._batches, 4) if self._batches
                    else 0.0,
                "queue_depth": len(self._ready),
                "max_queue_depth": self._max_depth,
                "waits": self._waits,
                "wait_s": round(self._wait_s, 4),
                "retries": self._retry_count,
                "worker_util": round(
                    self._assemble_s / (max(self._n, 1) * wall), 4),
            }

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=2.0)
