"""Background host-to-device prefetcher (port of
`deepof_tpu/data/prefetch.py`).

A producer thread takes the next batch from `next_batch()` (the input
pipeline's `get`) while the card runs the current step, and stages it on
the device ahead of use, so the step never waits on the host draw or on
a pageable copy.

On a CUDA device each batch is staged in PyTorch's terms of what
`jax.device_put` does in the JAX package:
  1. the entries the step reads (`train.step.DEVICE_KEYS`: the images
     as float32, an action batch's label as int64) are copied
     into a ring of pinned host buffers, reused from batch to batch
     (allocating ~9.4 MB of pinned memory a batch would cost
     milliseconds of `cudaHostAlloc`); before a slot is overwritten,
     the producer waits on the event of the copy that last read it;
  2. each is copied to the card with `non_blocking=True` on a side
     stream, and an event is recorded behind the copies.
Steps 1-2 are the `put` phase (`phase_cb("put", seconds)`, a ``put``
span of `obs/trace.py`); the copy itself runs on while the producer
draws the next batch. A `transform` (the train loop's augmentation,
`data/augmentation.py`) then runs on the staged tensors on the same side
stream, in the producer thread, before the event is recorded: the
`augment` phase and span. `get()` makes
the caller's current stream wait on the batch's event and calls
`record_stream` on each device tensor, so the caching allocator does not
hand its memory to another tensor while the step that reads it is still
queued. Other entries stay host arrays.

The label rides the same slot, side stream and event as its images, so
it is ready exactly when they are; stacked calls (train.steps_per_call)
stage it [K, B] as they stage the images [K, B, ...].

On the CPU the `put` phase makes the entries the step reads tensors of
their dtypes over the same memory (`torch.as_tensor`, no copy for
float32 images): no pinning, no stream; the transform runs after it.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..train.step import DEVICE_KEYS, device_dtype

#: Pinned host slots in the ring: the slot being filled and the one whose
#: copy may still be in flight.
PINNED_SLOTS = 2


def _host_array(batch: dict, key: str) -> np.ndarray:
    """A DEVICE_KEYS entry as a contiguous numpy array of its dtype."""
    return np.ascontiguousarray(
        batch[key], np.int64 if device_dtype(key) == torch.int64
        else np.float32)


def _as_tensors(batch: dict) -> dict:
    """The CPU `put`: the batch's DEVICE_KEYS as tensors of their
    dtypes."""
    out = dict(batch)
    for k in DEVICE_KEYS:
        if k in batch:
            out[k] = torch.as_tensor(_host_array(batch, k))
    return out


class Prefetcher:
    """Wraps a batch-producing callable into a prefetching iterator.

    next_batch: () -> dict of host numpy arrays.
    depth: staged batches held ahead of `get()`.
    device: where the batches go; a CUDA device stages the batch's
        `DEVICE_KEYS` on it.
    phase_cb: optional (name, seconds) sink for the `put` and `augment`
        phase times (StepTimer.phase).
    transform: optional (staged batch) -> batch, run in the producer
        thread on the device tensors (on the side stream on a card).
    """

    def __init__(self, next_batch: Callable[[], dict], depth: int = 2,
                 device: str | torch.device = "cpu",
                 phase_cb: Callable[[str, float], None] | None = None,
                 transform: Callable[[dict], dict] | None = None):
        self._next = next_batch
        self._transform = transform
        self._device = torch.device(device)
        self._cuda = self._device.type == "cuda"
        if self._cuda and self._device.index is None:
            self._device = torch.device("cuda", torch.cuda.current_device())
        self._phase_cb = phase_cb
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._exc: BaseException | None = None
        self._max_depth = 0  # peak staged-batch count (GIL-atomic update)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="prefetch")
        self._thread.start()

    # ------------------------------------------------------------ producer
    def _stage(self, batch: dict, ring: list, stream) -> tuple[dict, dict]:
        """Copy the batch's DEVICE_KEYS to the device through pinned slot
        ring[0] (then rotate the ring) on `stream`; returns (batch with
        device tensors, the slot, whose event the caller records)."""
        slot = ring[0]
        ring.append(ring.pop(0))
        if slot["event"] is not None:
            slot["event"].synchronize()  # its last copy has read it
        out = dict(batch)
        with torch.cuda.stream(stream):
            for k in DEVICE_KEYS:
                if k not in batch:
                    continue
                a = _host_array(batch, k)
                buf = slot["bufs"].get(k)
                if buf is None or tuple(buf.shape) != a.shape:
                    buf = torch.empty(a.shape, dtype=device_dtype(k),
                                      pin_memory=True)
                    slot["bufs"][k] = buf
                np.copyto(buf.numpy(), a)
                out[k] = buf.to(self._device, non_blocking=True)
        return out, slot

    def _run(self) -> None:
        try:
            stream = ring = None
            if self._cuda:
                # the current device and stream are per thread
                torch.cuda.set_device(self._device)
                stream = torch.cuda.Stream(self._device)
                ring = [{"bufs": {}, "event": None}
                        for _ in range(PINNED_SLOTS)]
            while not self._stop.is_set():
                item = self._next()
                t0 = time.perf_counter()
                with obs_trace.span("put"):
                    if self._cuda:
                        item, slot = self._stage(item, ring, stream)
                    else:
                        item = _as_tensors(item)
                if self._phase_cb is not None:
                    self._phase_cb("put", time.perf_counter() - t0)
                if self._transform is not None:
                    t0 = time.perf_counter()
                    with obs_trace.span("augment"):
                        if self._cuda:
                            with torch.cuda.stream(stream):
                                item = self._transform(item)
                        else:
                            item = self._transform(item)
                    if self._phase_cb is not None:
                        self._phase_cb("augment", time.perf_counter() - t0)
                if self._cuda:
                    # behind the copies and the transform; the slot is
                    # refilled only after it
                    event = torch.cuda.Event()
                    event.record(stream)
                    slot["event"] = event
                    item = (item, event)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        self._max_depth = max(self._max_depth,
                                              self._q.qsize())
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # noqa: BLE001 - surfaced on get()
            self._exc = e

    # ------------------------------------------------------------ consumer
    def get(self) -> dict:
        while True:
            if self._exc is not None:
                raise self._exc
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._exc is None:
                    raise RuntimeError("prefetch thread died without error")
        if not self._cuda:
            return item
        batch, event = item
        current = torch.cuda.current_stream(self._device)
        current.wait_event(event)
        for k in DEVICE_KEYS:
            if k in batch:
                batch[k].record_stream(current)
        return batch

    def stats(self) -> dict:
        """Current and peak staged depth. A staging queue that stays empty
        while the device consumes puts the bottleneck on the producer."""
        return {"staged_depth": self._q.qsize(),
                "max_staged_depth": self._max_depth}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
