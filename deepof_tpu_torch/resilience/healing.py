"""Self-healing sample assembly: retry, then quarantine and substitute
(port of `deepof_tpu/resilience/healing.py`).

  transient   bounded retries with exponential backoff. The batch rng is
              re-derived per attempt (`make_rng(index, round)` is pure),
              so a retry reproduces the exact draw the fault interrupted.
  persistent  after the retry budget the draw is quarantined (counted,
              logged, listed in the run summary) and replaced by a
              deterministic substitute drawn from `make_rng(index,
              round)` with the next round number, so the replacement
              depends only on (stream seed, batch index, round).

Runs inside the input-pipeline workers (the sampler is the pipeline's
`make_batch`), so a slow retry on one index never blocks the others.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

#: Exceptions worth retrying: IO and decode errors (OSError,
#: RuntimeError) and corrupt payloads (ValueError, which `io/flo.py` and
#: `io/ppm.py` raise on truncated or garbled files). Programming errors
#: (KeyError, TypeError, ...) surface at once.
RETRYABLE = (OSError, RuntimeError, ValueError)


def retry_bounded(fn, retries: int = 0, backoff_s: float = 0.0,
                  on_retry: Callable[[], None] | None = None):
    """Up to `retries` re-attempts of `fn()` on RETRYABLE errors, with
    exponential backoff from `backoff_s`; `on_retry` is called once per
    re-attempt. The one retry ladder of the data path."""
    delay = max(float(backoff_s), 0.0)
    retries = max(int(retries), 0)
    for attempt in range(retries + 1):
        try:
            return fn()
        except RETRYABLE:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry()
            if delay > 0:
                time.sleep(delay)
                delay *= 2
    raise AssertionError("unreachable")  # the loop returns or raises


class QuarantineError(Exception):
    """Every substitute redraw failed too: the data path is down, not one
    sample. Not an OSError/RuntimeError, so the pipeline's own retry
    does not run the exhausted ladder again."""


class HealingSampler:
    """Per-batch-index self-healing wrapper around sample assembly.

    make_rng: (index, round) -> rng. Pure; round 0 is the canonical
        stream (`derive_batch_rng(seed, index)`), rounds >= 1 the
        substitutes (`salt=round`).
    sample: (index, rng) -> batch dict. May raise RETRYABLE.
    retries: extra attempts per round after the first.
    backoff_s: initial sleep before a retry; doubles per retry.
    substitutes: quarantine-and-redraw rounds after round 0 fails.
    injector: optional `resilience.faults.FaultInjector`, consulted at
        its ``decode`` site once per attempt, inside the retry ladder, so
        an injected fault takes the real faults' recovery path.
    log: optional str sink (warn records).
    """

    def __init__(self, make_rng: Callable, sample: Callable,
                 retries: int = 2, backoff_s: float = 0.05,
                 substitutes: int = 3, injector=None,
                 log: Callable[[str], None] | None = None):
        self._make_rng = make_rng
        self._sample = sample
        self._retries = max(int(retries), 0)
        self._backoff = max(float(backoff_s), 0.0)
        self._substitutes = max(int(substitutes), 0)
        self._inj = injector
        self._log = log
        # pipeline workers call concurrently: counters under a lock
        self._lock = threading.Lock()
        self._sample_retries = 0
        self._quarantined = 0
        self._substituted = 0
        self.quarantine_log: list[dict] = []

    def _count_retry(self) -> None:
        with self._lock:
            self._sample_retries += 1

    def _draw(self, index: int, rnd: int) -> dict:
        """One attempt: the injector's decode site, then the draw."""
        if self._inj is not None:
            self._inj.check("decode", index)
        return self._sample(index, self._make_rng(index, rnd))

    def __call__(self, index: int) -> dict:
        last: BaseException | None = None
        for rnd in range(self._substitutes + 1):
            try:
                batch = retry_bounded(
                    lambda: self._draw(index, rnd),
                    retries=self._retries, backoff_s=self._backoff,
                    on_retry=self._count_retry)
            except RETRYABLE as e:
                # this round's budget is spent: quarantine the draw and
                # fall through to the next round's substitute
                last = e
                ev = {"index": int(index), "round": rnd,
                      "attempts": self._retries + 1,
                      "error": f"{type(e).__name__}: {e}"}
                with self._lock:
                    self._quarantined += 1
                    self.quarantine_log.append(ev)
                if self._log is not None:
                    self._log(
                        f"quarantined sample draw for batch index {index} "
                        f"(round {rnd}, {self._retries + 1} attempts: "
                        f"{ev['error']}); substituting a deterministic "
                        "redraw")
                continue
            if rnd > 0:
                with self._lock:
                    self._substituted += 1
            return batch
        raise QuarantineError(
            f"batch index {index}: all {self._substitutes} substitute "
            f"redraws failed after quarantine (last: "
            f"{type(last).__name__}: {last}) — the data path is down, "
            "not one bad sample") from last

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {"sample_retries": self._sample_retries,
                    "quarantined": self._quarantined,
                    "substituted": self._substituted}
