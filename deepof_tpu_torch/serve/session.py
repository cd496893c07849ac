"""Streaming video sessions (port of `deepof_tpu/serve/session.py`).

A client walking a video sends one new frame per step. The store keeps,
per session id, the previous frame's preprocessed half-row
(`buckets.prepare_frame`), so `InferenceEngine.submit_next` forms the
(prev, next) pair from one decode and one preprocess instead of two. It
also keeps the last step's raw flow output, the prior that the warm
start (`serve.session.warm_start`) refines.

Contract, as in the JAX package:
  - Parity: `prepare_pair` is the concatenation of two `prepare_frame`
    halves, so a streamed step's network input is bit for bit the pair a
    pairwise client would submit.
  - Bounded, never silent: an LRU of `max_sessions` with an idle TTL
    (`ttl_s`), enforced on access and by a sweeper thread. Every eviction
    leaves a tombstone: the id's next use raises `SessionExpired` once,
    and the client's resend re-primes (counted as resumed).
  - A frame advances the session when it is submitted, before its flow
    resolves.
  - A frame of another bucket re-primes the session in place (counted as
    rebucketed) and drops the prior.
  - The prior is written only by the engine (`set_flow`), guarded by
    liveness, bucket and the prime generation (`epoch`), so a step that
    was in flight across a re-prime cannot leave a stale flow behind.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

#: Tombstones kept after eviction or expiry (a few bytes each; bounded so
#: the map cannot grow without end).
TOMBSTONE_CAP = 4096


class _Session:
    __slots__ = ("sid", "row", "bucket", "native_hw", "tier", "frames",
                 "last_m", "flow", "epoch")

    def __init__(self, sid, row, bucket, native_hw, tier, now, epoch):
        self.sid = sid
        self.row = row                # prepare_frame half-row (H, W, 3) f32
        self.bucket = tuple(bucket)
        self.native_hw = tuple(native_hw)
        self.tier = tier
        self.frames = 1
        self.last_m = now
        self.flow = None              # the warm-start prior, (h, w, 2) f32
        self.epoch = epoch            # prime generation: set_flow's token


class SessionExpired(KeyError):
    """`sid` names a session that was evicted (LRU) or expired (TTL). The
    tombstone survives this raise, so the client's re-prime of the same
    id counts as resumed."""

    def __init__(self, sid: str, reason: str):
        super().__init__(sid)
        self.sid = sid
        self.reason = reason  # "expired" (TTL) | "evicted" (LRU)


class SessionStore:
    """Bounded, thread-safe session cache (see the module docstring).

    The sweeper thread runs only when both `ttl_s` and `sweep_s` are > 0;
    `close()` stops and joins it.
    """

    def __init__(self, max_sessions: int = 256, ttl_s: float = 120.0,
                 sweep_s: float = 5.0):
        self.max_sessions = max(int(max_sessions), 1)
        self.ttl_s = float(ttl_s)
        self._lock = threading.Lock()
        self._sessions: OrderedDict[str, _Session] = OrderedDict()
        self._tombstones: OrderedDict[str, str] = OrderedDict()
        # counters, guarded by _lock
        self._created = 0
        self._resumed = 0     # re-primes of a tombstoned id
        self._expired = 0     # TTL
        self._evicted = 0     # LRU
        self._deleted = 0
        self._rebucketed = 0
        self._frames = 0      # every accepted frame (primes and steps)
        self._steps = 0       # frames that formed a pair from the cache
        self._epoch = 0       # prime-generation counter
        self._stop = threading.Event()
        self._sweeper = None
        if self.ttl_s > 0 and float(sweep_s) > 0:
            self._sweeper = threading.Thread(
                target=self._sweep_loop, args=(float(sweep_s),),
                daemon=True, name="serve-session-sweeper")
            self._sweeper.start()

    def _expire_locked(self, sid: str, reason: str) -> None:
        self._sessions.pop(sid, None)
        self._tombstones[sid] = reason
        self._tombstones.move_to_end(sid)
        while len(self._tombstones) > TOMBSTONE_CAP:
            self._tombstones.popitem(last=False)
        if reason == "expired":
            self._expired += 1
        else:
            self._evicted += 1

    def _fresh_locked(self, s: _Session, now: float) -> bool:
        return self.ttl_s <= 0 or now - s.last_m <= self.ttl_s

    def _prime_locked(self, sid, row, bucket, native_hw, tier, now):
        self._epoch += 1
        s = _Session(sid, row, bucket, native_hw, tier, now, self._epoch)
        self._sessions[sid] = s
        while len(self._sessions) > self.max_sessions:
            self._expire_locked(next(iter(self._sessions)), "evicted")
        return s

    def contains(self, sid: str) -> bool:
        """Live and fresh (no LRU touch)."""
        now = time.monotonic()
        with self._lock:
            s = self._sessions.get(sid)
            return s is not None and self._fresh_locked(s, now)

    def advance(self, sid: str, row: np.ndarray, bucket: tuple[int, int],
                native_hw: tuple[int, int], tier: str):
        """Accept one frame for `sid`, atomically.

        Returns ("primed", session) when the frame opens or re-opens the
        session (nothing to dispatch), else ("step", prev_row, prior,
        epoch, session): the previous half-row, the cached flow (None
        until a step's flow has landed through `set_flow`; a None prior
        means a cold dispatch) and the prime generation that `set_flow`
        must be given. The stored frame becomes `row` either way; a
        re-prime drops the prior. Raises SessionExpired for a tombstoned
        id, once; the resend re-primes."""
        now = time.monotonic()
        bucket = tuple(bucket)
        with self._lock:
            s = self._sessions.get(sid)
            if s is not None and not self._fresh_locked(s, now):
                # TTL on access, exact whether or not the sweeper ran;
                # this raise is the notification
                self._expire_locked(sid, "expired")
                self._tombstones[sid] = "notified"
                raise SessionExpired(sid, "expired")
            if s is None:
                reason = self._tombstones.get(sid)
                if reason is not None and reason != "notified":
                    self._tombstones[sid] = "notified"
                    self._tombstones.move_to_end(sid)
                    raise SessionExpired(sid, reason)
            self._frames += 1
            if s is None:
                if self._tombstones.pop(sid, None) is not None:
                    self._resumed += 1
                else:
                    self._created += 1
                return ("primed", self._prime_locked(sid, row, bucket,
                                                     native_hw, tier, now))
            self._sessions.move_to_end(sid)
            if s.bucket != bucket:
                # the cached half-row and prior are at the old bucket's
                # resolution: re-prime in place, as a new generation
                self._rebucketed += 1
                self._epoch += 1
                s.row, s.bucket, s.flow, s.epoch = row, bucket, None, \
                    self._epoch
                s.native_hw, s.tier = tuple(native_hw), tier
                s.frames += 1
                s.last_m = now
                return ("primed", s)
            prev, prior = s.row, s.flow
            s.row = row
            s.native_hw, s.tier = tuple(native_hw), tier
            s.frames += 1
            s.last_m = now
            self._steps += 1
            return ("step", prev, prior, s.epoch, s)

    def set_flow(self, sid: str, flow: np.ndarray, bucket: tuple[int, int],
                 epoch: int) -> bool:
        """Record a step's raw flow output as the session's prior. Dropped
        (False) unless the session is live, at `bucket` and still of prime
        generation `epoch`. No LRU or TTL touch."""
        with self._lock:
            s = self._sessions.get(sid)
            if s is None or s.bucket != tuple(bucket) or s.epoch != epoch:
                return False
            s.flow = flow
            return True

    def delete(self, sid: str) -> bool:
        """End a session explicitly, without a tombstone: the id's next
        frame primes afresh. False when nothing live had that id."""
        with self._lock:
            self._tombstones.pop(sid, None)
            if self._sessions.pop(sid, None) is None:
                return False
            self._deleted += 1
            return True

    def sweep(self) -> int:
        """Expire every session idle past `ttl_s`; returns how many."""
        if self.ttl_s <= 0:
            return 0
        now = time.monotonic()
        with self._lock:
            dead = [sid for sid, s in self._sessions.items()
                    if not self._fresh_locked(s, now)]
            for sid in dead:
                self._expire_locked(sid, "expired")
        return len(dead)

    def _sweep_loop(self, sweep_s: float) -> None:
        while not self._stop.wait(sweep_s):
            self.sweep()

    def stats(self) -> dict:
        """The serve_sessions_* block. decode_saved equals steps: each step
        decoded and preprocessed one frame where a pairwise client's
        request would take two."""
        with self._lock:
            return {
                "serve_sessions_active": len(self._sessions),
                "serve_sessions_created": self._created,
                "serve_sessions_resumed": self._resumed,
                "serve_sessions_expired": self._expired,
                "serve_sessions_evicted": self._evicted,
                "serve_sessions_deleted": self._deleted,
                "serve_sessions_rebucketed": self._rebucketed,
                "serve_sessions_frames": self._frames,
                "serve_sessions_steps": self._steps,
                "serve_sessions_decode_saved": self._steps,
            }

    def close(self) -> None:
        """Stop and join the sweeper. Idempotent."""
        self._stop.set()
        if self._sweeper is not None:
            self._sweeper.join(timeout=5.0)
