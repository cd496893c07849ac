"""Deterministic, seeded fault injection — the chaos-test substrate (a
copy of `deepof_tpu/resilience/faults.py`, which is stdlib-only).

Every recovery path in this repo (decode retry/quarantine, pipeline
worker retries, fetch retries, skip-in-place divergence handling,
checkpoint verification + fallback) is provable only if faults can be
produced on demand, reproducibly, at the exact site the recovery code
guards. `FaultInjector` does that from config alone:

  - **Sites** are string-keyed chokepoints: ``decode`` (per micro-batch
    sample assembly), ``assemble`` (per dispatch-batch build on a
    pipeline worker), ``dispatch`` (per global step; poisons the batch
    with a NaN instead of raising — the divergence-ladder substrate),
    ``fetch`` (per metric value fetch), ``ckpt_save`` / ``ckpt_restore``
    (per checkpoint step), and the post-commit tamper sites
    ``ckpt_truncate`` / ``ckpt_corrupt`` (filesystem-level checkpoint
    damage, exercising manifest verification).
  - **Scheduling** is per-site: an explicit index tuple (``decode_at``)
    and/or a probability (``decode_p``) hashed from (seed, site, index)
    — so whether index i faults is a pure function of the config, never
    of thread timing or worker count.
  - **Persistence** is attempt-counted: the injector counts how many
    times each (site, index) has been checked and stops faulting after
    ``fail_attempts`` — ``1`` models a transient error (the first retry
    succeeds), ``retries + 1`` exhausts the retry budget and forces the
    quarantine/substitute path, a large value is a permanently bad
    sample. The counter is keyed by (site, index), so the sequence of
    outcomes is identical for any ``num_workers``.

Zero overhead when disabled: `build_injector` returns ``None`` for a
disabled config and every call site guards with ``if inj is not None``.

The training loop wires the sites ``decode`` (`resilience/healing.py`),
``assemble`` and ``dispatch`` (`train/loop.py`), ``fetch``
(`train/metrics_log.py`, both fetchers) and the checkpoint sites
(`train/checkpoint.py`); a serving replica of the fleet wires the
replica sites (`serve/server.py::install_replica_faults`); an elastic
pool's trainer child wires the host sites ``host_loss``, ``host_wedge``
and ``preempt_notice`` (`train/elastic.py::maybe_host_fault`, called
from `train/loop.py` after each call's heartbeat beat).

Stdlib-only: `core/config.py` imports `FaultConfig` without a cycle.
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass


class InjectedFault(OSError):
    """An injector-raised IO-shaped failure. Subclasses OSError so every
    retry/degrade path treats it exactly like the real transient errors
    it stands in for."""


@dataclass(frozen=True)
class FaultConfig:
    """Config-driven injection schedule (see module docstring).

    ``*_p`` fields are per-index probabilities in [0, 1]; ``*_at``
    fields are explicit index tuples that always fault. Both may be set;
    either triggers. All scheduling is deterministic in (seed, site,
    index).
    """

    enabled: bool = False
    seed: int = 0
    # raising sites
    decode_p: float = 0.0
    decode_at: tuple[int, ...] = ()
    assemble_p: float = 0.0
    assemble_at: tuple[int, ...] = ()
    fetch_p: float = 0.0
    fetch_at: tuple[int, ...] = ()
    ckpt_save_at: tuple[int, ...] = ()
    ckpt_restore_at: tuple[int, ...] = ()
    # acting sites: dispatch poisons the batch (one NaN) at these steps;
    # tamper sites damage the COMMITTED checkpoint dir for these steps
    # (truncate = delete one manifested file, corrupt = flip one byte)
    dispatch_at: tuple[int, ...] = ()
    ckpt_truncate_at: tuple[int, ...] = ()
    ckpt_corrupt_at: tuple[int, ...] = ()
    # replica-level acting sites (serving fleet chaos, serve/server.py
    # install_replica_faults): the site index is the REPLICA index (the
    # fleet exports DEEPOF_TPU_REPLICA to each subprocess), and the
    # fault arms once that replica has completed `replica_fault_after`
    # responses — "mid-load" by construction. replica_crash = SIGKILL
    # the serving process (kill -9); replica_wedge = the next dispatch
    # blocks forever (a hung device call — exactly what the serve
    # heartbeat watchdog exists to flag). Each replica process builds a
    # fresh injector from config, so a respawned replica re-arms the
    # same schedule: a crash-looping replica is one `replica_crash_at`
    # entry with a small replica_fault_after.
    replica_crash_at: tuple[int, ...] = ()
    replica_wedge_at: tuple[int, ...] = ()
    # replica_degrade: every dispatch AFTER the arm point returns
    # deliberately corrupted flow (a large constant offset) — the
    # deterministic stand-in for silently damaged weights (bad quantized
    # tier, bit-rotted checkpoint). The replica keeps serving and stays
    # healthy on every latency/SLO axis; ONLY the label-free quality
    # proxies (obs/quality.py) can see it — exactly the blind spot the
    # quality drift verdict exists to close.
    replica_degrade_at: tuple[int, ...] = ()
    replica_fault_after: int = 8
    # host-level acting sites (elastic training chaos, train/elastic.py
    # maybe_host_fault): the site index is the TRAINER HOST index
    # (cfg.elastic.host_index — the coordinator writes it into each
    # trainer's config.json), and the fault arms once that host's
    # global step reaches `host_fault_step` — "mid-run" by
    # construction. host_loss = SIGKILL the trainer process (a
    # preempted/OOM-killed/vanished pod host); host_wedge = the main
    # loop blocks forever after a step (a hung device dispatch — the
    # coordinator's content-stall verdict exists for exactly this);
    # preempt_notice = SIGTERM self-delivery (the cloud's preemption
    # warning — the trainer's graceful handler saves a verified
    # checkpoint and exits 0, and the coordinator re-forms without
    # it). Each trainer incarnation rebuilds the injector from config;
    # a lost host is never respawned under the same index, so a host
    # site fires at most once per run.
    host_loss_at: tuple[int, ...] = ()
    host_wedge_at: tuple[int, ...] = ()
    preempt_notice_at: tuple[int, ...] = ()
    host_fault_step: int = 0
    # how many checks of one (site, index) fault before it recovers:
    # 1 = transient (first retry succeeds); data_retries + 1 = exhausts
    # the retry budget and forces quarantine + substitution; a large
    # value = permanently failing.
    fail_attempts: int = 1


_SITES = ("decode", "assemble", "fetch", "ckpt_save", "ckpt_restore",
          "dispatch", "ckpt_truncate", "ckpt_corrupt",
          "replica_crash", "replica_wedge", "replica_degrade",
          "host_loss", "host_wedge", "preempt_notice")


def _u01(seed: int, site: str, index: int) -> float:
    """Deterministic uniform draw in [0, 1) from (seed, site, index)."""
    h = zlib.crc32(f"{seed}:{site}:{index}".encode())
    return h / 2**32


class FaultInjector:
    """See module docstring. Thread-safe: pipeline workers, the prefetch
    thread, the fetch consumer, and the main loop all consult one
    injector."""

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        self._attempts: dict[tuple[str, int], int] = {}
        self._fired: set[tuple[str, int]] = set()
        self._counts: dict[str, int] = {s: 0 for s in _SITES}

    # -------------------------------------------------------- scheduling
    def scheduled(self, site: str, index: int) -> bool:
        """Pure query: does the config schedule a fault at (site, index)?"""
        c = self.cfg
        at = getattr(c, f"{site}_at", ())
        if isinstance(at, (int, float)):  # --set ...dispatch_at=9 (scalar)
            at = (at,)
        if int(index) in tuple(int(i) for i in at):
            return True
        p = float(getattr(c, f"{site}_p", 0.0) or 0.0)
        return p > 0.0 and _u01(c.seed, site, int(index)) < p

    # ----------------------------------------------------- raising sites
    def check(self, site: str, index: int) -> None:
        """Raise `InjectedFault` if (site, index) is scheduled and has
        not yet exhausted `fail_attempts` checks. Each call for a
        scheduled key counts as one attempt, so bounded-retry callers
        recover from transient schedules and exhaust persistent ones —
        identically for any worker interleaving."""
        if not self.scheduled(site, index):
            return
        key = (site, int(index))
        with self._lock:
            n = self._attempts.get(key, 0) + 1
            self._attempts[key] = n
            if n > max(self.cfg.fail_attempts, 1):
                return
            self._counts[site] += 1
        raise InjectedFault(
            f"injected {site} fault at index {index} (attempt {n})")

    # ------------------------------------------------------ acting sites
    def hit(self, site: str, index: int) -> bool:
        """Consume-once acting-site query (e.g. ``dispatch``): True the
        first time a scheduled (site, index) is asked about, False after
        — the caller performs the fault action itself."""
        if not self.scheduled(site, index):
            return False
        key = (site, int(index))
        with self._lock:
            if key in self._fired:
                return False
            self._fired.add(key)
            self._counts[site] += 1
        return True

    def tamper_checkpoint(self, step: int, path: str) -> list[str]:
        """Post-commit checkpoint damage for the verification chaos
        tests: ``ckpt_truncate_at`` deletes one file from the committed
        dir, ``ckpt_corrupt_at`` flips one byte of one file. File choice
        is deterministic (largest file, ties broken by path) so runs
        reproduce. Returns a description of each action taken."""
        actions: list[str] = []
        for site, act in (("ckpt_truncate", "truncate"),
                          ("ckpt_corrupt", "corrupt")):
            if not self.hit(site, step):
                continue
            target = self._pick_file(path)
            if target is None:
                continue
            if act == "truncate":
                os.remove(target)
            else:
                with open(target, "r+b") as f:
                    b = f.read(1)
                    f.seek(0)
                    f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
            actions.append(f"{act}d {os.path.relpath(target, path)} of "
                           f"checkpoint step {step}")
        return actions

    @staticmethod
    def _pick_file(path: str) -> str | None:
        best: tuple[int, str] | None = None
        for root, _, names in os.walk(path):
            for nm in sorted(names):
                p = os.path.join(root, nm)
                try:
                    size = os.path.getsize(p)
                except OSError:
                    continue
                # prefer the largest file (the data payload, not a tiny
                # metadata sidecar); deterministic tie-break on path
                if best is None or (size, p) > best:
                    best = (size, p)
        return best[1] if best else None

    # ----------------------------------------------------- observability
    def stats(self) -> dict[str, int]:
        """Injected-fault counts per site (snapshot)."""
        with self._lock:
            return dict(self._counts)


def build_injector(cfg: FaultConfig | None) -> FaultInjector | None:
    """None unless injection is enabled — the zero-overhead contract:
    disabled configs never construct an injector and hot sites skip on
    one `is not None`."""
    if cfg is None or not cfg.enabled:
        return None
    return FaultInjector(cfg)
