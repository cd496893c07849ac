"""Supervisor core: the child-process plumbing of the serving fleet (a
copy of `deepof_tpu/core/supervise.py`).

The fleet (`serve/fleet.py`) spawns detached `python -m
deepof_tpu_torch serve --config-json <child-dir>/config.json --device
<dev>` subprocesses, judges their health from pid-gated
`heartbeat.json` reads, evicts with SIGTERM-then-SIGKILL, respawns with
exponential backoff, and drains gracefully on shutdown; the autoscaler
(`serve/autoscale.py`) scales up with one more `spawn_child` and down
with the graceful half of the eviction ladder. This module holds the
PURE decision pieces (heartbeat verdict, backoff arithmetic, crash-loop
breaker counting) and the effectful helpers (child-dir preparation, env
assembly, detached spawn, quiet signal delivery, bounded reap), as the
JAX package has them, with one change: `child_env` sets no platform
variable, because a child names its device in its argv.

Deliberately policy-free: the respawn state machine lives in the fleet.
Stdlib-only: a supervisor runs no model and must never create a CUDA
context its children need the card for.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import time
from typing import Callable

#: Repo root — children run with this cwd and import the package from it.
REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# ----------------------------------------------------------- TCP probes


def listening(host: str, port: int) -> bool:
    """True when something accepts TCP connections on host:port."""
    try:
        with socket.create_connection((host, port), timeout=0.5):
            return True
    except OSError:
        return False


def wait_for_listen(host: str, port: int, timeout_s: float = 20.0,
                    interval_s: float = 0.05) -> None:
    """Block until something accepts TCP connections on host:port, or
    raise TimeoutError — the connect-before-bind guard of the fleet and
    its tests."""
    deadline = time.monotonic() + max(float(timeout_s), 0.0)
    while True:
        if listening(host, port):
            return
        if time.monotonic() >= deadline:
            raise TimeoutError(f"nothing listening on {host}:{port} "
                               f"within {timeout_s}s")
        time.sleep(interval_s)


# ------------------------------------------------------------ child rec


class Child:
    """Supervisor-side record of one supervised child slot. Subclassed
    by the fleet's `_Replica`, which adds its own fields; mutation
    discipline (which lock, if any) is the subclass owner's contract."""

    def __init__(self, idx: int, state: str):
        self.idx = idx
        self.state = state
        self.proc: subprocess.Popen | None = None
        self.incarnation = 0
        self.started_m = 0.0
        self.last_exit: int | None = None
        self.last_reason: str | None = None


# ----------------------------------------------------- heartbeat verdict


def read_heartbeat(child_dir: str) -> dict | None:
    """The child's heartbeat.json content, or None when absent/torn
    (the file is atomically rewritten, so torn means 'not yet')."""
    try:
        with open(os.path.join(child_dir, "heartbeat.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def pid_gated(hb: dict | None, pid: int | None) -> dict | None:
    """The heartbeat, or None when it belongs to another incarnation —
    a dead incarnation's file (possibly `wedged: true` after a SIGKILL
    skipped the final write) can neither vouch for nor condemn the
    current process."""
    if hb is not None and pid is not None \
            and hb.get("pid") not in (None, pid):
        return None
    return hb


def heartbeat_verdict(hb: dict | None, pid: int | None, now_wall: float,
                      stale_after_s: float, stall_after_s: float,
                      stall_gate: Callable[[dict], bool] | None = None
                      ) -> str:
    """Pure health verdict for one child from its heartbeat CONTENT —
    the decision function both supervisors share.

    Returns one of:
      "no_heartbeat"  — no (readable) file yet: pre-start grace, judged
                        only by the caller's spawn timeout;
      "foreign_pid"   — the file belongs to another incarnation: same
                        treatment as no_heartbeat;
      "wedged"        — the child's own watchdog declared the wedge;
      "stale"         — the heartbeat thread itself stopped writing
                        (frozen/SIGSTOPped process, dead host);
      "stalled"       — the file is fresh but `last_step_age_s` grew
                        past `stall_after_s` while `stall_gate(hb)`
                        holds — progress hung before the child's own
                        watchdog (which needs beats to arm) would say
                        so. The gate is the subsystem's "is the stall
                        clock meaningful" predicate: the fleet requires
                        requests in flight. stall_after_s <= 0
                        disables;
      "ok"            — healthy.
    """
    if hb is None:
        return "no_heartbeat"
    if pid_gated(hb, pid) is None:
        return "foreign_pid"
    if hb.get("wedged"):
        return "wedged"
    t = hb.get("time")
    if isinstance(t, (int, float)) and now_wall - t > float(stale_after_s):
        return "stale"
    age = hb.get("last_step_age_s")
    if (float(stall_after_s) > 0
            and (stall_gate is None or stall_gate(hb))
            and isinstance(age, (int, float))
            and age > float(stall_after_s)):
        return "stalled"
    return "ok"


# ------------------------------------------------- backoff + breaker


def crash_loop_update(fast_failures: int, fast: bool,
                      clean: bool = False) -> int:
    """Next consecutive-fast-failure count after one child death. Only
    a FAST non-clean death counts toward the crash-loop breaker: a slow
    death resets it (the breaker is for crash loops, not for a child
    that ran healthily and then died once), and a clean rc=0 exit never
    counts either way (rolling restarts — however quick — must not open
    the breaker)."""
    if clean:
        return fast_failures
    return fast_failures + 1 if fast else 0


def backoff_delay(base_s: float, cap_s: float, fast_failures: int) -> float:
    """Exponential respawn backoff: base * 2^(fast_failures - 1),
    capped. Deliberately reproduces the fleet's historical arithmetic
    exactly, including the half-base delay at a reset (0) count."""
    return min(float(base_s) * 2 ** (fast_failures - 1), float(cap_s))


def breaker_open(fast_failures: int, threshold: int) -> bool:
    """True when the crash-loop circuit breaker should open (the child
    stays down, surfaced, instead of burning backoff forever while
    masking the defect)."""
    return fast_failures >= int(threshold)


# ---------------------------------------------------------- child spawn


def prepare_child_dir(child_dir: str, cfg) -> str:
    """Make the child's directory, delete any previous incarnation's
    heartbeat.json (a dead incarnation's file must not speak for the
    next — the pid gate would reject it anyway; deleting keeps verdicts
    unambiguous), and serialize the child's EXACT config tree to
    config.json (`core/config.config_from_dict` is the inverse).
    Returns the config path."""
    os.makedirs(child_dir, exist_ok=True)
    try:
        os.remove(os.path.join(child_dir, "heartbeat.json"))
    except OSError:
        pass
    cfg_path = os.path.join(child_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return cfg_path


def child_env(extra: dict | None = None) -> dict:
    """The spawn environment: the parent's env with the repo root on
    PYTHONPATH (children import the package from the checkout, whatever
    the parent's cwd) and any caller extras (replica identity, ...). The
    child's device is not here: it rides the child's argv (`--device`),
    and the card is never hidden from a child."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env


def spawn_child(argv: list[str], env: dict, stdout, stderr,
                **popen_kw) -> subprocess.Popen:
    """Detached child spawn: cwd pinned to the repo root and
    start_new_session=True — the parent's ^C is not the child's, so
    the supervisor OWNS teardown on every exit path (see run_fleet's
    finally block)."""
    return subprocess.Popen(argv, cwd=REPO_ROOT, env=env, stdout=stdout,
                            stderr=stderr, start_new_session=True,
                            **popen_kw)


# ------------------------------------------------ signals + bounded reap


def terminate_quietly(proc: subprocess.Popen | None) -> None:
    """SIGTERM, swallowing the already-dead race."""
    if proc is not None:
        try:
            proc.terminate()
        except OSError:
            pass


def kill_quietly(proc: subprocess.Popen | None) -> None:
    """SIGKILL, swallowing the already-dead race."""
    if proc is not None:
        try:
            proc.kill()
        except OSError:
            pass


def reap_within(proc: subprocess.Popen | None,
                deadline_m: float) -> int | None:
    """Wait for a child until the monotonic deadline, SIGKILL on expiry
    (the escalation half of SIGTERM-then-SIGKILL), and return its exit
    code. None for a never-spawned slot."""
    if proc is None:
        return None
    try:
        proc.wait(timeout=max(deadline_m - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        kill_quietly(proc)
        proc.wait()
    return proc.returncode
