"""The autoscaling fleet's chaos drill (port of the JAX package's
`tools/autoscale_drill.py`).

Runs a live autoscaling serving fleet (`python -m deepof_tpu_torch serve
--autoscale`, fake-executor replicas: `serve.fake_exec_ms`) through the
command line, HTTP, the router, the supervisor and the control loop:

  1. a burst of closed-loop clients against the min_replicas pool: the
     router sheds (`sheds_before`) and the autoscaler scales up;
  2. the same burst against the scaled pool: `sheds_after` falls to
     about 0;
  3. sustained idle scales the pool back down by graceful drain
     (`retired`; no eviction in the control run);
  4. under `--fault kill` (the default) a ready replica is SIGKILLed
     while the pool scales down: every probe request must still come
     back 200 through failover or the respawn (bounded client retries,
     no drop), and the `tail` verb exits 4 on the crash; the fault-free
     control (`--fault none`) exits 0: a retirement is no sickness.

Prints one JSON verdict with the JAX drill's keys (`REQUIRED_KEYS`);
exit code 0 iff the drill completed.

    python -m deepof_tpu_torch.tools.autoscale_drill --max-replicas 3 \\
        --clients 8 [--fault kill|none] [--device cpu|cuda]

`--device` is the replicas' (their `serve --device`; default cuda, this
machine's card; a fake executor launches no kernel on it).
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

from ..core.supervise import REPO_ROOT, child_env
# the closed-loop timed client pool and its "drops" (a request with no
# reply at all): one copy for both tools
from .serve_bench import _drive_timed, _flow_body

#: The output's pinned keys, the JAX drill's.
REQUIRED_KEYS = (
    "max_replicas", "fault", "requests", "errors", "drops",
    "sheds_before", "sheds_after", "scale_ups", "scale_downs",
    "retired", "evictions", "peak_replicas", "final_replicas",
    "kill_requests", "resolved_after_kill", "completed", "rc",
    "tail_rc", "wall_s",
)


def _post(port: int, body: bytes, timeout: float = 30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/flow", body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _healthz(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", "/healthz")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def _sheds(hz: dict) -> int:
    return int(hz.get("fleet_shed") or 0) + int(hz.get("fleet_unavailable")
                                                or 0)


def run_drill(max_replicas: int = 3, clients: int = 8,
              burst_s: float = 6.0, idle_s: float = 25.0,
              fault: str = "kill", log_dir: str | None = None,
              timeout_s: float = 300.0, device: str = "cuda") -> dict:
    """One drill run; returns the REQUIRED_KEYS dict (and log_dir)."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="autoscale_drill_")
    env = child_env()
    max_in_flight = 4
    cmd = [sys.executable, "-m", "deepof_tpu_torch", "serve", "--preset",
           "flyingchairs", "--autoscale", "--max-replicas",
           str(max_replicas), "--device", device, "--log-dir", log_dir,
           "--set", "data.image_size=[64,64]",
           "--set", "data.gt_size=[64,64]",
           "--set", "serve.fake_exec_ms=30", "--set", "serve.max_batch=2",
           "--set", "serve.host=127.0.0.1", "--set", "serve.port=0",
           "--set", f"serve.fleet.max_in_flight={max_in_flight}",
           "--set", "serve.fleet.poll_s=0.1",
           "--set", "serve.fleet.stale_after_s=10",
           "--set", "serve.fleet.term_grace_s=3",
           "--set", "serve.fleet.drain_timeout_s=3",
           "--set", "serve.fleet.backoff_s=0.1",
           "--set", "serve.fleet.autoscale_period_s=0.25",
           "--set", "serve.fleet.autoscale_up_after_s=0.5",
           "--set", "serve.fleet.autoscale_down_after_s=2.0",
           "--set", "serve.fleet.autoscale_up_cooldown_s=1.0",
           "--set", "serve.fleet.autoscale_down_cooldown_s=2.0",
           "--set", "obs.heartbeat_period_s=0.25"]
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=REPO_ROOT)
    out: dict = {"max_replicas": max_replicas, "fault": fault,
                 "log_dir": log_dir}
    # the backstop: every phase below is bounded but the announce line's
    # read; killing the server ends whatever waits (the read sees EOF,
    # the probes are refused) and the verdict reads completed false
    watchdog = threading.Timer(max(float(timeout_s), 1.0), proc.kill)
    watchdog.daemon = True
    watchdog.start()
    try:
        line = proc.stdout.readline()
        try:
            port = int(json.loads(line)["serving"].rsplit(":", 1)[1]
                       .rstrip("/"))
        except (ValueError, KeyError, json.JSONDecodeError):
            raise RuntimeError(f"no serving announce line: {line!r}")
        body = _flow_body((30, 60))

        # 1: the burst against the floor pool: sheds, then a scale-up
        shed0 = _sheds(_healthz(port))
        burst1 = _drive_timed(port, body, clients, burst_s)
        sheds_before = _sheds(_healthz(port)) - shed0

        # a trickle until the scaled pool can take the burst
        deadline = time.monotonic() + 60
        hold = {"ok": 0, "errors": 0, "drops": 0}
        while time.monotonic() < deadline:
            hz = _healthz(port)
            ready = int(hz.get("fleet_ready") or 0)
            if ready >= max_replicas or ready * max_in_flight > clients:
                break
            chunk = _drive_timed(port, body, 2, 0.5)
            for k in hold:
                hold[k] += chunk[k]
        peak = int(hz.get("fleet_replicas") or 0)

        # 2: the same burst against the scaled pool
        shed1 = _sheds(_healthz(port))
        burst2 = _drive_timed(port, body, clients, burst_s)
        sheds_after = _sheds(_healthz(port)) - shed1
        peak = max(peak, int(_healthz(port).get("fleet_replicas") or 0))

        # 3: sustained idle, a graceful scale-down
        deadline = time.monotonic() + idle_s
        while time.monotonic() < deadline:
            if int(_healthz(port).get("fleet_autoscale_down") or 0) >= 1:
                break
            time.sleep(0.25)

        # 4 (--fault kill): SIGKILL a ready replica while the pool
        # scales down; every probe must still come back 200
        kill_requests = 0
        resolved = 0
        if fault == "kill":
            # a victim read from one /healthz may retire before the
            # signal lands: read again until a kill sticks (bounded;
            # the probes hold the failover either way)
            for _ in range(10):
                victim = next((r for r in _healthz(port).get("replicas", [])
                               if r.get("state") == "ready"
                               and r.get("pid")), None)
                if victim is None:
                    break
                try:
                    os.kill(victim["pid"], signal.SIGKILL)
                    break
                except (ProcessLookupError, PermissionError):
                    continue
            kill_requests = 30
            for _ in range(kill_requests):
                for _attempt in range(40):  # bounded client retry
                    try:
                        status, _payload = _post(port, body, timeout=15)
                    except Exception:  # noqa: BLE001 - retried
                        status = -1
                    if status == 200:
                        resolved += 1
                        break
                    time.sleep(0.25)

        # the pool settles toward the floor; the final counters, then a
        # graceful stop
        deadline = time.monotonic() + idle_s
        while time.monotonic() < deadline:
            if int(_healthz(port).get("fleet_replicas") or 0) <= 1:
                break
            time.sleep(0.25)
        hz = _healthz(port)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)

        requests = (burst1["ok"] + burst1["errors"] + burst2["ok"]
                    + burst2["errors"] + hold["ok"] + hold["errors"]
                    + kill_requests)
        drops = burst1["drops"] + burst2["drops"] + hold["drops"]
        tail = subprocess.run(
            [sys.executable, "-m", "deepof_tpu_torch", "tail", "--log-dir",
             log_dir], capture_output=True, text=True, timeout=60, env=env,
            cwd=REPO_ROOT)
        expected_tail = 4 if fault == "kill" else 0
        out.update({
            "requests": requests,
            "errors": burst1["errors"] + burst2["errors"] + hold["errors"],
            "drops": drops,
            "sheds_before": sheds_before, "sheds_after": sheds_after,
            "scale_ups": int(hz.get("fleet_autoscale_up") or 0),
            "scale_downs": int(hz.get("fleet_autoscale_down") or 0),
            "retired": int(hz.get("fleet_retired") or 0),
            "evictions": int(hz.get("fleet_evictions") or 0),
            "peak_replicas": peak,
            "final_replicas": int(hz.get("fleet_replicas") or 0),
            "kill_requests": kill_requests,
            "resolved_after_kill": resolved,
            "rc": rc, "tail_rc": tail.returncode,
            "wall_s": round(time.monotonic() - t0, 2),
        })
        out["completed"] = bool(
            rc == 0
            and out["scale_ups"] >= 1 and out["scale_downs"] >= 1
            and out["retired"] >= 1
            and sheds_before > 0 and sheds_after < sheds_before
            and drops == 0
            and resolved == kill_requests
            and out["tail_rc"] == expected_tail
            and (fault == "kill" or out["evictions"] == 0))
        return out
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if "completed" not in out:
            out.setdefault("rc", proc.returncode)
            out["completed"] = False
            try:
                out["stderr_tail"] = proc.stderr.read()[-1500:]
            except (OSError, ValueError):
                pass
        proc.stdout.close()
        proc.stderr.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-replicas", type=int, default=3)
    ap.add_argument("--clients", type=int, default=8,
                    help="the burst's width (closed-loop clients)")
    ap.add_argument("--burst-s", type=float, default=6.0)
    ap.add_argument("--idle-s", type=float, default=25.0,
                    help="the idle window of the scale-down legs")
    ap.add_argument("--fault", default="kill", choices=("kill", "none"),
                    help="kill: SIGKILL a ready replica mid-scale-down "
                         "(tail must exit 4); none: the fault-free "
                         "control (no eviction, tail must exit 0)")
    ap.add_argument("--log-dir", default=None,
                    help="the run directory (default: a fresh temporary "
                         "one)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the replicas' device (default cuda)")
    args = ap.parse_args(argv)

    out = run_drill(max_replicas=args.max_replicas, clients=args.clients,
                    burst_s=args.burst_s, idle_s=args.idle_s,
                    fault=args.fault, log_dir=args.log_dir,
                    timeout_s=args.timeout, device=args.device)
    missing = [k for k in REQUIRED_KEYS if k not in out]
    if missing:
        raise AssertionError(f"the verdict lacks its keys: {missing}")
    print(json.dumps(out, indent=2))
    return 0 if out["completed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
