"""The elastic pool's chaos drill (port of the JAX package's
`tools/elastic_drill.py`).

Runs an N-host elastic training run (`python -m deepof_tpu_torch train
--elastic N`) with a seeded `host_loss` SIGKILL of one host mid-run,
the preemption of a pod host end to end on one machine, and prints a
JSON verdict with the JAX drill's keys (`REQUIRED_KEYS`): did the run
reach the target step with no operator, how many re-forms it took, the
work lost, and how long the recovery took (the loss detected -> every
survivor training again).

    python -m deepof_tpu_torch.tools.elastic_drill --hosts 3 --target 10 \\
        --kill-host 1 --kill-step 4 [--device cpu|cuda] [--set K=V ...]

The run is the JAX drill's: FlowNet-S at width 0.25 on the synthetic
dataset (64x64, batch 4), a record every step, a checkpoint every
`--ckpt-every` steps, heartbeats every 0.25 s. Every host trains on
`--device`: cuda (the default) puts all of them on this machine's one
card, cpu on the CPU. `--set K=V`
(repeatable) goes to `train` after the drill's own settings, so it can
change the model and its size (e.g. `--set model=flownet_c --set
width_mult=1.0 --set "data.image_size=[384,512]"`).

Exit code 0 iff the drill completed (the target reached, the
checkpoints verify); 1 otherwise. `--fault none` runs the fault-free
control (reforms must be 0).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from ..core.supervise import REPO_ROOT, child_env
from ..resilience import verify as ckpt_verify

#: The output's pinned keys, the JAX drill's.
REQUIRED_KEYS = (
    "hosts", "target_step", "fault", "completed", "rc",
    "generation", "reforms", "lost_hosts", "steps_lost", "resumed_step",
    "max_step", "recovery_wall_s", "wall_s", "ckpt_ok", "tail_rc",
)


def run_drill(hosts: int = 3, target: int = 10, kill_host: int = 1,
              kill_step: int = 4, ckpt_every: int = 3,
              fault: str = "host_loss", log_dir: str | None = None,
              timeout_s: float = 900.0, device: str = "cuda",
              overrides: list[str] | tuple = ()) -> dict:
    """One drill run; returns the REQUIRED_KEYS dict (and log_dir)."""
    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="elastic_drill_")
    env = child_env()
    cmd = [sys.executable, "-m", "deepof_tpu_torch", "train", "--preset",
           "flyingchairs", "--synthetic", "--elastic", str(hosts),
           "--max-steps", str(target), "--log-dir", log_dir,
           "--device", device,
           "--set", "model=flownet_s", "--set", "width_mult=0.25",
           "--set", "data.batch_size=4", "--set", "train.eval_batch_size=4",
           "--set", "train.log_every=1", "--set", "train.eval_every=0",
           "--set", "train.ckpt_every_epochs=1000000",
           "--set", f"train.ckpt_every_steps={ckpt_every}",
           "--set", "obs.heartbeat_period_s=0.25",
           "--set", "elastic.poll_s=0.2",
           "--set", "elastic.stale_after_s=10",
           "--set", "elastic.wedge_after_s=30",
           # the skew limiter within the checkpoint cadence, so a
           # re-form's discarded tail stays within one period
           "--set", f"elastic.sync_ahead={max(min(ckpt_every - 1, 4), 1)}"]
    if fault != "none":
        cmd += ["--set", "resilience.faults.enabled=true",
                "--set", f"resilience.faults.{fault}_at=({kill_host},)",
                "--set", f"resilience.faults.host_fault_step={kill_step}"]
    for item in overrides:
        cmd += ["--set", item]
    t0 = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=timeout_s, env=env, cwd=REPO_ROOT)
    wall = time.monotonic() - t0
    lines = [ln for ln in res.stdout.strip().splitlines() if ln]
    try:
        summary = json.loads(lines[-1]) if lines else {}
    except json.JSONDecodeError:
        summary = {}

    rep = ckpt_verify.verify_run(log_dir)
    # a manifest-verified checkpoint at or past the target: a torn,
    # manifest-less final save must not pass
    ckpt_ok = bool(rep["ok"]) and (max(rep["valid_steps"],
                                       default=0) >= target)
    tail = subprocess.run(
        [sys.executable, "-m", "deepof_tpu_torch", "tail", "--log-dir",
         log_dir], capture_output=True, text=True, timeout=60, env=env,
        cwd=REPO_ROOT)
    out = {
        "hosts": hosts,
        "target_step": target,
        "fault": fault,
        "completed": bool(summary.get("completed"))
        and res.returncode == 0 and ckpt_ok,
        "rc": res.returncode,
        "generation": summary.get("elastic_generation"),
        "reforms": summary.get("elastic_reforms"),
        "lost_hosts": summary.get("elastic_lost_hosts"),
        "steps_lost": summary.get("elastic_steps_lost"),
        "resumed_step": summary.get("elastic_resumed_step"),
        "max_step": summary.get("elastic_max_step"),
        # the loss detected -> every survivor running again (stamped by
        # the coordinator when the re-formed world is back)
        "recovery_wall_s": summary.get("elastic_last_reform_s"),
        "wall_s": round(wall, 2),
        "ckpt_ok": ckpt_ok,
        "tail_rc": tail.returncode,
        "device": device,
        "log_dir": log_dir,
    }
    if res.returncode != 0:
        out["stderr_tail"] = res.stderr[-1500:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hosts", type=int, default=3)
    ap.add_argument("--target", type=int, default=10,
                    help="absolute target step")
    ap.add_argument("--kill-host", type=int, default=1)
    ap.add_argument("--kill-step", type=int, default=4,
                    help="arm the fault at this global step")
    ap.add_argument("--ckpt-every", type=int, default=3,
                    help="checkpoint cadence (bounds lost work)")
    ap.add_argument("--fault", default="host_loss",
                    choices=("host_loss", "host_wedge", "preempt_notice",
                             "none"),
                    help="which host chaos site to arm (none = the "
                         "fault-free control: reforms must be 0)")
    ap.add_argument("--log-dir", default=None,
                    help="run directory (default: a fresh temp dir)")
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every host trains (default cuda: all on "
                         "this machine's card, which raises without one)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE",
                    help="a train override after the drill's own")
    args = ap.parse_args(argv)

    out = run_drill(hosts=args.hosts, target=args.target,
                    kill_host=args.kill_host, kill_step=args.kill_step,
                    ckpt_every=args.ckpt_every, fault=args.fault,
                    log_dir=args.log_dir, timeout_s=args.timeout,
                    device=args.device, overrides=args.set)
    missing = [k for k in REQUIRED_KEYS if k not in out]
    assert not missing, f"drill output missing pinned keys: {missing}"
    print(json.dumps(out, indent=2))
    return 0 if out["completed"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
