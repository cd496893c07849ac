"""The port's autoscaling chaos drill
(`deepof_tpu_torch/tools/autoscale_drill.py`) on the CPU, from its
command line: `serve --autoscale` with fake-executor replica processes
through a burst, the same burst on the scaled pool and an idle
scale-down, once with a ready replica SIGKILLed mid-scale-down (`--fault
kill`: every probe answered 200, `tail` rc 4) and once without (`--fault
none`: no eviction, `tail` rc 0). Both drills run at once (each is
mostly clients waiting on a 30 ms fake dispatch); each verdict has the
JAX drill's keys and reads completed.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from deepof_tpu_torch.tools import autoscale_drill as drill

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def verdicts(tmp_path_factory):
    out = {}
    dirs = {f: str(tmp_path_factory.mktemp(f"drill_{f}"))
            for f in ("kill", "none")}

    def run(fault: str) -> None:
        log_dir = dirs[fault]
        res = subprocess.run(
            [sys.executable, "-m", "deepof_tpu_torch.tools.autoscale_drill",
             "--device", "cpu", "--fault", fault, "--burst-s", "3",
             "--log-dir", log_dir, "--timeout", "240"],
            capture_output=True, text=True, cwd=REPO, timeout=300)
        out[fault] = (res.returncode, res.stdout, res.stderr)

    threads = [threading.Thread(target=run, args=(f,))
               for f in ("kill", "none")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.mark.parametrize("fault", ["kill", "none"])
def test_autoscale_drill_verdict(verdicts, fault):
    rc, stdout, stderr = verdicts[fault]
    assert rc == 0, (stdout[-2000:], stderr[-2000:])
    res = json.loads(stdout)
    assert all(k in res for k in drill.REQUIRED_KEYS)
    assert res["completed"] and res["fault"] == fault
    assert res["drops"] == 0 and res["rc"] == 0
    assert res["sheds_before"] > 0
    assert res["sheds_after"] < res["sheds_before"]
    assert res["scale_ups"] >= 1 and res["scale_downs"] >= 1
    if fault == "kill":
        assert res["tail_rc"] == 4
        assert res["resolved_after_kill"] == res["kill_requests"] == 30
    else:
        assert res["tail_rc"] == 0 and res["evictions"] == 0
        assert res["kill_requests"] == 0
