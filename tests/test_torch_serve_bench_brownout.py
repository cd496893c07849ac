"""The port's serving bench's `--brownout` mode
(`deepof_tpu_torch/tools/serve_bench.py::brownout_bench`) on the CPU:
the JAX package's acceptance test
(`tests/test_degrade.py::test_brownout_drill_protects_default_priority`)
at its sizes and with its asserts, on the port's tool: the same
mixed-priority overload against two live two-replica fleets of
fake-executor processes on the CPU, the degrade controller off (default
traffic shed) and on (no default request shed in the counted window,
the overload shed at L3 from the low-priority clients, the tier and
bucket rungs served), no drop on either leg, and the ON leg's
transitions in its metrics.jsonl.
"""

import json
import os

from deepof_tpu_torch.tools import serve_bench as sb


def test_brownout_drill_protects_default_priority(tmp_path):
    res = sb.brownout_bench(replicas=2, default_clients=3, low_clients=8,
                            ramp_s=1.5, window_s=2.0,
                            log_dir=str(tmp_path), device="cpu")
    assert res["default_sheds_on"] == 0
    assert res["default_sheds_off"] >= 1
    assert res["max_level_on"] == 3
    assert res["shed_low_on"] >= 1
    assert res["tier_downgrades_on"] >= 1
    assert res["bucket_downgrades_on"] >= 1
    assert res["drops"] == 0
    missing = [k for k in sb.BROWNOUT_REQUIRED_KEYS if k not in res]
    assert not missing, missing
    recs = []
    with open(os.path.join(str(tmp_path), "leg_on", "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("kind") == "serve" and "level_after" in rec:
                recs.append(rec)
    assert [r["level_after"] for r in recs][:3] == [1, 2, 3]
    assert all(r["event"] == "degrade_escalate" for r in recs[:3])
