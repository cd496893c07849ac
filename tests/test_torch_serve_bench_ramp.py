"""The port's serving bench's `--ramp` mode
(`deepof_tpu_torch/tools/serve_bench.py::ramp_bench`) on the CPU: the
JAX package's acceptance test
(`tests/test_supervise.py::test_serve_bench_ramp_schema_and_load_follower_shape`)
at its sizes and with its asserts, on the port's tool: an autoscaling
fleet of fake-executor replica processes on the CPU, the floor pool
sheds under the burst, scales up, the scaled pool absorbs the same
burst, nothing is dropped; the scale events reach `analyze`'s summary.
"""

import json

from deepof_tpu_torch.tools import serve_bench as sb


def test_serve_bench_ramp_schema_and_load_follower_shape(tmp_path):
    res = sb.ramp_bench(max_replicas=2, burst_clients=8, warm_s=0.5,
                        burst_s=3.0, idle_s=8.0,
                        log_dir=str(tmp_path / "ramp"), device="cpu")
    for key in sb.RAMP_REQUIRED_KEYS:
        assert key in res, f"ramp_bench result missing {key!r}"
    json.dumps(res)
    assert res["mode"] == "ramp"
    assert res["drops"] == 0
    assert res["evictions"] == 0
    assert res["sheds_burst"] > 0          # the floor pool shed
    assert res["scale_ups"] >= 1           # and the pool followed
    assert res["peak_replicas"] == 2
    assert res["sheds_after_scale"] < res["sheds_burst"]
    # the scale events are kind="fleet" records of the run directory,
    # and `analyze` summarizes them
    from deepof_tpu_torch.analyze import load_records, summarize

    summary = summarize(load_records(str(tmp_path / "ramp")))
    assert summary["scale_events"]["ups"] == res["scale_ups"]
