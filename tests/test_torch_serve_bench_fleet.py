"""The port's serving bench's `--fleet` and `--artifact-cold` modes
(`deepof_tpu_torch/tools/serve_bench.py`) on the CPU: the JAX package's
acceptance test of the fleet mode
(`tests/test_fleet.py::test_serve_bench_fleet_2x_replicas_beats_single`)
at its sizes and with its asserts, on the port's tool (fake-executor
replica processes on the CPU behind the router), and the artifact cold
start's schema.

The fleet test keeps the JAX test's one bounded retry, on the speedup
ratio only (>= 1.5): the schema, the errors, the sheds and both
replicas serving hold on each attempt.
"""

import json

import pytest

from deepof_tpu_torch.tools import serve_bench as sb


def test_serve_bench_fleet_2x_replicas_beats_single(tmp_path):
    for attempt in range(2):
        # max_batch 1 and a 40 ms dispatch: each replica is
        # latency-bound, so two serve about twice one's requests
        res = sb.fleet_bench(replicas=2, requests=32, clients=6,
                             max_batch=1, timeout_ms=2.0, exec_ms=40.0,
                             log_dir=str(tmp_path / f"bench{attempt}"),
                             device="cpu")
        for key in sb.FLEET_REQUIRED_KEYS:
            assert key in res, f"fleet_bench result missing {key!r}"
        json.dumps(res)
        assert res["mode"] == "fleet" and res["replicas"] == 2
        assert res["errors"] == 0 and res["single_errors"] == 0
        assert res["shed"] == 0
        # both replicas served (the spill spreads a saturated bucket)
        assert len(res["routed"]) == 2, res["routed"]
        # the router's /metrics, read back, counts the same requests
        assert res["metrics_scrape"]["fleet_responses"] == 32
        if res["speedup_vs_single"] >= 1.5:
            break
    assert res["speedup_vs_single"] >= 1.5, res


def test_serve_bench_artifact_cold_schema(tmp_path):
    """Publish, then the three cold legs: every JAX key; one lattice
    entry in the store, found by fingerprint in leg B and through the
    index in leg C, with no miss or reject; no library on the CPU."""
    res = sb.artifact_cold_bench(width_mult=0.25, bucket=(32, 64),
                                 log_dir=str(tmp_path), device="cpu")
    for key in sb.ARTIFACT_COLD_REQUIRED_KEYS:
        assert key in res, f"artifact_cold_bench result missing {key!r}"
    json.dumps(res)
    assert res["mode"] == "artifact_cold_start"
    assert (res["model"], res["width_mult"], res["ladder"]) == (
        "flownet_s", 0.25, 1)
    assert res["store_entries"] == 1
    assert (res["artifact_hits"], res["artifact_misses"],
            res["artifact_rejects"]) == (1, 0, 0)
    assert (res["index_hits"], res["index_misses"],
            res["index_rejects"]) == (1, 0, 0)
    assert res["libraries_built"] == {"a": [], "b": [], "c": []}
    assert all(res[k] > 0 for k in ("warm_wall_compile_s",
                                     "warm_wall_artifact_s",
                                     "warm_wall_index_s"))


@pytest.mark.parametrize("argv", [["--fleet", "2", "--requests", "8"]])
def test_fleet_command_line_prints_one_json_line(argv, capsys):
    assert sb.main(["--device", "cpu", *argv]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert all(k in res for k in sb.FLEET_REQUIRED_KEYS)
    assert res["errors"] == 0 and res["requests"] == 8
