"""The port's serving benchmark (`deepof_tpu_torch/tools/serve_bench.py`,
the engine modes) on the CPU: the JAX package's schema tests of
`tools/serve_bench.py` at their sizes and with their asserts
(`tests/test_serve.py::test_serve_bench_schema_smoke`,
`test_quant.py::test_serve_bench_precision_schema_smoke`,
`test_session.py::test_serve_bench_stream_speedup_and_schema`,
`test_quality.py::test_serve_bench_quality_schema`,
`test_ledger.py::test_serve_bench_ledger_required_keys_schema`), the
incident mode's schema, the command line (one JSON line; each process
mode and each setting only those modes read reaches its mode's function
with the JAX tool's defaults), and a small FlowNet-C real run through
the plain correlation. The process modes themselves run in
`tests/test_torch_serve_bench_{fleet,ramp,brownout}.py`.

The stream test keeps the JAX test's one bounded retry, on the two
timing ratios only (`stream_speedup` >= 1.5, `warm_speedup` >= 1.3);
every other assert holds on each attempt. No tolerance is loosened: the
bounds are the JAX tests' own.
"""

import json
import os

import numpy as np
import pytest
import torch

from deepof_tpu_torch.obs.ledger import exec_name
from deepof_tpu_torch.tools import serve_bench as sb

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def test_serve_bench_schema_smoke():
    res = sb.serve_bench(requests=6, gap_ms=0.0, max_batch=4,
                         timeout_ms=10.0, exec_ms=1.0, serial=True,
                         device="cpu")
    for key in sb.REQUIRED_KEYS:
        assert key in res, f"serve_bench result missing {key!r}"
    assert res["mode"] == "fake"
    assert res["requests"] == 6 and res["errors"] == 0
    assert res["dispatches"] >= 1
    assert res["requests_per_s"] > 0
    assert "speedup_vs_serial" in res
    json.dumps(res)


def test_serve_bench_precision_schema_smoke():
    res = sb.precision_bench(requests=4, gap_ms=0.0, max_batch=2,
                             timeout_ms=5.0, bucket=(32, 64),
                             native_hw=(30, 60),
                             tiers=("f32", "bf16", "int8"), device="cpu")
    for key in sb.PRECISION_REQUIRED_KEYS:
        assert key in res, f"precision_bench result missing {key!r}"
    assert res["mode"] == "precision"
    assert list(res["tiers"]) == ["f32", "bf16", "int8"]
    for tier, block in res["tiers"].items():
        for key in sb.TIER_REQUIRED_KEYS:
            assert key in block, f"tier {tier} missing {key!r}"
        assert block["errors"] == 0
        assert block["requests_per_s"] > 0
    assert res["tiers"]["f32"]["epe_vs_f32"] == 0.0
    assert 0 < res["tiers"]["int8"]["epe_vs_f32"] < 0.2
    assert res["tiers"]["bf16"]["weight_bytes"] \
        < res["tiers"]["f32"]["weight_bytes"]
    assert res["tiers"]["int8"]["weight_bytes"] \
        < res["tiers"]["bf16"]["weight_bytes"]
    json.dumps(res)


def test_serve_bench_stream_speedup_and_schema():
    for attempt in range(2):
        res = sb.stream_bench(frames=32, decode_ms=20.0, exec_ms=2.0,
                              max_batch=4, timeout_ms=2.0,
                              warm_frames=12, device="cpu")
        for key in sb.STREAM_REQUIRED_KEYS:
            assert key in res, f"stream result missing {key!r}"
        json.dumps(res)
        assert res["mode"] == "stream" and res["errors"] == 0
        assert res["flow_bitwise_equal"] is True
        # the decode counts are exact: N against 2(N-1)
        assert res["stream_decodes"] == 32
        assert res["pairwise_decodes"] == 62
        assert res["decode_saved"] == 31
        # the warm walk's structure and quality gate, on every attempt
        assert res["warm_errors"] == 0
        assert res["warm_steps"] == 10  # 12 frames: prime, fallback, 10
        assert res["warm_cold_fallbacks"] == 1
        assert res["epe_vs_cold"] <= 0.5, res
        if res["stream_speedup"] >= 1.5 and res["warm_speedup"] >= 1.3:
            break
    assert res["stream_speedup"] >= 1.5, res
    assert res["warm_speedup"] >= 1.3, res


def test_serve_bench_quality_schema():
    res = sb.quality_bench(requests=4, gap_ms=0.0, max_batch=2,
                           timeout_ms=2.0, bucket=(32, 64),
                           native_hw=(30, 60), tiers=("f32",),
                           sample_rate=0.5, device="cpu")
    for key in sb.QUALITY_REQUIRED_KEYS:
        assert key in res, key
    tier = res["tiers"]["f32"]
    for key in sb.QUALITY_TIER_REQUIRED_KEYS:
        assert key in tier, key
    assert tier["scored"] == 4
    for proxy in ("photo", "smooth", "census"):
        assert tier[proxy] is not None and np.isfinite(tier[proxy])
        assert tier[proxy] >= 0
    assert res["quality"]["scored"] == 4
    assert res["rps_quality_off"] and res["rps_quality_on"]
    assert 0 <= res["scored_quality_on"] <= 4


def test_serve_bench_ledger_required_keys_schema(tmp_path):
    res = sb.ledger_bench(requests=6, gap_ms=0.0, max_batch=2,
                          timeout_ms=5.0, bucket=(32, 64),
                          native_hw=(30, 60), log_dir=None, device="cpu")
    for key in sb.LEDGER_REQUIRED_KEYS:
        assert key in res, key
    assert res["lowerings"] >= 1 and res["recompiles"] == 0
    name = exec_name((32, 64), "f32", "cold")
    assert name in res["executables"]
    assert res["executables"][name]["fingerprint"]
    assert res["compile_s_total"] > 0
    assert res["p99_ledger_on_ms"] > 0 and res["p99_ledger_off_ms"] > 0


def test_serve_bench_ledger_reads_only_this_runs_rows(tmp_path):
    # a reused run dir (the model given, so nothing is restored from
    # it): the second run counts and reads its own row only
    model = sb._real_model(sb._bench_cfg((32, 64), 2, 5.0, None), "cpu")
    kw = dict(requests=2, gap_ms=0.0, max_batch=2, timeout_ms=5.0,
              bucket=(32, 64), native_hw=(30, 60), log_dir=str(tmp_path),
              device="cpu", model=model)
    first = sb.ledger_bench(**kw)
    second = sb.ledger_bench(**kw)
    rows = [json.loads(ln) for ln in
            open(tmp_path / "ledger.jsonl").read().splitlines()]
    name = exec_name((32, 64), "f32", "cold")
    assert sum(r["kind"] == "exec" for r in rows) == 2
    assert list(first["executables"]) == list(second["executables"]) \
        == [name]
    assert second["lowerings"] == 1


def test_serve_bench_incidents_schema():
    res = sb.incident_bench(requests=6, gap_ms=0.0, max_batch=2,
                            timeout_ms=5.0, bucket=(32, 64),
                            native_hw=(30, 60), device="cpu")
    for key in sb.INCIDENT_REQUIRED_KEYS:
        assert key in res, key
    assert res["mode"] == "incidents"
    assert res["captured"] == 0 and res["alert_rules"] == 1
    assert res["p99_incidents_on_ms"] > 0 and res["p99_incidents_off_ms"] > 0
    json.dumps(res)


def test_main_prints_one_json_line_for_a_fake_run(capsys):
    assert sb.main(["--device", "cpu", "--requests", "4", "--gap-ms", "0",
                    "--exec-ms", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert all(k in res for k in sb.REQUIRED_KEYS)
    assert res["mode"] == "fake" and res["requests"] == 4
    assert res["max_batch"] == 8 and res["timeout_ms"] == 10.0


#: (argv, the mode's function, the argument it must receive, its value)
PROCESS_FLAGS = [
    (["--fleet", "3"], "fleet_bench", "replicas", 3),
    (["--ramp"], "ramp_bench", "max_replicas", 3),
    (["--brownout"], "brownout_bench", "window_s", 3.0),
    (["--artifact-cold"], "artifact_cold_bench", "width_mult", 1.0),
    # the settings only the process modes read
    (["--fleet", "2", "--clients", "4"], "fleet_bench", "clients", 4),
    (["--ramp", "--clients", "5"], "ramp_bench", "burst_clients", 5),
    (["--ramp", "--max-replicas", "4"], "ramp_bench", "max_replicas", 4),
    (["--ramp", "--burst-s", "1.5"], "ramp_bench", "burst_s", 1.5),
    (["--ramp", "--idle-s", "3"], "ramp_bench", "idle_s", 3.0),
    (["--ramp", "--slope", "0.5"], "ramp_bench", "slope_threshold", 0.5),
    (["--brownout", "--window-s", "2"], "brownout_bench", "window_s", 2.0),
    (["--artifact-cold", "--width-mult", "0.5"], "artifact_cold_bench",
     "width_mult", 0.5),
]


@pytest.mark.parametrize("argv,fn,key,value", PROCESS_FLAGS,
                         ids=[" ".join(c[0]) for c in PROCESS_FLAGS])
def test_process_flags_reach_their_mode(argv, fn, key, value, monkeypatch,
                                        capsys):
    """Each process mode's flag runs its function, and each setting only
    those modes read reaches it; the other arguments are the JAX tool's
    command-line defaults (--fleet: its batcher's 8 / 10 ms / 10 ms;
    --ramp and --brownout: batch 2, exec 30 ms, flush 2 ms; the bucket
    64x64, the requests 48x96), with --device and the --set overrides."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return {"mode": fn}

    monkeypatch.setattr(sb, fn, fake)
    assert sb.main(["--device", "cpu", "--set", "serve.max_batch=4",
                    *argv]) == 0
    assert json.loads(capsys.readouterr().out) == {"mode": fn}
    assert seen[key] == value
    assert seen["device"] == "cpu"
    assert seen["overrides"] == ("serve.max_batch=4",)
    assert seen["bucket"] == (64, 64)
    shaped = {"max_batch": 2, "exec_ms": 30.0, "timeout_ms": 2.0,
              "native_hw": (48, 96)}
    want = {"fleet_bench": {"max_batch": 8, "exec_ms": 10.0,
                            "timeout_ms": 10.0, "requests": 64,
                            "native_hw": (48, 96)},
            "ramp_bench": shaped, "brownout_bench": shaped,
            "artifact_cold_bench": {"tiers": ("f32",)}}[fn]
    assert {k: seen[k] for k in want} == want


def test_set_flownet_c_real_run_through_the_plain_correlation():
    res = sb.serve_bench(requests=3, gap_ms=0.0, max_batch=2,
                         timeout_ms=5.0, bucket=(64, 64),
                         native_hw=(48, 64), fake=False, device="cpu",
                         overrides=("model=flownet_c", "corr_max_disp=4",
                                    "corr_stride=1"))
    for key in sb.REQUIRED_KEYS:
        assert key in res, key
    assert res["mode"] == "real" and res["errors"] == 0
    assert res["dispatches"] >= 2 and res["fake_exec_ms"] is None


def test_set_refuses_an_item_without_a_value():
    with pytest.raises(SystemExit, match="bad --set"):
        sb.main(["--device", "cpu", "--set", "width_mult"])
