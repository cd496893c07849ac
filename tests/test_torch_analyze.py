"""The verbs that read a run (`analyze`, `tail`) and the cross-process
trace merge (`obs/aggregate.py`) of the port against the JAX package's,
on run directories written here with the stdlib and on ones the port
writes itself (a two-step CPU fit; a stand-in engine's trace).

Equal means equal JSON. The fields that read the wall clock differ
between two calls and are named where they are dropped: the summary's
`last_record_age_s` and the heartbeat's `age_s` in `tail` (the
functions are compared at one `now`, where they agree), the fleet
children's `heartbeat_age_s` in `analyze`, and `path` in
`aggregate_run`'s summary (each package writes its own merged trace,
whose events are compared instead).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deepof_tpu import analyze as jax_analyze
from deepof_tpu import cli as jax_cli
from deepof_tpu.obs import aggregate as jax_aggregate
from deepof_tpu_torch import analyze, cli
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          ObsConfig, TrainConfig)
from deepof_tpu_torch.obs import aggregate, incident, trace
from deepof_tpu_torch.obs.export import LatencyHistogram

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
NOW = T0 + 100.0
#: the wall-clock fields of the verbs' output (see the module docstring)
CLOCK = ("last_record_age_s", "age_s", "heartbeat_age_s")


def _write(d, records=(), heartbeat=None):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
        f.write('{"kind": "train", "step": 9, "lo')  # a torn last line
    if heartbeat is not None:
        with open(os.path.join(d, "heartbeat.json"), "w") as f:
            json.dump(heartbeat, f)
    return d


def _hist(*ms):
    h = LatencyHistogram()
    for v in ms:
        h.observe(v / 1e3)
    return h.snapshot()


def _train_records():
    out = []
    for step in range(1, 9):
        out.append({
            "kind": "train", "step": step, "time": T0 + 2.0 * step,
            "loss": 10.0 / step if step != 5 else float("nan"),
            "lr": 1e-4, "steps_per_sec": 0.5 + 0.01 * step,
            "items_per_sec_per_chip": 4.0, "phase_assemble_s": 0.1 * step,
            "phase_dispatch_s": 0.3 * step, "starved": step // 3,
            "data_batches": step, "data_worker_util": 0.5,
            "skipped_updates": 1 if step > 4 else 0, "rollbacks": 0,
            "fault_decode": 2, "dev_mem_peak_bytes": 1000 + step,
            "rss_bytes": 5000, "model_tflops": 1.5,
            "loss_total_by_scale": [1.0, 2.0, 3.0],
            "recipe_stage": 1, "recipe_stages": 2, "recipe_advances": 1,
            "recipe_last_trigger": "steps",
            "recipe_draws_by_dataset": {"flyingchairs": step}})
        if step % 2 == 0:
            out.append({"kind": "eval", "step": step, "time": T0 + 2 * step,
                        "aee": 5.0 - 0.3 * step, "aae": 9.0})
    out += [{"kind": "info", "step": 0, "time": T0, "message": "hello"},
            {"kind": "warn", "step": 3, "time": T0 + 6, "message": "x" * 400},
            {"kind": "warn", "step": 4, "time": T0 + 8, "message": "w2"}]
    return out


def _serve_records(**extra):
    return [{"kind": "serve", "step": 0, "time": T0 + 50,
             "serve_requests": 10, "serve_responses": 9,
             "serve_latency_hist": _hist(3, 7, 40),
             "serve_slo": {"exhausted": False, "burn": 0.1},
             "serve_quality": {"exhausted": False, "ref_p50": 3.4},
             "fleet_requests": 12, "degrade_level": 0,
             "deadline_requests": 2, **extra},
            {"kind": "fleet", "time": T0 + 51, "event": "scale_up",
             "reason": "pressure", "replica": 1, "replicas_before": 1,
             "replicas_after": 2},
            {"kind": "elastic", "time": T0 + 52, "elastic_generation": 0}]


def _replica(d, index, rids, hist_ms, quality_exhausted=False):
    _write(d, [{"kind": "serve", "step": 0, "time": T0 + 40 + index,
                "serve_requests": len(rids), "serve_responses": len(rids),
                "serve_latency_hist": _hist(*hist_ms),
                "serve_max_queue_depth": 3 + index,
                "serve_requests_by_tier": {"f32": len(rids)},
                "serve_quality": {"exhausted": quality_exhausted},
                "serve_max_batch": 4}],
           heartbeat={"time": T0 + 45, "step": 0, "wedged": False,
                      "serve_requests": len(rids)})
    events = []
    for k, rid in enumerate(rids):
        events.append({"ph": "X", "name": "serve_enqueue", "ts": 100.0 * k,
                       "dur": 5.0, "pid": 99, "tid": 1,
                       "args": {"request_id": rid}})
    events.append({"ph": "X", "name": "serve_batch", "ts": 50.0, "dur": 300,
                   "pid": 99, "tid": 2, "args": {"request_ids": rids}})
    events.append({"ph": "X", "name": "serve_dispatch", "ts": 60.0,
                   "dur": 200.0, "pid": 99, "tid": 2,
                   "args": {"request_ids": rids + [7]}})
    with open(os.path.join(d, "trace.json"), "w") as f:
        json.dump({"traceEvents": events, "otherData": {
            "role": "replica", "index": index, "pid": 4000 + index,
            "trace_epoch_unix": T0 + 1.5 + index}}, f)


def _fleet_tree(root, quality_exhausted=False, evictions=0):
    rids = [[f"r1-{i}" for i in range(0, 4)], [f"r1-{i}" for i in (4, 5)]]
    _write(root, _serve_records(), heartbeat={
        "time": T0 + 60, "step": 0, "wedged": False,
        "fleet_replicas": 2, "fleet_evictions": evictions,
        "fleet_broken": 0, "fleet_slo": {"exhausted": False},
        "fleet_states": {"0": "ready", "1": "ready"}})
    route = [{"ph": "X", "name": "route", "ts": 10.0 + 90 * i, "dur": 400.0,
              "pid": 1, "tid": 3, "args": {"request_id": f"r1-{i}"}}
             for i in range(6)]
    with open(os.path.join(root, "trace.json"), "w") as f:
        json.dump({"traceEvents": route, "otherData": {
            "role": "router", "pid": 4100, "trace_epoch_unix": T0 + 1.0}}, f)
    for i in (0, 1):
        _replica(os.path.join(root, f"replica-{i}"), i, rids[i],
                 [5 * (i + 1), 30], quality_exhausted and i == 1)
    os.makedirs(os.path.join(root, "ckpt", "step_0000000001"))
    return root


def _dirs(tmp):
    """Every fixture directory, by name."""
    d = {}
    d["train"] = _write(str(tmp / "train"), _train_records(), heartbeat={
        "time": T0 + 20, "step": 8, "wedged": False, "wedges": 0,
        "last_step_age_s": 1.0, "heartbeat_period_s": 5.0,
        "skipped_updates": 4, "data_retries": 1,
        "recipe_stage": 1, "recipe_advances": 1})
    d["serve"] = _write(str(tmp / "serve"), _serve_records(), heartbeat={
        "time": T0 + 55, "serve_requests": 11,
        "serve_slo": {"exhausted": False}})
    d["fleet"] = _fleet_tree(str(tmp / "fleet"))
    d["empty"] = _write(str(tmp / "empty"))
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _dirs(tmp_path_factory.mktemp("runs"))


def _drop(obj, keys=CLOCK):
    if isinstance(obj, dict):
        return {k: _drop(v, keys) for k, v in obj.items() if k not in keys}
    if isinstance(obj, list):
        return [_drop(v, keys) for v in obj]
    return obj


def _json(obj):
    return json.loads(json.dumps(obj))


@pytest.mark.parametrize("name", ["train", "serve", "fleet", "empty"])
def test_summarize_and_tail_summary_match_jax(runs, name):
    d = runs[name]
    records = analyze.load_records(d)
    assert records == jax_analyze.load_records(d)
    assert _json(analyze.summarize(records)) == \
        _json(jax_analyze.summarize(records))
    for fleet in (False, True):
        for recent in (2, 10):
            got = analyze.tail_summary(d, recent=recent, now=NOW,
                                       fleet=fleet)
            want = jax_analyze.tail_summary(d, recent=recent, now=NOW,
                                            fleet=fleet)
            assert _json(got) == _json(want)
    assert _json(analyze.aggregate_processes(d, now=NOW)) == \
        _json(jax_analyze.aggregate_processes(d, now=NOW))


@pytest.mark.parametrize("name", ["train", "serve", "fleet"])
def test_analyze_matches_jax(runs, name):
    got = analyze.analyze(runs[name], plot=False)
    want = jax_analyze.analyze(runs[name], plot=False)
    assert _drop(_json(got)) == _drop(_json(want))
    if name == "fleet":
        assert set(got["processes"]) == {"replica-0", "replica-1"}
        assert got["merged"]["requests"] == 6  # 4 + 2, summed
        assert got["merged"]["max_queue_depth"] == 4
    if name == "train":
        assert got["recipe"]["draws_by_dataset"] == {"flyingchairs": 8}
        assert got["non_finite_train_records"] == 1
        assert got["eval_trend"]["window"] == 4


def test_aggregate_run_matches_jax(runs, tmp_path):
    d = runs["fleet"]
    assert aggregate.discover_processes(d) == \
        jax_aggregate.discover_processes(d)
    got = aggregate.aggregate_run(d, str(tmp_path / "port.json"))
    want = jax_aggregate.aggregate_run(d, str(tmp_path / "jax.json"))
    assert _drop(got, ("path",)) == _drop(want, ("path",))
    with open(got["path"]) as f:
        merged = json.load(f)
    with open(want["path"]) as f:
        assert merged == json.load(f)
    # one track a process, six routed ids chained into the replicas
    assert [p["name"] for p in got["processes"]] == [
        "router", "replica-0", "replica-1"]
    assert got["requests_correlated"] == 6
    assert aggregate.per_process_table(got["path"]) == \
        jax_aggregate.per_process_table(want["path"])
    assert aggregate.per_request_table(got["path"], 5) == \
        jax_aggregate.per_request_table(want["path"], 5)


# ------------------------------------------------------ tail's codes


def _code_dir(tmp, code: int) -> tuple[str, list]:
    d = str(tmp / f"rc{code}")
    hb = {"time": T0 + 20, "step": 3, "wedged": code == 3}
    records = _train_records()[:4]
    flags = []
    if code == 4:
        hb["fleet_evictions"] = 1
    if code == 5:
        hb["elastic_reforms"] = 1
    if code == 6:
        records += _serve_records(serve_slo={"exhausted": True})
    if code == 7:
        _fleet_tree(d, quality_exhausted=True)
        return d, ["--fleet"]
    if code == 10:
        hb["degrade_l3_sustained"] = True
    _write(d, records, hb)
    if code in (0, 9):
        incident.record_offline(d, "nan_rollback", "warn")
    if code == 9:
        incident.record_offline(d, "quality_drift", "critical")
    return d, flags


@pytest.mark.parametrize("code", [0, 3, 4, 5, 6, 7, 9, 10])
def test_tail_exit_codes_match_jax(tmp_path, capsys, code):
    d, flags = _code_dir(tmp_path, code)
    got = cli.main(["tail", "--log-dir", d, *flags])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = jax_cli.main(["tail", "--log-dir", d, *flags])
    want_line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == want == code
    assert _drop(line) == _drop(want_line)
    if code == 9:
        # acknowledged, the bundle no longer holds the code
        assert cli.main(["incidents", "ack", "--log-dir", d]) == 0
        capsys.readouterr()
        assert cli.main(["tail", "--log-dir", d]) == \
            jax_cli.main(["tail", "--log-dir", d]) == 0
        capsys.readouterr()
    if code == 7:  # the quality verdict lives in replica-1's dir
        assert cli.main(["tail", "--log-dir", d]) == \
            jax_cli.main(["tail", "--log-dir", d]) == 0
        capsys.readouterr()


def test_the_verbs_refuse_the_ledger_naming_item_8(runs, tmp_path, capsys):
    with pytest.raises(NotImplementedError, match="item 8"):
        cli.main(["tail", "--log-dir", runs["train"], "--ledger-baseline",
                  str(tmp_path / "b.jsonl")])
    with pytest.raises(NotImplementedError, match="item 8"):
        cli.main(["tail", "--log-dir", runs["train"],
                  "--ledger-memory-factor", "1.5"])
    for where in ("", "replica-0"):
        d = _fleet_tree(str(tmp_path / f"ledger{where}"))
        with open(os.path.join(d, where, "ledger.jsonl"), "w") as f:
            f.write("{}\n")
        for argv in (["tail", "--log-dir", d, "--fleet"],
                     ["analyze", "--log-dir", d, "--no-plot"]):
            with pytest.raises(SystemExit, match="item 8"):
                cli.main(argv)
    d = _write(str(tmp_path / "base"), _train_records())
    open(os.path.join(d, "ledger_baseline.jsonl"), "w").close()
    with pytest.raises(SystemExit, match="item 8"):
        cli.main(["tail", "--log-dir", d])
    with pytest.raises(SystemExit, match="no metrics.jsonl"):
        cli.main(["analyze", "--log-dir", str(tmp_path / "none")])


def test_analyze_and_tail_import_no_torch(runs):
    """The verbs that read a run never import torch (a CUDA context next
    to a live trainer), in a process where importing it raises."""
    script = textwrap.dedent(f"""
        import contextlib, io, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("torch", "jax", "deepof_tpu"):
                    raise ImportError(f"blocked import: {{name}}")
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {ROOT!r})
        from deepof_tpu_torch import cli

        codes = []
        for argv in (["analyze", "--log-dir", {runs["fleet"]!r}],
                     ["tail", "--log-dir", {runs["fleet"]!r}, "--fleet"],
                     ["tail", "--log-dir", {runs["train"]!r}],
                     ["incidents", "list", "--log-dir", {runs["train"]!r}]):
            with contextlib.redirect_stdout(io.StringIO()):
                codes.append(cli.main(argv))
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("torch", "jax"))
        print(codes, leaked)
    """)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[0, 0, 0, 2] []"


# ----------------------------------------- directories the port writes


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A two-step CPU fit of the port with the tracer and the heartbeat
    on, and a fake-executor engine's trace in a replica dir beside it."""
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.train.loop import Trainer

    root = tmp_path_factory.mktemp("port")
    log_dir = str(root / "run")
    cfg = ExperimentConfig(
        width_mult=0.125,
        data=DataConfig(dataset="synthetic", image_size=(32, 32),
                        gt_size=(32, 32), batch_size=2),
        train=TrainConfig(log_dir=log_dir, log_every=1, eval_every=2,
                          eval_batch_size=2),
        obs=ObsConfig(trace=True, heartbeat=True))
    out = Trainer(cfg, dataset=SyntheticData(cfg.data, num_val=2),
                  device="cpu").fit(max_steps=2)
    return log_dir, out


def test_analyze_and_tail_of_a_port_run_match_jax(port_run, capsys):
    log_dir, out = port_run
    got = analyze.analyze(log_dir, plot=False)
    want = jax_analyze.analyze(log_dir, plot=False)
    assert _json(got) == _json(want)
    assert got["train"]["steps"] == 2 and got["eval"]["evals"] == 1
    assert _json(analyze.tail_summary(log_dir, now=NOW)) == \
        _json(jax_analyze.tail_summary(log_dir, now=NOW))
    assert cli.main(["tail", "--log-dir", log_dir]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["heartbeat"]["step"] == line["step"] == 2
    assert out["steps_per_sec"] > 0
    # the synthetic dataset's zeroed cache counters ride the train
    # records, as the JAX package's do (a key the port's records lacked)
    trains = [r for r in analyze.load_records(log_dir)
              if r["kind"] == "train"]
    assert [r["decode_cache_hits"] for r in trains] == [0, 0]


def test_engine_spans_carry_request_ids_into_the_merge(tmp_path):
    """A replica's serve_* spans carry the request ids the router put
    in X-Request-Id (the enqueue its own, the batch and the dispatch
    the batch's), so `aggregate_run` chains each routed request from the
    router's `route` span into the replica's spans."""
    from deepof_tpu_torch.core.config import ServeConfig
    from deepof_tpu_torch.serve.engine import InferenceEngine

    root = str(tmp_path / "fleet")
    replica = os.path.join(root, "replica-0")
    os.makedirs(replica)
    cfg = ExperimentConfig(
        model="flownet_s", data=DataConfig(image_size=(32, 32)),
        serve=ServeConfig(max_batch=4, batch_timeout_ms=200.0,
                          fake_exec_ms=2.0))
    tracer = trace.Tracer(path=os.path.join(replica, "trace.json"),
                          role="replica", index=0)
    rids = [f"router-1-{i}" for i in range(3)]
    rs = np.random.RandomState(0)
    with trace.installed(tracer):
        with InferenceEngine(cfg, device="cpu") as eng:
            futs = [eng.submit(rs.randint(0, 255, (32, 32, 3), np.uint8),
                               rs.randint(0, 255, (32, 32, 3), np.uint8),
                               request_id=rid) for rid in rids]
            assert [f.result(timeout=60)["request_id"] for f in futs] == rids
    tracer.flush()
    router = trace.Tracer(path=os.path.join(root, "trace.json"),
                          role="router")
    with trace.installed(router):
        for rid in rids:
            with trace.span("route", request_id=rid):
                pass
    router.flush()
    with open(os.path.join(replica, "trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    enq = [e["args"]["request_id"] for e in spans
           if e["name"] == "serve_enqueue"]
    assert enq == rids
    batched = {r for e in spans if e["name"] in ("serve_batch",
                                                  "serve_dispatch")
               for r in e["args"].get("request_ids", [])}
    assert batched == set(rids)
    got = aggregate.aggregate_run(root, str(tmp_path / "p.json"))
    want = jax_aggregate.aggregate_run(root, str(tmp_path / "j.json"))
    assert _drop(got, ("path",)) == _drop(want, ("path",))
    assert got["requests_correlated"] == 3
