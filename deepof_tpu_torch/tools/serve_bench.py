"""Headless serving benchmark: requests/s and latency percentiles against
an in-process InferenceEngine (port of the engine modes of the JAX
package's `tools/serve_bench.py`; no HTTP, no checkpoint needed).

Each mode prints one JSON line with the JAX tool's keys (the
`*_REQUIRED_KEYS` tuples below):

  default    open-loop arrivals (one request every --gap-ms) through the
             dynamic micro-batcher: requests/s, p50/p99 latency,
             dispatches, mean occupancy. `--fake` (the default) is a
             timed executor that sleeps --exec-ms a dispatch and returns
             the pair's channel differences (`make_fake_forward`);
             `--real` runs the config's model on its seeded init, or on
             --log-dir's newest verified checkpoint. `--serial` runs the
             same workload through a max_batch=1 engine as well and
             reports `speedup_vs_serial`.
  --stream   a closed-loop video walk as a session (`submit_next`, one
             decode a frame) and as the pairwise walk (two decodes a
             pair) through fake-executor engines whose decode sleeps
             --decode-ms: `stream_speedup`, the decode counts, and
             `flow_bitwise_equal`. It carries the warm-start block
             (`warm_stream_bench`): a real FlowNet-S at width 0.5 walking
             one seeded coherent frame sequence through two session
             engines that differ only in `serve.session.warm_start`,
             interleaved step by step: `warm_speedup` (the ratio of
             median step latencies) and `epe_vs_cold`. --warm-frames 0
             skips it (its keys are then null).
  --precision  the precision tiers through one real-model engine: per
             tier requests/s, p50/p99, the tier's weight bytes
             (`serve/quant.py::params_nbytes`) and `epe_vs_f32`.
  --quality  the label-free quality proxies (obs/quality.py) per tier at
             sample rate 1.0, then the scorer's cost: the f32 workload
             with scoring off and at --quality-rate.
  --ledger   the executable ledger (obs/ledger.py): the lattice's rows
             read back from `<run dir>/ledger.jsonl` (the engine is given
             the run directory as its `ledger_dir`; rows older than this
             run are left out), and its cost as a p99 pair, ledger off
             and on.
  --incidents  the incident recorder's cost (obs/incident.py): the same
             workload with `obs.incidents` off and on, an idle recorder
             with one rule that never fires.

The process modes run the `serve` command line's fleet in processes of
their own: fake-executor replicas (`serve.fake_exec_ms`; each a `python
-m deepof_tpu_torch serve --config-json ... --device <device>` process,
`serve/fleet.py::Fleet`) behind the router (`serve/router.py`), driven
over HTTP by closed-loop clients in this process:

  --fleet N  N replicas against one under the same closed-loop load
             (--clients): `speedup_vs_single`, sheds, failovers, and the
             router's /metrics read back through `parse_prometheus`.
  --ramp     the autoscaler (`serve/autoscale.py`) through warm, burst,
             scaled-burst and idle phases (--clients, --max-replicas,
             --burst-s, --idle-s), then two fresh fleets under a ramped
             drive, the load-slope signal armed at --slope against the
             reactive one: sheds before and after the scale-up, drops,
             scale events, `predictive_shed_delta`.
  --brownout the same mixed-priority overload against two fresh fleets,
             the degrade controller (`serve/degrade.py`) off and on
             (--window-s): `default_shed_delta`, L3 sheds, downgrades.
  --artifact-cold  a cold engine's `warm()` with the artifact store off,
             on without its index, and on with it (`artifact_cold_bench`
             says what each leg times in the port; --width-mult).

Beside the JAX tool's flags: `--device` (default cuda, which raises
without a card; cpu runs the plain PyTorch path and the replicas on the
CPU) and `--set SECTION.FIELD=VALUE` (repeatable), applied after the
bench's own config as the `train` and `serve` verbs apply it. Every
function takes the same as `device=` and `overrides=`, and the engine
modes' `model=` (and `refine=` where a warm stage runs): an nn.Module
with its weights in place of the seeded init.

Kernels. At the defaults (FlowNet-S at width 0.25) the default mode,
--precision, --ledger and --incidents launch no kernel on the card, and
no process mode launches one but --artifact-cold, whose warm runs the
lattice's forwards (with `--set model=flownet_c`, the correlation):
FlowNet-S has no correlation and serves no warp. The warm walk's warm
steps run `FlowNetRefine`, one launch of the warp kernel a warm
dispatch (`warp_fwd`); the quality scorer is one launch a scored
request (`warp_fwd_quality`). With `--set model=flownet_c`, each cold
dispatch launches the correlation kernel once (`corr`).

Run: python -m deepof_tpu_torch.tools.serve_bench [--requests 64]
         [--gap-ms 1] [--max-batch 8] [--timeout-ms 10] [--exec-ms 10]
         [--serial] [--device cpu]
     python -m deepof_tpu_torch.tools.serve_bench --stream --device cpu
     python -m deepof_tpu_torch.tools.serve_bench --real --set \\
         model=flownet_c --set width_mult=1.0 --bucket 384x512 \\
         --native 384x512 --max-batch 8 --serial
     python -m deepof_tpu_torch.tools.serve_bench --fleet 2 [--clients 8]
     python -m deepof_tpu_torch.tools.serve_bench --ramp --device cpu
     python -m deepof_tpu_torch.tools.serve_bench --artifact-cold \\
         --set model=flownet_c --set width_mult=1.0 --bucket 384x512
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time

import numpy as np

from ..cli import apply_sets
from ..core.config import get_config
from ..predict import restore_params
from ..serve.engine import (InferenceEngine, build_serve_model,
                            make_fake_forward)

#: keys every serve_bench JSON result carries
REQUIRED_KEYS = (
    "mode", "requests", "errors", "wall_s", "requests_per_s",
    "latency_p50_ms", "latency_p99_ms", "dispatches", "occupancy_mean",
    "max_batch", "timeout_ms", "gap_ms",
)

#: keys every --stream result carries; the warm_* block and epe_vs_cold
#: are the warm-start walk's
STREAM_REQUIRED_KEYS = (
    "mode", "frames", "flows", "errors", "wall_s", "frames_per_s",
    "pairwise_wall_s", "pairwise_frames_per_s", "stream_speedup",
    "stream_decodes", "pairwise_decodes", "decode_delta", "decode_saved",
    "flow_bitwise_equal", "latency_p50_ms", "latency_p99_ms",
    "max_batch", "timeout_ms", "decode_ms", "fake_exec_ms", "bucket",
    "warm_speedup", "epe_vs_cold", "warm_frames", "warm_steps",
    "warm_cold_fallbacks", "warm_width", "warm_bucket",
    "warm_latency_p50_ms", "warm_cold_latency_p50_ms",
)

#: keys every --precision result carries at the top level ...
PRECISION_REQUIRED_KEYS = (
    "mode", "requests", "max_batch", "timeout_ms", "gap_ms", "bucket",
    "precisions", "tiers",
)
#: ... and per tier inside result["tiers"][<tier>]
TIER_REQUIRED_KEYS = (
    "requests_per_s", "latency_p50_ms", "latency_p99_ms", "epe_vs_f32",
    "errors", "wall_s", "weight_bytes",
)

#: keys every --ledger result carries: the lattice's rows read back from
#: the recorded ledger.jsonl, and the ledger's cost as a p99 pair
LEDGER_REQUIRED_KEYS = (
    "mode", "requests", "max_batch", "timeout_ms", "gap_ms", "bucket",
    "lowerings", "compile_s_total", "mfu_nominal", "recompiles",
    "cache_hits", "cache_misses", "executables",
    "rps_ledger_off", "rps_ledger_on",
    "p99_ledger_off_ms", "p99_ledger_on_ms", "p99_overhead_pct",
)

#: keys every --incidents result carries: the idle recorder's cost as a
#: p99 pair
INCIDENT_REQUIRED_KEYS = (
    "mode", "requests", "max_batch", "timeout_ms", "gap_ms", "bucket",
    "alert_rules", "captured", "rps_incidents_off", "rps_incidents_on",
    "p99_incidents_off_ms", "p99_incidents_on_ms", "p99_overhead_pct",
)

#: keys every --quality result carries at the top level ...
QUALITY_REQUIRED_KEYS = (
    "mode", "requests", "max_batch", "timeout_ms", "gap_ms", "bucket",
    "precisions", "tiers", "quality", "sample_rate",
    "rps_quality_off", "rps_quality_on", "scorer_overhead_pct",
    "p99_quality_off_ms", "p99_quality_on_ms", "p99_overhead_pct",
)
#: ... and per tier inside result["tiers"][<tier>]
QUALITY_TIER_REQUIRED_KEYS = ("photo", "smooth", "census", "scored")

#: keys every --fleet result carries
FLEET_REQUIRED_KEYS = (
    "mode", "replicas", "clients", "requests", "errors", "wall_s",
    "requests_per_s", "single_wall_s", "single_requests_per_s",
    "speedup_vs_single", "failovers", "shed", "max_batch", "fake_exec_ms",
)

#: keys every --ramp result carries: the floor pool sheds under the
#: burst (sheds_burst > 0), scales up, the scaled pool sheds about none
#: (sheds_after_scale), sustained idle scales it down (retired ==
#: scale_downs, evictions 0), and every admitted request gets a reply
#: (drops 0)
RAMP_REQUIRED_KEYS = (
    "mode", "min_replicas", "max_replicas", "burst_clients", "phases",
    "requests", "requests_per_s", "errors", "drops", "sheds_burst",
    "sheds_after_scale", "scale_ups", "scale_downs", "retired",
    "evictions", "peak_replicas", "final_replicas", "scale_up_latency_s",
    "scale_up_to_first_response_ms", "predictive_sheds", "reactive_sheds",
    "predictive_shed_delta", "autoscale_up_slope",
    "wall_s", "max_batch", "fake_exec_ms", "max_in_flight",
)

#: keys every --artifact-cold result carries (the JAX tool's names;
#: `artifact_cold_bench` says what each leg times in the port)
ARTIFACT_COLD_REQUIRED_KEYS = (
    "mode", "model", "width_mult", "bucket", "tiers", "ladder",
    "publish_wall_s", "publish_compile_s", "warm_wall_compile_s",
    "warm_wall_artifact_s", "warm_wall_index_s", "cold_start_speedup",
    "fingerprint_boot_speedup", "index_vs_artifact_speedup",
    "acquire_compile_s", "acquire_fetch_s", "acquire_speedup",
    "artifact_hits", "artifact_misses", "artifact_rejects",
    "index_hits", "index_misses", "index_rejects",
    "store_entries", "store_bytes",
)

#: keys every --brownout result carries: the same overload against two
#: fresh two-replica fleets, the controller off and on; with it on no
#: default-priority request is shed in the counted window
BROWNOUT_REQUIRED_KEYS = (
    "mode", "replicas", "default_clients", "low_clients", "window_s",
    "max_batch", "fake_exec_ms", "max_in_flight",
    "default_sheds_off", "default_sheds_on", "default_shed_delta",
    "shed_low_on", "max_level_on", "transitions_on",
    "tier_downgrades_on", "bucket_downgrades_on",
    "p99_default_off_ms", "p99_default_on_ms",
    "low_ok_off", "low_ok_on", "drops", "wall_s",
)


def _bench_cfg(bucket: tuple[int, int], max_batch: int, timeout_ms: float,
               log_dir: str | None, overrides=()):
    """The bench's config: the flyingchairs preset with FlowNet-S at
    width 0.25 on the synthetic dataset at `bucket`, then `overrides`."""
    cfg = get_config("flyingchairs")
    cfg = cfg.replace(
        model="flownet_s", width_mult=0.25,
        data=dataclasses.replace(cfg.data, dataset="synthetic",
                                 image_size=bucket, gt_size=bucket),
        serve=dataclasses.replace(cfg.serve, max_batch=max_batch,
                                  batch_timeout_ms=timeout_ms),
        train=dataclasses.replace(cfg.train, eval_amplifier=1.0,
                                  eval_clip=(-1e4, 1e4)))
    if log_dir:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    log_dir=log_dir))
    return apply_sets(cfg, overrides)


def _real_model(cfg, device: str = "cuda", log_dir: str | None = None):
    """The serving model of `cfg` on `device`: the newest verified
    checkpoint of `log_dir` when given, else `build_serve_model`'s init
    from `cfg.train.seed` (the engine's own default). Built once, so the
    engines of a mode share its weights."""
    if log_dir:
        return restore_params(cfg, device)
    return build_serve_model(cfg, device)


def _pairs(requests: int, native_hw: tuple[int, int]) -> list:
    """The seeded request pairs every mode sends (the JAX tool's draws)."""
    rng = np.random.RandomState(0)
    return [(rng.randint(0, 255, (*native_hw, 3), dtype=np.uint8),
             rng.randint(0, 255, (*native_hw, 3), dtype=np.uint8))
            for _ in range(max(int(requests), 1))]


def _epe_mean(flows: list, refs: list):
    """Mean over the pairs of each flow's mean endpoint error against its
    reference (None when no pair has both)."""
    deltas = [float(np.mean(np.sqrt(np.sum((a - b) ** 2, -1))))
              for a, b in zip(flows, refs)
              if a is not None and b is not None]
    return round(float(np.mean(deltas)), 6) if deltas else None


def run_workload(engine: InferenceEngine, requests: list, gap_ms: float,
                 precision: str | None = None):
    """Open-loop arrival: submit with a fixed inter-arrival gap, then
    wait for every future. Returns (wall_s, errors, results)."""
    t0 = time.perf_counter()
    futures = []
    for prev, nxt in requests:
        futures.append(engine.submit(prev, nxt, precision=precision))
        if gap_ms > 0:
            time.sleep(gap_ms / 1e3)
    results, errors = [], 0
    for fut in futures:
        try:
            results.append(fut.result(timeout=120.0))
        except Exception:  # noqa: BLE001 - counted, benchmark continues
            errors += 1
            results.append(None)
    return time.perf_counter() - t0, errors, results


def serve_bench(requests: int = 64, gap_ms: float = 1.0, max_batch: int = 8,
                timeout_ms: float = 10.0, exec_ms: float = 10.0,
                bucket: tuple[int, int] = (64, 64),
                native_hw: tuple[int, int] = (48, 96), fake: bool = True,
                log_dir: str | None = None, serial: bool = False,
                device: str = "cuda", model=None, overrides=()) -> dict:
    cfg = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    pairs = _pairs(requests, native_hw)

    if fake:
        make_engine = lambda c: InferenceEngine(  # noqa: E731
            c, forward_fn=make_fake_forward(exec_ms), device=device)
        mode = "fake"
    else:
        if model is None:
            model = _real_model(cfg, device, log_dir)
        make_engine = lambda c: InferenceEngine(  # noqa: E731
            c, model=model, device=device)
        mode = "real"

    with make_engine(cfg) as engine:
        engine.warm()
        wall, errors, _ = run_workload(engine, pairs, gap_ms)
        stats = engine.stats()

    out = {
        "mode": mode, "requests": len(pairs), "errors": errors,
        "wall_s": round(wall, 4),
        "requests_per_s": round((len(pairs) - errors) / wall, 2),
        "latency_p50_ms": stats["serve_latency_p50_ms"],
        "latency_p99_ms": stats["serve_latency_p99_ms"],
        "dispatches": stats["serve_batches"],
        "occupancy_mean": stats["serve_occupancy_mean"],
        "max_batch": max_batch, "timeout_ms": timeout_ms, "gap_ms": gap_ms,
        "fake_exec_ms": exec_ms if fake else None,
        "bucket": list(bucket),
    }
    if serial:
        scfg = cfg.replace(serve=dataclasses.replace(cfg.serve, max_batch=1))
        with make_engine(scfg) as eng1:
            eng1.warm()
            swall, serr, _ = run_workload(eng1, pairs, gap_ms)
        out["serial_wall_s"] = round(swall, 4)
        out["serial_requests_per_s"] = round((len(pairs) - serr) / swall, 2)
        out["speedup_vs_serial"] = round(swall / wall, 2) if wall > 0 else None
    return out


# ------------------------------------------------------------ stream


def _instrument_decode(engine, decode_ms: float, counter: dict) -> None:
    """Wrap the engine's decode with a per-decode delay and a call
    counter: the stand-in for a real image decode and preprocess (the
    bench's arrays decode in microseconds, which would hide the work the
    session cache halves)."""
    orig = engine._decode

    def decode(img):
        counter["n"] += 1
        if decode_ms > 0:
            time.sleep(decode_ms / 1e3)
        return orig(img)

    engine._decode = decode


def stream_bench(frames: int = 32, decode_ms: float = 20.0,
                 exec_ms: float = 2.0, max_batch: int = 4,
                 timeout_ms: float = 2.0, bucket: tuple[int, int] = (32, 64),
                 native_hw: tuple[int, int] = (30, 60),
                 warm_frames: int = 16, warm_width: float = 0.5,
                 warm_bucket: tuple[int, int] = (64, 128),
                 warm_native: tuple[int, int] = (60, 120),
                 log_dir: str | None = None, device: str = "cuda",
                 model=None, refine=None, overrides=()) -> dict:
    """Closed-loop video walk, streamed against pairwise (module
    docstring). Both walks drive one frame sequence through engines
    configured alike with the same decode delay; the session cache is
    the only difference, so `stream_speedup` is the one-decode-a-frame
    gain. The result carries the `warm_*` block of `warm_stream_bench`
    (its own engines and bucket; `model` and `refine` go there)."""
    cfg = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    rng = np.random.RandomState(0)
    frames = max(int(frames), 2)
    imgs = [rng.randint(1, 255, (*native_hw, 3), dtype=np.uint8)
            for _ in range(frames)]

    def walk_pairwise():
        counter = {"n": 0}
        flows, errors = [], 0
        with InferenceEngine(cfg, forward_fn=make_fake_forward(exec_ms),
                             device=device) as engine:
            engine.warm()
            _instrument_decode(engine, decode_ms, counter)
            t0 = time.perf_counter()
            for prev, nxt in zip(imgs, imgs[1:]):
                try:
                    flows.append(engine.submit(prev, nxt).result(
                        timeout=120.0)["flow"])
                except Exception:  # noqa: BLE001 - counted
                    errors += 1
                    flows.append(None)
            wall = time.perf_counter() - t0
        return wall, errors, flows, counter["n"], None

    def walk_stream():
        counter = {"n": 0}
        flows, errors = [], 0
        with InferenceEngine(cfg, forward_fn=make_fake_forward(exec_ms),
                             device=device) as engine:
            engine.warm()
            _instrument_decode(engine, decode_ms, counter)
            t0 = time.perf_counter()
            primed = engine.submit_next("bench", imgs[0]).result(
                timeout=120.0)
            assert primed.get("primed"), primed
            for frame in imgs[1:]:
                try:
                    flows.append(engine.submit_next("bench", frame).result(
                        timeout=120.0)["flow"])
                except Exception:  # noqa: BLE001 - counted
                    errors += 1
                    flows.append(None)
            wall = time.perf_counter() - t0
            stats = engine.stats()
        return wall, errors, flows, counter["n"], stats

    pw_wall, pw_err, pw_flows, pw_decodes, _ = walk_pairwise()
    st_wall, st_err, st_flows, st_decodes, st_stats = walk_stream()
    if warm_frames > 0:
        warm = warm_stream_bench(frames=warm_frames, warm_width=warm_width,
                                 bucket=warm_bucket, native_hw=warm_native,
                                 log_dir=log_dir, device=device, model=model,
                                 refine=refine, overrides=overrides)
    else:
        # --warm-frames 0: no real-model walk; its keys stay, as nulls
        warm = {k: None for k in STREAM_REQUIRED_KEYS
                if k.startswith(("warm_", "epe_"))}

    n_flows = frames - 1
    equal = bool(pw_flows and len(pw_flows) == len(st_flows) and all(
        a is not None and b is not None and np.array_equal(a, b)
        for a, b in zip(pw_flows, st_flows)))
    st_rate = ((n_flows - st_err) / st_wall) if st_wall > 0 else None
    pw_rate = ((n_flows - pw_err) / pw_wall) if pw_wall > 0 else None
    return {
        "mode": "stream", "frames": frames, "flows": n_flows,
        "errors": st_err, "wall_s": round(st_wall, 4),
        "frames_per_s": round(st_rate, 2) if st_rate else None,
        "pairwise_errors": pw_err,
        "pairwise_wall_s": round(pw_wall, 4),
        "pairwise_frames_per_s": round(pw_rate, 2) if pw_rate else None,
        "stream_speedup": (round(st_rate / pw_rate, 2)
                           if st_rate and pw_rate else None),
        # the decode counts: N for the stream, 2(N-1) pairwise
        "stream_decodes": st_decodes,
        "pairwise_decodes": pw_decodes,
        "decode_delta": pw_decodes - st_decodes,
        "decode_saved": st_stats["serve_sessions_decode_saved"],
        "flow_bitwise_equal": equal,
        "latency_p50_ms": st_stats["serve_session_latency_p50_ms"],
        "latency_p99_ms": st_stats["serve_session_latency_p99_ms"],
        "session_frames": st_stats["serve_sessions_frames"],
        "max_batch": max_batch, "timeout_ms": timeout_ms,
        "decode_ms": decode_ms, "fake_exec_ms": exec_ms,
        "bucket": list(bucket),
        **warm,
    }


# ------------------------------------------------------ warm-start


def _coherent_walk(rng, native_hw: tuple[int, int], frames: int,
                   noise: int = 6) -> list:
    """A temporally coherent seeded frame walk: every frame is one base
    image under small independent pixel noise, the stand-in for
    consecutive video frames (on iid frames `epe_vs_cold` would measure
    noise, not the warm path)."""
    base = rng.randint(1, 255, (*native_hw, 3)).astype(np.int16)
    return [np.clip(base + rng.randint(-noise, noise + 1, base.shape),
                    0, 255).astype(np.uint8) for _ in range(frames)]


def warm_stream_bench(frames: int = 16, warm_width: float = 0.5,
                      max_batch: int = 1, model_width: float = 0.5,
                      bucket: tuple[int, int] = (64, 128),
                      native_hw: tuple[int, int] = (60, 120),
                      log_dir: str | None = None, device: str = "cuda",
                      model=None, refine=None, overrides=()) -> dict:
    """Temporal warm start against cold on the real model (FlowNet-S,
    its seeded init, --log-dir's checkpoint, or `model`): one seeded
    coherent frame walk through two session engines that differ only in
    `serve.session.warm_start`. Cold runs the full network every step;
    warm runs the refinement stage (`refine`, else the engine's seeded
    one) once the session holds a prior flow. The walks interleave step
    by step, the order alternating, so host noise hits both alike;
    `warm_speedup` is the ratio of the median step latencies and
    `epe_vs_cold` the mean endpoint error of the warm flows against the
    cold ones of the same steps.

    model_width: the cold network's width, 0.5 (not 0.25): the
    refinement stage's width is model_width x warm_width, and at 0.25
    `scaled_width`'s floor of 8 channels would clip its cut."""
    frames = max(int(frames), 3)
    cfg = _bench_cfg(bucket, max_batch, 0.0, log_dir)
    cfg = apply_sets(cfg.replace(width_mult=model_width), overrides)

    def _session_cfg(warm: bool):
        return cfg.replace(serve=dataclasses.replace(
            cfg.serve, session=dataclasses.replace(
                cfg.serve.session, warm_start=warm,
                warm_width=warm_width)))

    if model is None:
        model = _real_model(_session_cfg(True), device, log_dir)
    rng = np.random.RandomState(0)
    imgs = _coherent_walk(rng, native_hw, frames)

    def step(engine, frame, flows, lats, errs):
        try:
            r = engine.submit_next("warm-bench", frame).result(120.0)
            flows.append(r["flow"])
            lats.append(r["latency_s"])
        except Exception:  # noqa: BLE001 - counted
            errs.append(1)
            flows.append(None)

    cold_flows, cold_lats, cold_errs = [], [], []
    warm_flows, warm_lats, warm_errs = [], [], []
    with InferenceEngine(_session_cfg(False), model=model,
                         device=device) as cold_eng, \
            InferenceEngine(_session_cfg(True), model=model, refine=refine,
                            device=device) as warm_eng:
        cold_eng.warm()
        warm_eng.warm()  # both lattices run once before timing
        assert cold_eng.submit_next("warm-bench",
                                    imgs[0]).result(120.0).get("primed")
        assert warm_eng.submit_next("warm-bench",
                                    imgs[0]).result(120.0).get("primed")
        t0 = time.perf_counter()
        for i, frame in enumerate(imgs[1:]):
            order = ((cold_eng, cold_flows, cold_lats, cold_errs),
                     (warm_eng, warm_flows, warm_lats, warm_errs))
            for eng, flows, lats, errs in (order if i % 2 == 0
                                           else order[::-1]):
                step(eng, frame, flows, lats, errs)
        wall = time.perf_counter() - t0
        warm_stats = warm_eng.stats()
    cold_err, warm_err = len(cold_errs), len(warm_errs)

    med_warm = float(np.median(warm_lats)) if warm_lats else None
    med_cold = float(np.median(cold_lats)) if cold_lats else None
    return {
        "warm_frames": frames,
        "warm_errors": warm_err,
        "warm_cold_errors": cold_err,  # the cold reference walk's errors
        # one wall: the walks interleave in one window
        "warm_wall_s": round(wall, 4),
        "warm_latency_p50_ms": (round(1e3 * med_warm, 3)
                                if med_warm else None),
        "warm_cold_latency_p50_ms": (round(1e3 * med_cold, 3)
                                     if med_cold else None),
        "warm_speedup": (round(med_cold / med_warm, 2)
                         if med_warm and med_cold else None),
        "epe_vs_cold": _epe_mean(warm_flows, cold_flows),
        "warm_steps": warm_stats["serve_sessions_warm_steps"],
        "warm_cold_fallbacks": warm_stats["serve_sessions_cold_fallbacks"],
        "warm_width": warm_width,
        "warm_model_width": model_width,
        "warm_bucket": list(bucket),
    }


# --------------------------------------------------------- precision


def _percentile_ms(latencies_s: list, frac: float):
    if not latencies_s:
        return None
    lat = sorted(latencies_s)
    return round(1e3 * lat[int(frac * (len(lat) - 1))], 3)


def precision_bench(requests: int = 24, gap_ms: float = 0.5,
                    max_batch: int = 4, timeout_ms: float = 5.0,
                    bucket: tuple[int, int] = (32, 64),
                    native_hw: tuple[int, int] = (30, 60),
                    tiers: tuple[str, ...] = ("f32", "bf16", "int8"),
                    log_dir: str | None = None, device: str = "cuda",
                    model=None, overrides=()) -> dict:
    """The precision tiers through one engine on the real model: per
    tier, requests/s and p50/p99 over the same seeded workload, the
    tier's weight bytes, and the mean EPE of its flows against the f32
    tier's. f32 (the EPE reference) runs first, once."""
    from ..serve.quant import params_nbytes, resolve_precisions

    tiers = tuple(t for t in tiers if t != "f32")
    tiers = ("f32",) + tiers
    cfg = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    cfg = cfg.replace(serve=dataclasses.replace(cfg.serve,
                                                precisions=tiers))
    resolve_precisions(cfg)  # an unknown tier fails before any model
    if model is None:
        model = _real_model(cfg, device, log_dir)
    pairs = _pairs(requests, native_hw)

    out = {"mode": "precision", "requests": len(pairs),
           "max_batch": max_batch, "timeout_ms": timeout_ms,
           "gap_ms": gap_ms, "bucket": list(bucket),
           "precisions": list(tiers), "tiers": {}}
    f32_flows = None
    with InferenceEngine(cfg, model=model, device=device) as engine:
        engine.warm()
        for tier in tiers:
            wall, errors, results = run_workload(engine, pairs, gap_ms,
                                                 precision=tier)
            flows = [r["flow"] if r is not None else None for r in results]
            if tier == "f32":
                f32_flows = flows
            lats = [r["latency_s"] for r in results if r is not None]
            out["tiers"][tier] = {
                "wall_s": round(wall, 4),
                "requests_per_s": round((len(pairs) - errors) / wall, 2),
                "latency_p50_ms": _percentile_ms(lats, 0.50),
                "latency_p99_ms": _percentile_ms(lats, 0.99),
                "epe_vs_f32": _epe_mean(flows, f32_flows),
                "errors": errors,
                "weight_bytes": params_nbytes(engine.tier_models[tier]),
            }
    return out


# ----------------------------------------------------------- quality


def quality_bench(requests: int = 24, gap_ms: float = 0.5,
                  max_batch: int = 4, timeout_ms: float = 5.0,
                  bucket: tuple[int, int] = (32, 64),
                  native_hw: tuple[int, int] = (30, 60),
                  tiers: tuple[str, ...] = ("f32", "bf16", "int8"),
                  sample_rate: float = 0.1,
                  log_dir: str | None = None, device: str = "cuda",
                  model=None, overrides=()) -> dict:
    """The label-free quality proxies (obs/quality.py) on the seeded
    pairs, in two phases on the real model:

      scores    one engine at sample rate 1.0 runs the workload per tier
                and reports each tier's mean photo / smooth / census
                proxy (from the per-key sum maps, the numbers a fleet
                merge re-derives) and the drift verdict after the sweep.
      overhead  two fresh engines, scoring off and at `sample_rate`, run
                the f32 workload: the requests/s and p99 deltas are the
                scorer's cost on the serving path; `scored_quality_on` is
                how many requests the sampling engine scored.
    """
    tiers = ("f32",) + tuple(t for t in tiers if t != "f32")
    cfg = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    cfg = cfg.replace(serve=dataclasses.replace(cfg.serve, precisions=tiers))
    if model is None:
        model = _real_model(cfg, device, log_dir)
    pairs = _pairs(requests, native_hw)

    def q_cfg(rate: float):
        return cfg.replace(obs=dataclasses.replace(
            cfg.obs, quality_sample_rate=rate))

    out = {"mode": "quality", "requests": len(pairs),
           "max_batch": max_batch, "timeout_ms": timeout_ms,
           "gap_ms": gap_ms, "bucket": list(bucket),
           "precisions": list(tiers), "sample_rate": sample_rate,
           "tiers": {}}
    # phase 1: each tier's proxy scores at sample rate 1.0
    with InferenceEngine(q_cfg(1.0), model=model, device=device) as engine:
        engine.warm()
        for tier in tiers:
            run_workload(engine, pairs, gap_ms, precision=tier)
        engine._quality.drain(120.0)
        stats = engine.stats()
        scored = stats["serve_quality_scored_by_key"]
        sums = {"photo": stats["serve_quality_photo_sum_by_key"],
                "smooth": stats["serve_quality_smooth_sum_by_key"],
                "census": stats["serve_quality_census_sum_by_key"]}
        for tier in tiers:
            key = f"{tier}/cold"
            n = scored.get(key, 0)
            out["tiers"][tier] = {
                "scored": n,
                **{proxy: (round(sums[proxy].get(key, 0.0) / n, 6)
                           if n else None)
                   for proxy in ("photo", "smooth", "census")},
            }
        out["quality"] = stats["serve_quality"]
        out["dropped"] = stats["serve_quality_dropped"]

    # phase 2: the scorer's cost, the f32 workload with scoring off and
    # at `sample_rate` (fresh engines)
    def timed(rate: float):
        with InferenceEngine(q_cfg(rate), model=model, device=device) as eng:
            eng.warm()
            wall, errors, results = run_workload(eng, pairs, gap_ms)
            lats = [r["latency_s"] for r in results if r is not None]
            if eng._quality is not None:
                eng._quality.drain(120.0)
            scored = eng.stats().get("serve_quality_scored", 0)
        rps = (len(pairs) - errors) / wall if wall > 0 else None
        return rps, _percentile_ms(lats, 0.99), scored

    rps_off, p99_off, _ = timed(0.0)
    rps_on, p99_on, out["scored_quality_on"] = timed(float(sample_rate))
    out["rps_quality_off"] = round(rps_off, 2) if rps_off else None
    out["rps_quality_on"] = round(rps_on, 2) if rps_on else None
    out["scorer_overhead_pct"] = (
        round(100.0 * (rps_off - rps_on) / rps_off, 2)
        if rps_off and rps_on else None)
    out["p99_quality_off_ms"] = p99_off
    out["p99_quality_on_ms"] = p99_on
    out["p99_overhead_pct"] = (round(100.0 * (p99_on - p99_off) / p99_off, 2)
                               if p99_off and p99_on else None)
    return out


# ------------------------------------------------------------ ledger


def _overhead_pct(off, on):
    """100 (on - off) / off, None when `off` is 0 or either is missing."""
    return (round(100.0 * (on - off) / off, 2)
            if off and on is not None else None)


def _timed_pair(cfg, model, pairs, gap_ms: float, max_batch: int,
                device: str, ledger_dir: str | None = None,
                install=None):
    """One fresh engine of `cfg` through a discarded pre-workload (the
    first flushes pay one-time costs that would set a small sample's
    p99) and then the measured workload: (requests/s, p99 ms, stats).
    `install(engine)` runs before `warm()`."""
    with InferenceEngine(cfg, model=model, device=device,
                         ledger_dir=ledger_dir) as eng:
        if install is not None:
            install(eng)
        eng.warm()
        run_workload(eng, pairs[:max(int(max_batch), 2)], gap_ms)
        wall, errors, results = run_workload(eng, pairs, gap_ms)
        lats = [r["latency_s"] for r in results if r is not None]
        stats = eng.stats()
    rps = (len(pairs) - errors) / wall if wall > 0 else None
    return rps, _percentile_ms(lats, 0.99), stats


def ledger_bench(requests: int = 24, gap_ms: float = 0.5,
                 max_batch: int = 4, timeout_ms: float = 5.0,
                 bucket: tuple[int, int] = (32, 64),
                 native_hw: tuple[int, int] = (30, 60),
                 log_dir: str | None = None, device: str = "cuda",
                 model=None, overrides=()) -> dict:
    """The executable ledger (obs/ledger.py) on the real model, in two
    phases:

      provenance  an engine with obs.ledger on runs the seeded workload;
                  the rows it writes to `<run dir>/ledger.jsonl` give the
                  lattice's first-call seconds, fingerprints, cache
                  counts and nominal-roofline MFU (the exec_timing rows
                  written at the engine's close).
      overhead    a fresh engine with obs.ledger off runs the same
                  workload first; the p99 delta is the ledger's cost on
                  the serving path (one perf_counter and one dict update
                  a flush).

    The run dir is `log_dir`, else a fresh temporary one. Rows are read
    from this run's start on: a reused `log_dir` holds older rows."""
    from ..obs.ledger import load_ledger

    cfg0 = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    if model is None:
        model = _real_model(cfg0, device, log_dir)
    run_dir = log_dir or tempfile.mkdtemp(prefix="ledger_bench_")
    pairs = _pairs(requests, native_hw)

    def timed(ledger_on: bool):
        cfg = cfg0.replace(obs=dataclasses.replace(cfg0.obs,
                                                   ledger=ledger_on))
        return _timed_pair(cfg, model, pairs, gap_ms, max_batch, device,
                           ledger_dir=run_dir)

    rps_off, p99_off, _ = timed(False)
    # rows carry their time rounded to 1 ms; the slack covers only that
    t_ledger_run = time.time() - 0.05
    rps_on, p99_on, stats_on = timed(True)

    rows = [r for r in load_ledger(run_dir)
            if (r.get("time") or 0) >= t_ledger_run]
    execs = {r["name"]: r for r in rows if r.get("kind") == "exec"}
    timings = {r["name"]: r for r in rows if r.get("kind") == "exec_timing"}
    executables = {
        name: {"compile_s": r.get("compile_s"),
               "fingerprint": r.get("fingerprint"),
               "mfu_nominal": (timings.get(name) or {}).get("mfu_nominal")}
        for name, r in sorted(execs.items())}
    mfus = [e["mfu_nominal"] for e in executables.values()
            if isinstance(e["mfu_nominal"], (int, float))]
    compile_s = [r.get("compile_s") for r in execs.values()
                 if isinstance(r.get("compile_s"), (int, float))]

    return {
        "mode": "ledger", "requests": len(pairs),
        "max_batch": max_batch, "timeout_ms": timeout_ms,
        "gap_ms": gap_ms, "bucket": list(bucket),
        "lowerings": stats_on.get("exec_lowerings"),
        "recompiles": stats_on.get("exec_recompiles"),
        "cache_hits": stats_on.get("exec_cache_hits"),
        "cache_misses": stats_on.get("exec_cache_misses"),
        "compile_s_total": (round(sum(compile_s), 3)
                            if compile_s else None),
        "mfu_nominal": round(max(mfus), 6) if mfus else None,
        "executables": executables,
        # 0.0 is a real figure; only a rate that cannot be computed is null
        "rps_ledger_off": (round(rps_off, 2) if rps_off is not None
                           else None),
        "rps_ledger_on": (round(rps_on, 2) if rps_on is not None
                          else None),
        "p99_ledger_off_ms": p99_off,
        "p99_ledger_on_ms": p99_on,
        "p99_overhead_pct": _overhead_pct(p99_off, p99_on),
    }


# ---------------------------------------------------------- incidents


def incident_bench(requests: int = 24, gap_ms: float = 0.5,
                   max_batch: int = 4, timeout_ms: float = 5.0,
                   bucket: tuple[int, int] = (32, 64),
                   native_hw: tuple[int, int] = (30, 60),
                   log_dir: str | None = None, device: str = "cuda",
                   model=None, overrides=()) -> dict:
    """The incident plane's cost on the serving path (obs/incident.py):
    the seeded real-model workload with obs.incidents off and on, the
    recorder installed with one rule that never fires. The recorder does
    nothing per request (its only surface is the engine's stats pass),
    so the p99 delta is the plane's whole cost."""
    from ..obs import incident as obs_incident

    cfg0 = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    if model is None:
        model = _real_model(cfg0, device, log_dir)
    run_dir = log_dir or tempfile.mkdtemp(prefix="incident_bench_")
    pairs = _pairs(requests, native_hw)

    def timed(on: bool):
        cfg = cfg0.replace(
            obs=dataclasses.replace(
                cfg0.obs, incidents=on,
                # a registered rule that is never satisfied, so the
                # recorder has its serving shape (rules parse at install
                # and run on the stats cadence, never per request)
                alerts=(("serve_errors > 1e12",) if on else ())),
            train=dataclasses.replace(cfg0.train, log_dir=run_dir))

        def install(eng):
            eng.incidents = obs_incident.install(cfg, run_dir, "serve")

        return _timed_pair(cfg, model, pairs, gap_ms, max_batch, device,
                           install=install)

    rps_off, p99_off, _ = timed(False)
    rps_on, p99_on, stats_on = timed(True)
    return {
        "mode": "incidents", "requests": len(pairs),
        "max_batch": max_batch, "timeout_ms": timeout_ms,
        "gap_ms": gap_ms, "bucket": list(bucket),
        "alert_rules": stats_on.get("alert_rules"),
        # no trigger fires on this healthy workload: 0
        "captured": stats_on.get("incident_captured"),
        "rps_incidents_off": (round(rps_off, 2) if rps_off is not None
                              else None),
        "rps_incidents_on": (round(rps_on, 2) if rps_on is not None
                             else None),
        "p99_incidents_off_ms": p99_off,
        "p99_incidents_on_ms": p99_on,
        "p99_overhead_pct": _overhead_pct(p99_off, p99_on),
    }


# ------------------------------------------------------------- fleet
#
# The process modes: replicas are `python -m deepof_tpu_torch serve
# --config-json <replica dir>/config.json --device <device>` processes
# (`serve/fleet.py::Fleet`) with the fake executor (`serve.fake_exec_ms`)
# behind the router (`serve/router.py`), driven over HTTP from this
# process; no kernel runs in them.


def _fleet_cfg(log_dir: str, max_batch: int, timeout_ms: float,
               exec_ms: float, bucket: tuple[int, int], overrides=()):
    """A fake-executor fleet's config: the bench's, every replica's
    dispatch a sleep of `exec_ms`, the router on an ephemeral port, a
    fast poll."""
    cfg = _bench_cfg(bucket, max_batch, timeout_ms, log_dir, overrides)
    return cfg.replace(
        serve=dataclasses.replace(
            cfg.serve, fake_exec_ms=exec_ms, host="127.0.0.1", port=0,
            fleet=dataclasses.replace(
                cfg.serve.fleet, poll_s=0.2, stale_after_s=10.0,
                spawn_timeout_s=90.0, proxy_timeout_s=30.0,
                max_in_flight=256, drain_timeout_s=5.0)),
        obs=dataclasses.replace(cfg.obs, heartbeat_period_s=0.5))


def _flow_body(native_hw: tuple[int, int]) -> bytes:
    """One POST /v1/flow body: two seeded images as base64 PNG. The JAX
    tool encodes them with cv2; `io/png.py::png_bytes` writes other
    bytes that decode to the same pixels."""
    import base64

    from ..io.png import png_bytes

    rng = np.random.RandomState(0)
    imgs = [base64.b64encode(png_bytes(rng.randint(
        1, 255, (*native_hw, 3), dtype=np.uint8))).decode()
        for _ in range(2)]
    return json.dumps({"prev": imgs[0], "next": imgs[1]}).encode()


def _drive_closed_loop(port: int, body: bytes, requests: int,
                       clients: int) -> tuple[float, int, int]:
    """`clients` threads, each on a keep-alive connection, take request
    slots from one counter until `requests` are done. Returns (wall_s,
    the 200s, the errors)."""
    import http.client
    import itertools

    counter = itertools.count()
    ok_count = [0] * clients
    err_count = [0] * clients

    def worker(slot: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while next(counter) < requests:
                try:
                    conn.request("POST", "/v1/flow", body,
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status == 200:
                        ok_count[slot] += 1
                    else:
                        err_count[slot] += 1
                except Exception:  # noqa: BLE001 - counted, keep driving
                    err_count[slot] += 1
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=60)
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, sum(ok_count), sum(err_count)


def _scrape_metrics(port: int) -> dict:
    """GET /metrics on the router, read back through the Prometheus
    parser (`obs/export.py::parse_prometheus`): the figures an
    operator's collector sees."""
    import http.client

    from ..obs.export import parse_prometheus

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", "/metrics")
        samples = parse_prometheus(conn.getresponse().read().decode())
    finally:
        conn.close()
    return {
        "fleet_requests": samples.get("deepof_fleet_requests"),
        "fleet_responses": samples.get("deepof_fleet_responses"),
        "serve_responses": samples.get("deepof_serve_responses"),
        "serve_latency_count": samples.get("deepof_serve_latency_ms_count"),
        "serve_latency_sum_ms": samples.get("deepof_serve_latency_ms_sum"),
        "fleet_latency_count": samples.get("deepof_fleet_latency_ms_count"),
        # None for a fleet without an autoscaler
        "fleet_autoscale_up": samples.get("deepof_fleet_autoscale_up"),
        "fleet_autoscale_down": samples.get("deepof_fleet_autoscale_down"),
    }


def _serve_router(cfg, router):
    """The router's HTTP server on a thread: (server, port)."""
    from ..serve.router import build_router_server

    httpd = build_router_server(cfg, router)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


def _stop_router(router, httpd) -> None:
    router.draining = True
    httpd.shutdown()
    httpd.server_close()


def _run_fleet_once(cfg, replicas: int, body: bytes, requests: int,
                    clients: int, device: str) -> dict:
    from ..serve.fleet import Fleet
    from ..serve.router import Router

    with Fleet(cfg, replicas, device=device) as fleet:
        fleet.start()
        fleet.wait_ready(min_ready=replicas,
                         timeout_s=cfg.serve.fleet.spawn_timeout_s)
        router = Router(cfg, fleet)
        httpd, port = _serve_router(cfg, router)
        scrape = None
        try:
            wall, ok, err = _drive_closed_loop(port, body, requests, clients)
            try:
                scrape = _scrape_metrics(port)
            except Exception:  # noqa: BLE001 - a scrape fails no bench
                scrape = None
        finally:
            _stop_router(router, httpd)
        stats = {**fleet.stats(), **router.stats()}
    return {"wall_s": wall, "ok": ok, "errors": err, "stats": stats,
            "scrape": scrape}


def fleet_bench(replicas: int = 2, requests: int = 96, clients: int = 8,
                max_batch: int = 4, timeout_ms: float = 5.0,
                exec_ms: float = 20.0, bucket: tuple[int, int] = (32, 64),
                native_hw: tuple[int, int] = (30, 60),
                log_dir: str | None = None, device: str = "cuda",
                overrides=()) -> dict:
    """N replicas behind the router against the same closed-loop
    workload on one replica. The fake executor sleeps a dispatch, so
    the fleet's gain is dispatches in parallel processes."""
    base = log_dir or tempfile.mkdtemp(prefix="serve_bench_fleet_")
    body = _flow_body(native_hw)
    replicas = max(int(replicas), 2)

    def cfg(name):
        return _fleet_cfg(os.path.join(base, name), max_batch, timeout_ms,
                          exec_ms, bucket, overrides)

    multi = _run_fleet_once(cfg(f"fleet{replicas}"), replicas, body,
                            requests, clients, device)
    single = _run_fleet_once(cfg("fleet1"), 1, body, requests, clients,
                             device)
    rps = ((requests - multi["errors"]) / multi["wall_s"]
           if multi["wall_s"] > 0 else None)
    srps = ((requests - single["errors"]) / single["wall_s"]
            if single["wall_s"] > 0 else None)
    return {
        "mode": "fleet", "replicas": replicas, "clients": clients,
        "requests": requests, "errors": multi["errors"],
        "wall_s": round(multi["wall_s"], 4),
        "requests_per_s": round(rps, 2) if rps else None,
        "single_errors": single["errors"],
        "single_wall_s": round(single["wall_s"], 4),
        "single_requests_per_s": round(srps, 2) if srps else None,
        "speedup_vs_single": (round(rps / srps, 2)
                              if rps and srps else None),
        "failovers": multi["stats"]["fleet_failovers"],
        "shed": multi["stats"]["fleet_shed"],
        "routed": multi["stats"]["fleet_routed"],
        "max_batch": max_batch, "timeout_ms": timeout_ms,
        "fake_exec_ms": exec_ms, "bucket": list(bucket), "log_dir": base,
        "metrics_scrape": multi["scrape"],
    }


# -------------------------------------------------------------- ramp


def _drive_timed(port: int, body: bytes, clients: int,
                 duration_s: float, headers: dict | None = None,
                 collect_latency: bool = False) -> dict:
    """A closed-loop client pool for a fixed window: every client posts
    until the deadline. {"ok", "errors" (a reply that is not a 200: a
    shed 503 counts here), "drops" (no reply at all: the router must
    make these 0), "t0", "t1"}; `headers` go with every request (the
    brownout's X-Priority and X-Deadline-Ms); `collect_latency` adds the
    200s' client p50/p99 (latency_p50_ms, latency_p99_ms)."""
    import http.client

    deadline = time.perf_counter() + max(float(duration_s), 0.0)
    ok = [0] * clients
    err = [0] * clients
    drops = [0] * clients
    lats: list[list[float]] = [[] for _ in range(clients)]
    hdrs = {"Content-Type": "application/json", **(headers or {})}

    def worker(slot: int) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while time.perf_counter() < deadline:
                try:
                    t_req = time.perf_counter()
                    conn.request("POST", "/v1/flow", body, hdrs)
                    resp = conn.getresponse()
                    resp.read()
                    if resp.status == 200:
                        ok[slot] += 1
                        if collect_latency:
                            lats[slot].append(
                                (time.perf_counter() - t_req) * 1e3)
                    else:
                        err[slot] += 1
                except Exception:  # noqa: BLE001 - a drop, counted
                    drops[slot] += 1
                    conn.close()
                    conn = http.client.HTTPConnection("127.0.0.1", port,
                                                      timeout=60)
        finally:
            conn.close()

    threads = [threading.Thread(target=worker, args=(i,), daemon=True)
               for i in range(clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {"ok": sum(ok), "errors": sum(err), "drops": sum(drops),
           "t0": round(t0, 2), "t1": round(time.time(), 2)}
    if collect_latency:
        flat = sorted(x for slot in lats for x in slot)
        out["latency_p50_ms"] = (
            round(flat[len(flat) // 2], 2) if flat else None)
        out["latency_p99_ms"] = (
            round(flat[min(int(len(flat) * 0.99), len(flat) - 1)], 2)
            if flat else None)
    return out


def _ramp_cfg(log_dir: str, max_replicas: int, max_batch: int,
              timeout_ms: float, exec_ms: float, max_in_flight: int,
              bucket: tuple[int, int], slope: float = 0.0, overrides=()):
    """An autoscaling fake-executor fleet at a fast cadence (the
    production policy's shape, its windows and cooldowns short);
    `slope` > 0 arms the predictive load-slope scale-up."""
    cfg = _fleet_cfg(log_dir, max_batch, timeout_ms, exec_ms, bucket,
                     overrides)
    return cfg.replace(serve=dataclasses.replace(
        cfg.serve,
        fleet=dataclasses.replace(
            cfg.serve.fleet, autoscale=True, min_replicas=1,
            max_replicas=max_replicas, max_in_flight=max_in_flight,
            autoscale_period_s=0.25, autoscale_up_after_s=0.5,
            autoscale_down_after_s=2.0, autoscale_up_cooldown_s=1.0,
            autoscale_down_cooldown_s=2.0, autoscale_up_slope=slope)))


class _AutoscaledFleet:
    """A fleet of one replica under the router and its autoscaler, the
    router's server on a thread: `fleet`, `router`, `scaler`, `port`."""

    def __init__(self, cfg, device: str):
        from ..serve.autoscale import Autoscaler
        from ..serve.fleet import Fleet
        from ..serve.router import Router

        self.fleet = Fleet(cfg, device=device)
        self.fleet.__enter__()
        try:
            self.fleet.start()
            self.fleet.wait_ready(min_ready=1,
                                  timeout_s=cfg.serve.fleet.spawn_timeout_s)
            self.router = Router(cfg, self.fleet)
            self.fleet.on_retired = self.router.retire_slot
            self.httpd, self.port = _serve_router(cfg, self.router)
            self.scaler = Autoscaler(cfg, self.fleet, self.router)
            self.router.autoscale_stats = self.scaler.stats
            self.scaler.start()
        except BaseException:
            self.fleet.__exit__(None, None, None)
            raise

    def close(self) -> None:
        try:
            self.scaler.close()
            _stop_router(self.router, self.httpd)
        finally:
            self.fleet.__exit__(None, None, None)


def _slope_leg(base: str, slope: float, max_replicas: int, max_batch: int,
               timeout_ms: float, exec_ms: float, max_in_flight: int,
               bucket: tuple[int, int], body: bytes, burst_clients: int,
               device: str, overrides=(), step_s: float = 1.0) -> dict:
    """One leg of the predictive-against-reactive comparison: a fresh
    one-replica autoscaling fleet under a ramped closed-loop drive (1 to
    `burst_clients` clients, one more each `step_s`), with the slope
    signal at `slope` (0: reactive only). The leg's sheds make the
    delta."""
    cfg = _ramp_cfg(base, max_replicas, max_batch, timeout_ms, exec_ms,
                    max_in_flight, bucket, slope=slope, overrides=overrides)
    out = {"ok": 0, "errors": 0, "drops": 0}
    pool = _AutoscaledFleet(cfg, device)
    try:
        for clients in range(1, burst_clients + 1):
            chunk = _drive_timed(pool.port, body, clients, step_s)
            for k in ("ok", "errors", "drops"):
                out[k] += chunk[k]
        rs = pool.router.stats()
        ss = pool.scaler.stats()
        out.update({
            "slope": slope,
            "sheds": rs["fleet_shed"] + rs["fleet_unavailable"],
            "scale_ups": ss["fleet_autoscale_up"],
            "slope_ticks": ss.get("fleet_autoscale_slope_ticks", 0),
            "final_replicas": pool.fleet.size,
        })
    finally:
        pool.close()
    return out


def ramp_bench(max_replicas: int = 3, burst_clients: int = 8,
               warm_s: float = 2.0, burst_s: float = 8.0,
               idle_s: float = 20.0, max_batch: int = 2,
               timeout_ms: float = 2.0, exec_ms: float = 30.0,
               max_in_flight: int = 4, bucket: tuple[int, int] = (32, 64),
               native_hw: tuple[int, int] = (30, 60),
               slope_threshold: float = 2.0, log_dir: str | None = None,
               device: str = "cuda", overrides=()) -> dict:
    """The autoscaler under bursty load, end to end in this process
    (Fleet, Router, Autoscaler; fake-executor replica processes):

      warm     1 closed-loop client against the min_replicas pool;
      burst    `burst_clients` clients against the same one replica:
               with max_in_flight slots the router sheds (sheds_burst)
               and the autoscaler scales up (scale_up_latency_s: the
               burst's start to the first scale_up record);
      hold     2 clients while the new replicas boot, until the pool
               can take the whole burst (a silent gap would read as
               idle and scale straight back down);
      scaled burst  the same burst again: sheds_after_scale falls to
               about 0;
      idle     no load until the pool has scaled down (graceful:
               retired == scale_downs, evictions 0), then one probe
               second on the smaller pool.

    `drops` counts the requests that got no reply at all, over every
    phase. `scale_up_to_first_response_ms`: the first scale_up record to
    the first request the router admits to a replica that was not there
    before the burst (its routed counters, watched every 20 ms). Then
    two fresh fleets under a ramped drive (`_slope_leg`), one with the
    slope signal at `slope_threshold` and one reactive:
    `predictive_shed_delta` = reactive sheds - predictive sheds."""
    base = log_dir or tempfile.mkdtemp(prefix="serve_bench_ramp_")
    body = _flow_body(native_hw)
    max_replicas = max(int(max_replicas), 2)
    cfg = _ramp_cfg(base, max_replicas, max_batch, timeout_ms, exec_ms,
                    max_in_flight, bucket, overrides=overrides)
    fc = cfg.serve.fleet
    phases: dict[str, dict] = {}
    t_start = time.perf_counter()
    # a reused --log-dir appends to its metrics.jsonl: scale records
    # older than this run are not read
    t_run_wall = time.time()
    pool = _AutoscaledFleet(cfg, device)
    fleet, router, scaler, port = (pool.fleet, pool.router, pool.scaler,
                                   pool.port)
    scrape = None
    peak = fleet.size
    try:
        def shed_now() -> int:
            rs = router.stats()
            return rs["fleet_shed"] + rs["fleet_unavailable"]

        phases["warm"] = _drive_timed(port, body, 1, warm_s)

        # the first request admitted to a replica that was not there
        # before the burst (the fake executor answers within one
        # dispatch of its admission)
        baseline_names = set(router.stats()["fleet_routed"])
        first_new_resp: list[float | None] = [None]
        watch_stop = threading.Event()

        def _watch_first_response() -> None:
            while not watch_stop.is_set():
                try:
                    routed = router.stats()["fleet_routed"]
                except Exception:  # noqa: BLE001 - the watcher never raises
                    return
                for rname, n in routed.items():
                    if rname not in baseline_names and n > 0:
                        first_new_resp[0] = time.time()
                        return
                time.sleep(0.02)

        watcher = threading.Thread(target=_watch_first_response,
                                   daemon=True)
        watcher.start()

        shed0 = shed_now()
        t_burst_wall = time.time()
        phases["burst"] = _drive_timed(port, body, burst_clients, burst_s)
        sheds_burst = shed_now() - shed0

        hold = {"ok": 0, "errors": 0, "drops": 0,
                "t0": round(time.time(), 2)}
        deadline = time.monotonic() + float(fc.spawn_timeout_s)
        while time.monotonic() < deadline:
            ready = fleet.stats()["fleet_ready"]
            if (ready >= scaler.max
                    or ready * max_in_flight > burst_clients):
                break
            chunk = _drive_timed(port, body, 2, 0.5)
            for k in ("ok", "errors", "drops"):
                hold[k] += chunk[k]
        hold["t1"] = round(time.time(), 2)
        phases["hold"] = hold
        watch_stop.set()
        watcher.join(timeout=1.0)
        peak = max(peak, fleet.size)
        first_up = None
        if scaler.stats()["fleet_autoscale_up"]:
            # the first scale_up record the autoscaler appended
            try:
                with open(os.path.join(base, "metrics.jsonl")) as f:
                    for line in f:
                        rec = json.loads(line)
                        if (rec.get("kind") == "fleet"
                                and rec.get("event") == "scale_up"
                                and rec.get("time", 0.0) >= t_run_wall):
                            first_up = rec["time"]
                            break
            except (OSError, ValueError):
                pass

        shed1 = shed_now()
        phases["scaled_burst"] = _drive_timed(port, body, burst_clients,
                                              burst_s)
        sheds_after = shed_now() - shed1
        peak = max(peak, fleet.size)

        deadline = time.monotonic() + max(float(idle_s), 0.0)
        while time.monotonic() < deadline:
            if (scaler.stats()["fleet_autoscale_down"] > 0
                    and fleet.size <= scaler.min):
                break
            time.sleep(0.25)
        phases["probe"] = _drive_timed(port, body, 1, 1.0)
        try:
            scrape = _scrape_metrics(port)
        except Exception:  # noqa: BLE001 - a scrape fails no bench
            scrape = None
        sstats = scaler.stats()
        fstats = fleet.stats()
    finally:
        pool.close()
    # the comparison's fleets, each fresh, after the drill's is gone
    legs = {name: _slope_leg(os.path.join(base, f"leg_{name}"), slope,
                             max_replicas, max_batch, timeout_ms, exec_ms,
                             max_in_flight, bucket, body, burst_clients,
                             device, overrides)
            for name, slope in (("predictive", slope_threshold),
                                ("reactive", 0.0))}
    wall = time.perf_counter() - t_start
    total = {k: sum(p[k] for p in phases.values())
             for k in ("ok", "errors", "drops")}
    burst_rate = (phases["scaled_burst"]["ok"] / burst_s
                  if burst_s > 0 else None)
    return {
        "mode": "ramp", "min_replicas": 1, "max_replicas": max_replicas,
        "burst_clients": burst_clients,
        "phases": {name: dict(p) for name, p in phases.items()},
        "requests": sum(total.values()),
        "requests_per_s": (round(burst_rate, 2)
                           if burst_rate is not None else None),
        "errors": total["errors"], "drops": total["drops"],
        "sheds_burst": sheds_burst, "sheds_after_scale": sheds_after,
        "scale_ups": sstats["fleet_autoscale_up"],
        "scale_downs": sstats["fleet_autoscale_down"],
        "retired": fstats["fleet_retired"],
        "evictions": fstats["fleet_evictions"],
        "peak_replicas": peak, "final_replicas": fstats["fleet_replicas"],
        "scale_up_latency_s": (round(first_up - t_burst_wall, 2)
                               if first_up else None),
        "scale_up_to_first_response_ms": (
            round((first_new_resp[0] - first_up) * 1000.0, 1)
            if first_up and first_new_resp[0] else None),
        "predictive_sheds": legs["predictive"]["sheds"],
        "reactive_sheds": legs["reactive"]["sheds"],
        "predictive_shed_delta": (legs["reactive"]["sheds"]
                                  - legs["predictive"]["sheds"]),
        "autoscale_up_slope": slope_threshold,
        "compare_legs": legs,
        "wall_s": round(wall, 2),
        "max_batch": max_batch, "fake_exec_ms": exec_ms,
        "max_in_flight": max_in_flight, "bucket": list(bucket),
        "log_dir": base, "metrics_scrape": scrape,
    }


# ---------------------------------------------------------- brownout


def _brownout_cfg(log_dir: str, max_batch: int, timeout_ms: float,
                  exec_ms: float, max_in_flight: int,
                  bucket: tuple[int, int], enabled: bool, overrides=()):
    """One leg's fleet: two buckets and two tiers (so L1 and L2 have a
    cheaper rung), a small in-flight cap (so the overload saturates),
    and on the ON leg the degrade controller at a fast cadence;
    recover_after_s outlasts the counted window (the leg measures L3,
    not the walk back)."""
    cfg = _fleet_cfg(log_dir, max_batch, timeout_ms, exec_ms, bucket,
                     overrides)
    small = (max(bucket[0] // 2, 8), max(bucket[1] // 2, 8))
    return cfg.replace(serve=dataclasses.replace(
        cfg.serve, buckets=(small, tuple(bucket)),
        precisions=("f32", "bf16"),
        fleet=dataclasses.replace(cfg.serve.fleet,
                                  max_in_flight=max_in_flight),
        degrade=dataclasses.replace(
            cfg.serve.degrade, enabled=enabled, period_s=0.1,
            escalate_after_s=0.2, recover_after_s=5.0,
            escalate_cooldown_s=0.3, recover_cooldown_s=1.0)))


def _brownout_leg(base: str, enabled: bool, replicas: int,
                  default_clients: int, low_clients: int, ramp_s: float,
                  window_s: float, max_batch: int, timeout_ms: float,
                  exec_ms: float, max_in_flight: int,
                  bucket: tuple[int, int], body: bytes, device: str,
                  overrides=()) -> dict:
    """One leg on a fresh fleet: `default_clients` closed-loop clients
    inside its capacity (each with X-Deadline-Ms 5000) and `low_clients`
    with X-Priority low past it. The ramp drives until the ON leg's
    controller is at L3 (bounded), then the counted window reads each
    priority's outcome; the figures come off the router's /metrics."""
    from ..obs.export import parse_prometheus
    from ..serve.fleet import Fleet
    from ..serve.router import Router

    cfg = _brownout_cfg(base, max_batch, timeout_ms, exec_ms,
                        max_in_flight, bucket, enabled, overrides)
    out: dict = {"enabled": enabled}
    max_level = 0
    with Fleet(cfg, replicas, device=device) as fleet:
        fleet.start()
        fleet.wait_ready(min_ready=replicas,
                         timeout_s=cfg.serve.fleet.spawn_timeout_s)
        router = Router(cfg, fleet)
        httpd, port = _serve_router(cfg, router)
        degr = None
        if enabled:
            from ..serve.degrade import DegradeController

            degr = DegradeController(cfg, fleet, router)
            router.degrade_stats = degr.stats
            router.degrade_level = degr.level
            degr.start()
        try:
            def drive_mix(duration: float) -> tuple[dict, dict]:
                res: list = [None, None]

                def run(i, clients, headers, lat):
                    res[i] = _drive_timed(port, body, clients, duration,
                                          headers=headers,
                                          collect_latency=lat)

                pools = [threading.Thread(target=run, args=(
                            0, default_clients, {"X-Deadline-Ms": "5000"},
                            True)),
                         threading.Thread(target=run, args=(
                            1, low_clients, {"X-Priority": "low"}, False))]
                for t in pools:
                    t.start()
                for t in pools:
                    t.join()
                return res[0], res[1]

            # the OFF leg gets the ON leg's minimum ramp, so both windows
            # start from a comparable queue
            ramp = {"ok": 0, "errors": 0, "drops": 0}
            ramp_deadline = time.monotonic() + (
                max(ramp_s, 10.0) if enabled else ramp_s)
            min_until = time.monotonic() + ramp_s
            while time.monotonic() < ramp_deadline:
                d, lo = drive_mix(0.5)
                for k in ramp:
                    ramp[k] += d[k] + lo[k]
                if degr is not None:
                    max_level = max(max_level, degr.level())
                if time.monotonic() >= min_until and (
                        degr is None or max_level >= 3):
                    break
            out["ramp"] = ramp

            # a shed is a shed to the client, the router's saturation 503
            # or the L3 priority shed
            shed0 = router.stats()["fleet_shed"]
            d, lo = drive_mix(window_s)
            if degr is not None:
                max_level = max(max_level, degr.level())
            rs = router.stats()
            out.update({
                "default_ok": d["ok"], "default_sheds": d["errors"],
                "low_ok": lo["ok"], "low_errors": lo["errors"],
                "drops": ramp["drops"] + d["drops"] + lo["drops"],
                "latency_p50_ms": d["latency_p50_ms"],
                "latency_p99_ms": d["latency_p99_ms"],
                "saturation_sheds_window": rs["fleet_shed"] - shed0,
                "shed_low": rs.get("degrade_shed_low", 0),
                "max_level": max_level,
                "transitions": rs.get("degrade_transitions", 0),
                "escalations": rs.get("degrade_escalations", 0),
                "recoveries": rs.get("degrade_recoveries", 0),
            })
            # the replicas' counters through the router's merged scrape
            import http.client

            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=30)
            try:
                conn.request("GET", "/metrics")
                samples = parse_prometheus(
                    conn.getresponse().read().decode())
            finally:
                conn.close()
            out.update({
                "tier_downgrades": samples.get(
                    "deepof_degrade_tier_downgrades", 0),
                "bucket_downgrades": samples.get(
                    "deepof_degrade_bucket_downgrades", 0),
                "requests_with_deadline": samples.get(
                    "deepof_deadline_requests", 0),
                "scrape_degrade_level": samples.get("deepof_degrade_level"),
            })
        finally:
            if degr is not None:
                degr.close()
            _stop_router(router, httpd)
    return out


def brownout_bench(replicas: int = 2, default_clients: int = 3,
                   low_clients: int = 8, ramp_s: float = 2.0,
                   window_s: float = 3.0, max_batch: int = 2,
                   timeout_ms: float = 2.0, exec_ms: float = 30.0,
                   max_in_flight: int = 2,
                   bucket: tuple[int, int] = (32, 64),
                   native_hw: tuple[int, int] = (30, 60),
                   log_dir: str | None = None, device: str = "cuda",
                   overrides=()) -> dict:
    """The same mixed-priority overload against two fresh fleets, the
    degrade controller off (saturation sheds land on default-priority
    traffic too) and on (L1 tier, L2 bucket, L3 priority shed: the
    default-priority traffic rides the overload out).
    `default_shed_delta`: the default-priority sheds the controller
    took away."""
    base = log_dir or tempfile.mkdtemp(prefix="serve_bench_brownout_")
    body = _flow_body(native_hw)
    replicas = max(int(replicas), 2)
    t0 = time.perf_counter()
    off, on = (_brownout_leg(
        os.path.join(base, f"leg_{name}"), enabled, replicas,
        default_clients, low_clients, ramp_s, window_s, max_batch,
        timeout_ms, exec_ms, max_in_flight, bucket, body, device, overrides)
        for name, enabled in (("off", False), ("on", True)))
    return {
        "mode": "brownout", "replicas": replicas,
        "default_clients": default_clients, "low_clients": low_clients,
        "window_s": window_s,
        "default_sheds_off": off["default_sheds"],
        "default_sheds_on": on["default_sheds"],
        "default_shed_delta": off["default_sheds"] - on["default_sheds"],
        "shed_low_on": on["shed_low"],
        "max_level_on": on["max_level"],
        "transitions_on": on["transitions"],
        "escalations_on": on["escalations"],
        "recoveries_on": on["recoveries"],
        "tier_downgrades_on": on["tier_downgrades"],
        "bucket_downgrades_on": on["bucket_downgrades"],
        "requests_with_deadline_on": on["requests_with_deadline"],
        "p99_default_off_ms": off["latency_p99_ms"],
        "p99_default_on_ms": on["latency_p99_ms"],
        "p50_default_off_ms": off["latency_p50_ms"],
        "p50_default_on_ms": on["latency_p50_ms"],
        "default_ok_off": off["default_ok"],
        "default_ok_on": on["default_ok"],
        "low_ok_off": off["low_ok"], "low_ok_on": on["low_ok"],
        "low_errors_off": off["low_errors"],
        "low_errors_on": on["low_errors"],
        "drops": off["drops"] + on["drops"],
        "wall_s": round(time.perf_counter() - t0, 2),
        "max_batch": max_batch, "fake_exec_ms": exec_ms,
        "max_in_flight": max_in_flight, "bucket": list(bucket),
        "log_dir": base, "legs": {"off": off, "on": on},
    }


# ---------------------------------------------------- artifact cold start


@contextlib.contextmanager
def _cold_build_dir(path: str):
    """This process's kernel libraries built and loaded afresh under
    `path` (an empty directory: a cold tree) for the block, as a
    replica's first boot on a new machine finds them; the checkout's
    build directory and loaded libraries come back after it."""
    from pathlib import Path

    from ..ops.cuda import build

    saved = (build.BUILD_DIR, build._libs)
    build.BUILD_DIR = Path(path)
    build._libs = {}
    try:
        yield
    finally:
        build.BUILD_DIR, build._libs = saved


def _ledger_rows(run_dir: str) -> list[dict]:
    from ..obs.ledger import load_ledger

    try:
        return [r for r in load_ledger(run_dir) if r.get("kind") == "exec"]
    except (OSError, ValueError):
        return []


def artifact_cold_bench(model: str = "flownet_s", width_mult: float = 1.0,
                        bucket: tuple[int, int] = (64, 128),
                        tiers: tuple[str, ...] = ("f32",),
                        log_dir: str | None = None, device: str = "cuda",
                        overrides=()) -> dict:
    """The cold start of a serving engine, with and without the artifact
    store (`serve/artifacts.py`), in this process. The JAX tool's legs
    time XLA's trace, lower and compile; the port compiles no graph,
    and its cold start is the CUDA kernels' libraries: built by nvcc,
    found built, or installed from the store. So here:

      publish  `warmup --serve` (`train/warmup.py::warmup_serve`): the
               libraries built in the checkout's build directory, each
               lattice entry traced into an "aot" row and published with
               the libraries its call launched, and the index written.
      leg A    the store off, an empty build directory: `warm()` builds
               every library the lattice launches with nvcc, then runs
               each entry (the compile-bound boot of a replica on a new
               machine before the store).
      leg B    the store on, its index off (`serve.artifacts_index=
               false`), an empty build directory: `warm()` installs the
               libraries from the store and traces each entry to find
               its fingerprint there (`exec_artifact_*`).
      leg C    the store and its index on, deep verify off, an empty
               build directory: each entry resolves through the index
               with no trace (`exec_index_*`).

    Each leg's engine is built on the same seeded weights; each leg's
    kernel launches (its warm's forwards: FlowNet-C's correlation once
    a cold entry) are in `kernel_launches`. On the CPU no library is
    built or installed (a CPU entry launches none): the legs time the
    engine alone. `cold_start_speedup` = leg A / leg C,
    `fingerprint_boot_speedup` = A / B, `index_vs_artifact_speedup` =
    B / C; `acquire_compile_s` is the mean `compile_s` of leg A's first
    calls (the libraries built under them), `acquire_fetch_s` the mean
    `resolve_s` of legs B and C's artifact rows (the store's lookup)."""
    from ..ops.cuda.build import launch_counts
    from ..serve.artifacts import store_entries, verify_entry
    from ..train import warmup

    base = log_dir or tempfile.mkdtemp(prefix="serve_bench_artifact_")
    store_dir = os.path.join(base, "exec")
    run_dir = os.path.join(base, "run")
    cfg = _bench_cfg(bucket, 2, 40.0, run_dir).replace(
        model=model, width_mult=width_mult)
    cfg = apply_sets(cfg.replace(serve=dataclasses.replace(
        cfg.serve, buckets=(tuple(bucket),), precisions=tuple(tiers),
        artifacts_dir=store_dir)), overrides)

    t0 = time.perf_counter()
    rep = warmup.warmup_serve(cfg, device)
    publish_wall = time.perf_counter() - t0
    ladder = len(rep["buckets"])
    publish_compile = round(sum(b.get("compile_s") or 0.0
                                for b in rep["buckets"]), 3)
    weights = build_serve_model(cfg, device)

    launches = {}

    def leg(name: str, leg_cfg) -> tuple[float, dict, list]:
        before = len(_ledger_rows(run_dir))
        counts = launch_counts()
        with _cold_build_dir(os.path.join(base, f"build_{name}")):
            t1 = time.perf_counter()
            with InferenceEngine(leg_cfg, model=weights, device=device,
                                 ledger_dir=run_dir) as eng:
                eng.warm()
                stats = eng.stats()
            wall = time.perf_counter() - t1
        launches[name] = {k: v - counts.get(k, 0)
                          for k, v in launch_counts().items()
                          if v != counts.get(k, 0)}
        return wall, stats, _ledger_rows(run_dir)[before:]

    t_compile, _, rows_a = leg("a", cfg.replace(
        serve=dataclasses.replace(cfg.serve, artifacts_dir="")))
    t_artifact, st, rows_b = leg("b", cfg.replace(
        serve=dataclasses.replace(cfg.serve, artifacts_index=False)))
    t_index, st_idx, rows_c = leg("c", cfg.replace(
        serve=dataclasses.replace(cfg.serve, artifacts_deep_verify=False)))

    fps = store_entries(store_dir)
    store_bytes = sum(verify_entry(store_dir, fp).get("size") or 0
                      for fp in fps)
    compile_s = [r["compile_s"] for r in rows_a
                 if r.get("compile_s") is not None]
    fetch_s = [r["resolve_s"] for r in rows_b + rows_c
               if r.get("compile_kind") == "artifact"
               and r.get("resolve_s") is not None]
    acq_c = (round(sum(compile_s) / len(compile_s), 4)
             if compile_s else None)
    acq_f = round(sum(fetch_s) / len(fetch_s), 4) if fetch_s else None
    return {
        "mode": "artifact_cold_start", "model": cfg.model,
        "width_mult": cfg.width_mult, "bucket": list(bucket),
        "tiers": list(tiers), "ladder": ladder,
        "publish_wall_s": round(publish_wall, 2),
        "publish_compile_s": publish_compile,
        "warm_wall_compile_s": round(t_compile, 2),
        "warm_wall_artifact_s": round(t_artifact, 2),
        "warm_wall_index_s": round(t_index, 2),
        "cold_start_speedup": round(t_compile / max(t_index, 1e-9), 2),
        "fingerprint_boot_speedup": round(
            t_compile / max(t_artifact, 1e-9), 2),
        "index_vs_artifact_speedup": round(
            t_artifact / max(t_index, 1e-9), 2),
        "acquire_compile_s": acq_c, "acquire_fetch_s": acq_f,
        "acquire_speedup": (round(acq_c / max(acq_f, 1e-9), 1)
                            if acq_c is not None and acq_f is not None
                            else None),
        "artifact_hits": st.get("exec_artifact_hits", 0),
        "artifact_misses": st.get("exec_artifact_misses", 0),
        "artifact_rejects": st.get("exec_artifact_rejects", 0),
        "index_hits": st_idx.get("exec_index_hits", 0),
        "index_misses": st_idx.get("exec_index_misses", 0),
        "index_rejects": st_idx.get("exec_index_rejects", 0),
        "store_entries": len(fps), "store_bytes": store_bytes,
        "store_dir": store_dir, "log_dir": base,
        "kernel_launches": launches,
        "libraries_built": {name: sorted(os.listdir(d)) if os.path.isdir(d)
                            else [] for name, d in (
                                (k, os.path.join(base, f"build_{k}"))
                                for k in "abc")},
        "warmup_artifacts": rep.get("artifacts"),
    }



# --------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve_bench")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--gap-ms", type=float, default=1.0)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="batcher max coalesced pairs (default 8)")
    ap.add_argument("--timeout-ms", type=float, default=None,
                    help="batcher flush timeout (default 10; 2 in "
                         "--stream mode, where a closed-loop walk never "
                         "coalesces and the timeout is pure overhead)")
    ap.add_argument("--exec-ms", type=float, default=None,
                    help="fake mode: per-dispatch executor latency "
                         "(default 10; 2 in --stream mode so the walk "
                         "stays decode-bound)")
    ap.add_argument("--bucket", default="64x64", metavar="HxW")
    ap.add_argument("--native", default="48x96", metavar="HxW",
                    help="native resolution of the synthetic requests")
    ap.add_argument("--real", action="store_true",
                    help="real model forward instead of the fake executor")
    ap.add_argument("--log-dir", default=None,
                    help="real mode: restore this run's newest verified "
                         "checkpoint instead of the seeded init")
    ap.add_argument("--serial", action="store_true",
                    help="also run max_batch=1 and report the speedup")
    ap.add_argument("--stream", action="store_true",
                    help="the streaming session walk against the pairwise "
                         "walk over the same frames (--decode-ms a "
                         "decode): stream_speedup, the decode counts and "
                         "bitwise flow parity, with the warm-start block")
    ap.add_argument("--frames", type=int, default=32,
                    help="stream mode: frames in the walked video")
    ap.add_argument("--decode-ms", type=float, default=20.0,
                    help="stream mode: injected per-decode delay")
    ap.add_argument("--warm-frames", type=int, default=16,
                    help="stream mode: frames of the real-model warm-start "
                         "walk (warm_speedup, epe_vs_cold); 0 skips it "
                         "(its keys are then null)")
    ap.add_argument("--warm-width", type=float, default=0.5,
                    help="stream mode: serve.session.warm_width of the "
                         "warm refinement stage")
    ap.add_argument("--precision", nargs="?", const="f32,bf16,int8",
                    default=None, metavar="TIERS",
                    help="sweep the precision tiers (comma list; the bare "
                         "flag = f32,bf16,int8) on the real model: per "
                         "tier requests/s, p50/p99, weight bytes and "
                         "epe_vs_f32")
    ap.add_argument("--quality", action="store_true",
                    help="the label-free quality proxies per tier on the "
                         "real model, the drift verdict, and the scorer's "
                         "cost (quality off against --quality-rate)")
    ap.add_argument("--quality-rate", type=float, default=0.1,
                    help="quality mode: sample rate of the cost "
                         "measurement (the scores phase samples at 1.0)")
    ap.add_argument("--ledger", action="store_true",
                    help="the executable ledger on the real model: the "
                         "lattice's rows and the ledger's p99 cost")
    ap.add_argument("--incidents", action="store_true",
                    help="the incident recorder's p99 cost on the real "
                         "model (obs.incidents off against an idle "
                         "recorder)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engines run (default cuda, which "
                         "raises without a card)")
    ap.add_argument("--set", action="append", default=[],
                    metavar="SECTION.FIELD=VALUE",
                    help="a config override after the bench's own "
                         "(repeatable)")
    ap.add_argument("--fleet", type=int, default=None, metavar="N",
                    help="an N-replica fleet (router and supervised "
                         "replica processes, closed-loop HTTP clients) "
                         "against a one-replica fleet")
    ap.add_argument("--clients", type=int, default=8,
                    help="fleet and ramp modes: concurrent closed-loop "
                         "HTTP clients (the ramp's burst width)")
    ap.add_argument("--ramp", action="store_true",
                    help="the autoscaler under bursty load: warm, burst, "
                         "scaled-burst and idle phases against a live "
                         "autoscaling fleet, then the predictive and "
                         "reactive legs")
    ap.add_argument("--max-replicas", type=int, default=3,
                    help="ramp mode: the autoscaler's ceiling")
    ap.add_argument("--burst-s", type=float, default=8.0,
                    help="ramp mode: seconds of each burst phase")
    ap.add_argument("--idle-s", type=float, default=20.0,
                    help="ramp mode: the idle window of the scale-down")
    ap.add_argument("--slope", type=float, default=2.0,
                    help="ramp mode: autoscale_up_slope of the predictive "
                         "leg (completions/s of trend a second)")
    ap.add_argument("--brownout", action="store_true",
                    help="the same mixed-priority overload against two "
                         "fresh fleets, the degrade controller off and "
                         "on")
    ap.add_argument("--window-s", type=float, default=3.0,
                    help="brownout mode: the counted overload window of "
                         "each leg")
    ap.add_argument("--artifact-cold", action="store_true",
                    help="publish the lattice into the artifact store, "
                         "then time a cold engine's warm with the store "
                         "off, on without its index and on with it")
    ap.add_argument("--width-mult", type=float, default=1.0,
                    help="artifact-cold mode: the model's width")
    args = ap.parse_args(argv)

    def hw(spec):
        h, w = spec.lower().split("x")
        return (int(h), int(w))

    # per-mode defaults: a closed-loop stream walk never coalesces, so
    # the batch timeout and executor sleep are pure per-flow overhead
    # there; the other modes keep 10 ms
    fast = 2.0 if args.stream else 10.0
    exec_ms = args.exec_ms if args.exec_ms is not None else fast
    timeout_ms = args.timeout_ms if args.timeout_ms is not None else fast
    max_batch = args.max_batch if args.max_batch is not None else 8
    common = {"log_dir": args.log_dir, "device": args.device,
              "overrides": tuple(args.set)}
    engine = {"requests": args.requests, "gap_ms": args.gap_ms,
              "max_batch": max_batch, "timeout_ms": timeout_ms,
              "bucket": hw(args.bucket), "native_hw": hw(args.native),
              **common}

    # the process modes: absent flags keep each mode's own defaults
    # (the ramp's and the brownout's exec 30 ms, flush 2 ms, batch 2:
    # the dynamics their drills are built on)
    procs = {"log_dir": args.log_dir, "device": args.device,
             "overrides": tuple(args.set), "bucket": hw(args.bucket)}
    shaped = {"max_batch": (args.max_batch if args.max_batch is not None
                            else 2),
              "exec_ms": args.exec_ms if args.exec_ms is not None else 30.0,
              "timeout_ms": (args.timeout_ms if args.timeout_ms is not None
                             else 2.0),
              "native_hw": hw(args.native), **procs}
    if args.artifact_cold:
        res = artifact_cold_bench(
            width_mult=args.width_mult,
            tiers=(tuple(t.strip() for t in args.precision.split(",")
                         if t.strip())
                   if args.precision is not None else ("f32",)), **procs)
    elif args.brownout:
        res = brownout_bench(window_s=args.window_s, **shaped)
    elif args.ramp:
        res = ramp_bench(max_replicas=args.max_replicas,
                         burst_clients=args.clients, burst_s=args.burst_s,
                         idle_s=args.idle_s, slope_threshold=args.slope,
                         **shaped)
    elif args.stream:
        res = stream_bench(frames=args.frames, decode_ms=args.decode_ms,
                           exec_ms=exec_ms, max_batch=max_batch,
                           timeout_ms=timeout_ms,
                           bucket=hw(args.bucket), native_hw=hw(args.native),
                           warm_frames=args.warm_frames,
                           warm_width=args.warm_width, **common)
    elif args.ledger:
        res = ledger_bench(**engine)
    elif args.incidents:
        res = incident_bench(**engine)
    elif args.quality:
        res = quality_bench(sample_rate=args.quality_rate, **engine)
    elif args.precision is not None:
        res = precision_bench(
            tiers=tuple(t.strip() for t in args.precision.split(",")
                        if t.strip()), **engine)
    elif args.fleet is not None:
        res = fleet_bench(replicas=args.fleet, clients=args.clients,
                          requests=args.requests, max_batch=max_batch,
                          timeout_ms=timeout_ms, exec_ms=exec_ms,
                          native_hw=hw(args.native), **procs)
    else:
        res = serve_bench(exec_ms=exec_ms, fake=not args.real,
                          serial=args.serial, **engine)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
