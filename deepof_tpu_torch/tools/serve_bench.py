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

Beside the JAX tool's flags: `--device` (default cuda, which raises
without a card; cpu runs the plain PyTorch path) and `--set
SECTION.FIELD=VALUE` (repeatable), applied after the bench's own config
as the `train` and `serve` verbs apply it. Every function takes the same
as `device=`, `overrides=`, and `model=` (and `refine=` where a warm
stage runs): an nn.Module with its weights in place of the seeded init.
The JAX tool's process modes (`--fleet`, `--ramp`, `--brownout`,
`--artifact-cold`) and the settings only they read (`--clients`,
`--max-replicas`, `--burst-s`, `--idle-s`, `--slope`, `--window-s`,
`--width-mult`) are not ported: each exits 2.

Kernels. At the defaults (FlowNet-S at width 0.25) the default mode,
--precision, --ledger and --incidents launch no kernel on the card:
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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
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

#: The JAX tool's modes that run the `serve` command line in processes of
#: their own; not ported (ROADMAP Queue A item 14).
PROCESS_MODES = ("--fleet", "--ramp", "--brownout", "--artifact-cold")
#: ... and the settings that only those modes read: refused as well
PROCESS_SETTINGS = ("--clients", "--max-replicas", "--burst-s", "--idle-s",
                    "--slope", "--window-s", "--width-mult")


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
    # the JAX tool's process modes and their settings: each one refused
    ap.add_argument("--fleet", default=None, metavar="N")
    for flag in PROCESS_MODES[1:]:
        ap.add_argument(flag, action="store_true")
    for flag in PROCESS_SETTINGS:
        ap.add_argument(flag, default=None)
    args = ap.parse_args(argv)

    refused = [f for f in PROCESS_MODES + PROCESS_SETTINGS
               if getattr(args, f[2:].replace("-", "_")) not in (None, False)]
    if refused:
        ap.error(f"{', '.join(refused)}: the process modes are not ported "
                 "yet (ROADMAP Queue A item 14)")

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

    if args.stream:
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
    else:
        res = serve_bench(exec_ms=exec_ms, fake=not args.real,
                          serial=args.serial, **engine)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
