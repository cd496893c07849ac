"""Chip smoke test of the PyTorch/CUDA port (`deepof_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a: H100) and the CUDA toolkit's nvcc. Builds
every CUDA kernel from `deepof_tpu_torch/csrc` into `build/` (one nvcc
per source, all at once), checks each against its plain PyTorch version
on the card, then drives the port's paths and checks that each went
through its kernels (the launch counts are set to 0 before each path and
read after it):
  - serving: FlowNet-C at full width through `InferenceEngine` (the
    correlation kernel); the same in the three precision tiers f32, bf16
    and int8 of one engine (`serve_tiers`: the float32 correlation once a
    dispatch in each); and video streams through `submit_next` with the
    temporal warm start (`serve_stream`: the correlation once a cold
    dispatch, the warp once a warm one, at input resolution), with the
    warp at that shape against its plain version (`check_warp`);
  - the correlation forward against its plain version at the serving
    and training shapes (bitwise equal) and ragged (`check_corr`), and
    its backward kernels at the training shape (bitwise equal), ragged,
    at stride 4 and at max_disp 0 (`check_corr_bwd`);
  - training: FlowNet-S at full width, 384x512, batch 4, f32: steps of
    `Trainer.train_step` on batches drawn in sequence (phase `train`,
    the warp and its flow gradient, one launch each per step), then the
    command line (`deepof_tpu_torch.cli.main`, the same configuration):
    `train` for 12 steps with evals and checkpoints at 6 and 12
    (`cli_train`), its resume to 16 (`cli_resume`), `Trainer.fit` under
    torch.profiler (`fit_profile`), `train` on a FlyingChairs tree of 12
    PPM/.flo pairs (`cli_flyingchairs`), and `eval` and `predict` on the
    `cli_train` run (`cli_eval_predict`);
  - training FlowNet-C and FlowNet-CS at full width, the same size, on
    card-resident batches, each step against the plain correlation
    (`train_flownet_c`, `train_flownet_cs`: the correlation forward and
    both backward kernels once a step), and FlowNet-C from the command
    line: `train`, `eval` and `predict` (`cli_train_flownet_c`);
  - bf16 compute (`train.compute_dtype=bfloat16`): the correlation
    forward and backward kernels' bf16 paths, bit for bit the float32
    kernels rounded, at the training shape and small cases; FlowNet-C
    training in bf16 against the plain correlation, beside a float32
    trainer (`train_flownet_c_bf16`), and its `train` and `eval` from the
    command line (`cli_train_flownet_c_bf16`): the bf16 kernels once a
    step and the float32 correlation kernels never;
  - FlowNet-CS steps repeated bit for bit under cuDNN deterministic,
    with the fixed-weight flow upsample and, for comparison, with
    `F.interpolate`'s (`repeat_flownet_cs`);
  - training on MPI-Sintel T-frame volumes (`cli_sintel`): a Sintel tree
    of PNG frames and .flo flows at 436x1024 written here, `train
    --preset sintel --model flownet_s` for 4 steps at full width (T = 10,
    224x480 crops, batch 4: 36 folded frame pairs in the loss's one
    launch of each warp kernel) with visuals, in the cached decode route
    and, where the native decoder has a PNG codec, the streaming one;
    `eval --dump-visuals`; both warp kernels at that volume shape bit
    for bit against their plain versions (`check_warp_volume`);
  - the rest of the training job (FlowNet-C at full width, 384x512,
    batch 4, f32, cuDNN deterministic): `train --set
    optim.grad_accum=2 --trace` for 8 micro-steps at 2 steps a call, at
    1, and at 2 under remat (`cli_train_job`: the correlation forward
    twice a micro-step under remat; losses, evals and final checkpoints
    equal bit for bit; the trace's spans, the heartbeat's device memory,
    model TFLOP/s and the nominal MFU), and a run in a process of its
    own with injected faults, preempted by a SIGTERM, then resumed past
    a corrupted checkpoint (`cli_preempt_faults`: equal bit for bit to
    an uninterrupted run with the same faults). Their launches are the
    float32 kernels' `launches` in the final line. Since port slice 13
    the training job also runs at `train.pipeline_depth=0` beside the
    default 2 (the metrics fetched on the fetcher's thread; the same bits
    at both depths), with each depth's idle share (`job_idle`) and the
    optimizer's device time (`optimizer_ms`);
  - serving over HTTP (`serve/server.py`): `serve_http`, the server on a
    thread of this process over full-width FlowNet-C in f32 and bf16 with
    warm-start sessions (32 requests from 4 threads against
    `engine.submit`, `flo` and `png` replies, lapsed deadlines (504), the
    brownout fold, a 12-frame stream and its DELETE, /healthz and
    /metrics; the correlation once a cold dispatch, the warp once a warm
    one), and `cli_serve`, `python -m deepof_tpu_torch serve` on the
    training job's checkpoint in a process of its own (one request,
    SIGTERM, exit 0) and its offline mode against `predict`;
  - the serving fleet on the training job's checkpoint (each
    replica-<i>/ckpt linked to it), every replica a process of its own
    on the card: `serve_fleet` (`serve` alone, then `serve --replicas
    2` under the same load: requests/s and client p50/p99, warm-start
    streams, every flow against `engine.submit` in this process, the
    replicas' own launch counts, no CUDA context in the supervisor; on
    the same fleet a crash drill: a replica SIGKILLed mid-load,
    failover, one eviction and one respawn, its spawn-to-ready seconds
    and the card's memory; then streams on the respawned fleet and a
    SIGTERM drain that leaves no replica running) and `serve_autoscale`
    (`--autoscale` with two buckets and two tiers and the brownout
    controller: a burst, the level up to >= L1, a scale-up, calm, L0 and
    one retirement; every flow against `engine.submit` at the tier and
    bucket its reply names).
  - the paper's flagship model, Inception-v3 at full width (44.55 M
    parameters): `cli_train_inception` (`train --preset flyingchairs
    --synthetic` at 320x448, batch 4, for 6 steps with the fit's step,
    busy time and idle share; `eval`; `predict` on two pairs; both warp
    kernels at its six levels bit for bit against the plain versions;
    one step with the kernels against the plain warps in float32 and in
    bf16 compute; and F17: an `InferenceEngine` in a fresh process with
    PyTorch's TF32 defaults, whose flow equals `predict`'s),
    `cli_sintel_inception` (`train --preset sintel` on the Sintel tree,
    T = 10, and the warps at that volume's shapes bit for bit) and
    `cli_bench` (`python -m deepof_tpu_torch bench` at its defaults, the
    JAX headline: batch 16, bf16, 4 steps a call; and the warps at the
    bench's shapes bit for bit).
  - the paper's VGG16 flow model at full width (18.92 M parameters):
    `cli_train_vgg` (`train --preset flyingchairs_vgg` on a FlyingChairs
    tree at 320x448, batch 8, f32, with geometric and photometric
    augmentation on the card, depthwise smoothness and the trunk from a
    random npz of the public `vgg16_weights.npz`'s names and shapes; the
    fit's step, busy time, idle share, TFLOP/s and peak memory; `eval`
    and `predict`; a short run with `loss.occlusion`; the augmentation's
    warp, the warps at VGG's five levels and the occlusion warp (C = 2)
    bit for bit against the plain versions; one step with the kernels
    against the plain warps).
  - the UCF-101 two-stream action models at full width (320x384, batch
    8, 101 classes): `cli_train_ucf101` (`train --preset ucf101`,
    st_single, on a PPM tree with UCF-101's layout, the trunk from the
    random npz; the fit's step, busy time, idle share, TFLOP/s, peak
    memory, the one checkpoint's bytes and its save's and verification's
    seconds; `eval` (accuracy) and `predict --action`; a step each of
    st_baseline and ucf101_spatial; `bench --data-only --dataset
    ucf101`; the warps at the five and six levels of the two-stream
    models bit for bit; one st_single step with its dropout masks with
    the kernels against the plain warps).
  - `loss.gather_dtype=bfloat16`: the warps' bf16 instances on every
    route (xla, pallas, auto) bit for bit the plain versions at
    FlowNet-S's six full-width loss levels and at the Sintel volume's
    (`check_warp_levels_bf16`, timed beside their byte bound and
    grid_sample on bf16), and `train --set loss.gather_dtype=bfloat16`
    at full width under warp_impl auto and xla (`cli_train_gather_bf16`:
    the bf16 instances once a step and an eval forward, the float32
    ones never; a kernel step against a plain one);
  - label-free quality scoring and the incident plane on `serve_http`:
    half its requests scored through the float32 warp on the head grid
    (its launches on their own counter, equal to the scored count), the
    triples against the numpy reference, then the `replica_degrade`
    fault driving the drift verdict to exhaustion, one committed
    `quality_drift` bundle, and `python -m deepof_tpu_torch incidents`
    list (rc 1), `tail` (rc 9: the unacknowledged critical bundle), ack,
    `tail` (rc 7: the exhausted quality verdict), list (rc 0).
  - the staged recipe at full width (`cli_recipe`: `train --recipe`
    from the flyingchairs preset over three stages, "chairs"
    (Inception-v3 on a FlyingChairs + Sintel-pairs mixture), "sintel"
    (T = 10 volumes, advancing on its eval plateau or a step backstop)
    and "ucf101" (st_single); a run cut inside the first stage and its
    resume there; the warps counted from 0 over each stage's fit; the
    prebuild and no library built after it; `bench --data-only
    --recipe`; `predict --action` from the last stage's checkpoints;
    `analyze` and `tail`), and the verbs that read a run on the earlier
    phases' directories: `tail` of the training job's traced run (rc 0,
    its heartbeat at the fit's end), and `tail --fleet` (rc 4: the
    eviction), `analyze` and `obs/aggregate.py::aggregate_run` (one
    merged trace, requests chained from the router into the replicas) of
    the fleet drill.
  - the executable ledger (`obs/ledger.py`): every training phase's
    trainer and every engine write their rows; `cli_train`'s train and
    eval steps (each row of the JAX ROW_KEYS, its libraries found
    built), `tail --ledger-baseline` of the resumed run against
    `cli_train`'s rows (rc 0: the same fingerprints, no library built),
    the same gate against the FlowNet-C run's ledger (`ledger_gate`: rc
    8, `train_step` drifted, a `ledger_drift` bundle), the training
    job's rows (K = 2, K = 1 and remat three computations), one row per
    warmed (bucket, tier, mode) and the quality scorer's in
    `serve_http`, and the fleet replicas' rows read by `tail --fleet`
    against replica 0's (no fingerprint drift, no rebuild); the line
    `ledger` gives the FlowNet-C train step's and serving forward's
    FLOPs, temp bytes and first-call seconds, the trace passes' own
    seconds, and the replicas' boot split (`boot`: the torch import,
    the CUDA context, the library load, the restore, the engine,
    `warm()`, from each replica's final record).
  - data parallelism over ranks (`parallel/mesh.py`) and the elastic
    pool (`train/elastic.py`), every rank and host a process of its own
    on the one card: `ddp_flownet_c` (`torchrun --nproc_per_node 2 -m
    deepof_tpu_torch train --multihost` and each rank's summary; then,
    with nothing else running, two ranks over gloo: their averaged
    gradient of full-width FlowNet-C's global batch 8 against this
    process's one-process step, each rank's launches, step and
    all-reduce milliseconds),
    `ddp_nccl_world1` (one rank over NCCL against the plain `train`, both
    under cuDNN's deterministic algorithms: every loss the same bits);
    in the same two ranks after their DDP check, spatial and temporal
    context parallelism: full-width FlowNet-C over mesh.spatial=2
    (`spatial_flownet_c`), the sintel preset's FlowNet-S volume over
    mesh.time=2 (`time_volume`), and every other family over
    mesh.spatial=2 at full width at its preset's geometry
    (`spatial_inception_volume`, `spatial_vgg16`, `spatial_flownet_cs`,
    `spatial_st_single`, `spatial_st_baseline`,
    `spatial_ucf101_spatial`), each against this process's one-process
    step; `spatial_cli`, `train --multihost --set mesh.spatial=2`; and
    `elastic_drill` (`python -m
    deepof_tpu_torch.tools.elastic_drill` with 3 full-width FlowNet-C
    hosts, host 1 SIGKILLed at step 4: its verdict and each surviving
    host's launches).
Runs live in a temporary directory under `build/`, removed at the end.
Each phase prints one JSON line; the last three lines are the kernel
summary, the card's name and power limit, and {"ok": true, "device":
{...}}. Any failure exits non-zero with no such line; so does a host
without a GPU.

One check alone, on the card (each builds what it needs):
    python3 -c "import chip_smoke as cs; cs.check_corr_bwd((4, 256, 48, 64), 20, 2, 0, bitwise=True)"
    python3 -c "import chip_smoke as cs; cs.check_warp_levels()"
    python3 -c "import chip_smoke as cs; cs.check_warp_volume()"
    python3 -c "import chip_smoke as cs; cs.step_kernels()"
    python3 -c "import chip_smoke as cs; cs.fit_variants()"
    python3 -c "import chip_smoke as cs, tempfile; w = tempfile.mkdtemp(dir=cs.work_root()); cs.cli_train_job(w); cs.cli_preempt_faults(w)"
    python3 -c "import chip_smoke as cs; from deepof_tpu_torch.core.config import ExperimentConfig; cs.serve_http(ExperimentConfig(model='flownet_c'))"
    python3 -c "import os, tempfile, chip_smoke as cs; w = tempfile.mkdtemp(dir=cs.work_root()); r = os.path.join(w, 'run'); cs.run_cli(['train', *cs.SERVE_RUN, '--steps', '2', '--log-dir', r], os.path.join(w, 't.log')); cs.serve_fleet(w, r); cs.serve_autoscale(w, r, cs.spawn_autoscale(w, r))"
    python3 -c "import tempfile, chip_smoke as cs; w = tempfile.mkdtemp(dir=cs.work_root()); r = cs.cli_train_inception(w); cs.f17_engine(w, r)(); cs.inception_vs_plain(w); cs.cli_sintel_inception(w); cs.cli_bench(w)"
    python3 -c "import tempfile, chip_smoke as cs; w = tempfile.mkdtemp(dir=cs.work_root()); cs.cli_train_vgg(w); cs.vgg_step_vs_plain(w)"
    python3 -c "import tempfile, chip_smoke as cs; w = tempfile.mkdtemp(dir=cs.work_root()); cs.cli_train_ucf101(w); cs.ucf101_step_vs_plain(w)"
    python3 -c "import tempfile, chip_smoke as cs; cs.check_warp_levels_bf16(); w = tempfile.mkdtemp(dir=cs.work_root()); cs.cli_train_gather_bf16(w)"
    python3 -c "import tempfile, chip_smoke as cs; from deepof_tpu_torch.ops.cuda import build; build.build_all(); w = tempfile.mkdtemp(dir=cs.work_root()); cs.cli_recipe(w)"
    python3 -c "import tempfile, chip_smoke as cs; from deepof_tpu_torch.ops.cuda import build; build.build_all(); w = tempfile.mkdtemp(dir=cs.work_root()); cs.cli_train(w); cs.cli_resume(w); cs.cli_train_flownet_c(w); from deepof_tpu_torch.core.config import ExperimentConfig; cs.ledger_gate(w, cs.serve_http(ExperimentConfig(model='flownet_c')))"
    python3 -c "import tempfile, chip_smoke as cs; from deepof_tpu_torch.ops.cuda import build; build.build_all(); w = tempfile.mkdtemp(dir=cs.work_root()); cs.ddp_phases(w); cs.elastic_drill_card(w)"
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

# Data-sheet peaks of one H100 SXM (dense): float32 outside the tensor
# cores, bf16 on the tensor cores, and HBM3 bandwidth. The bound of a
# kernel is the larger of its operations over the peak for its inputs'
# type and its bytes over the bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

KERNEL_TOL = 1e-4  # kernel vs plain version, float32 (summation order)
SERVE_TOL = 1e-3   # served raw flow vs the same model with the plain corr
WARP_TOL = 1e-5       # warp forward vs plain version, float32
WARP_GRAD_TOL = 1e-4  # flow gradient vs autograd of the plain version
# one train step with the warp kernels vs the plain warp, same weights and
# batch: the loss, relative, and each parameter's gradient, as the
# largest difference over the largest entry of that tensor
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
TRAIN_STEPS = 6
# (B, C, H, W) of the six pyramid levels of the training loss at
# 384x512, batch 4: the warp's shapes on the main path
WARP_LEVELS = [(4, 3, 192 >> k, 256 >> k) for k in range(6)]
# calls per device-time reading of a warp kernel (2-7 us each), and
# readings per kernel, taken in turns with the library call (3 until the
# bf16 warp and quality checks came; 2 keeps the script under 800 s)
WARP_ITERS = 200
WARP_ROUNDS = 2
# aten ops that make a copy; none may run inside the warp's autograd ops
COPY_OPS = ("aten::copy_", "aten::contiguous", "aten::clone")


# the script's start, for the seconds each phase line is printed at
START = time.monotonic()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, "at_s": time.monotonic() - START,
                      **kw}), flush=True)


#: [label, start (seconds since START), seconds] of each command-line
#: call, verb and serving process of the run, in order (`spanned`); the
#: `timeline` line prints them
TIMELINE: list = []


@contextlib.contextmanager
def spanned(label: str):
    """Time the block into TIMELINE under `label`."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        TIMELINE.append([label, round(t0 - START, 2),
                         round(time.monotonic() - t0, 2)])


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    """Median over `iters` runs of one call, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, iters: int = 20) -> float:
    """Device time of one call: the device-side events (kernels and
    copies) of `iters` calls from torch.profiler, per call. A small
    kernel's CUDA-event time (`time_ms`) is the host's launch time
    instead."""
    return device_ms_by_name(fn, ("",), iters)[""]


def device_ms_by_name(fn, names, iters: int = 20) -> dict[str, float]:
    """{name: device time per call of the device-side events whose name
    contains it} over `iters` calls of `fn`, from torch.profiler ("":
    all of them)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session that recorded no device event is redone
        with torch_profile(activities=[ProfilerActivity.CUDA],
                           acc_events=True) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = device_kernels(prof, iters)
        out = {n: sum(t for t, k in rows if n in k) for n in names}
        if all(v > 0 for v in out.values()):
            return out
    raise AssertionError(f"torch.profiler recorded no device time for "
                         f"{names}")


def corr_bound_ms(b, c, h, w, max_disp, stride,
                  elem_bytes: int = 4) -> tuple[float, str]:
    """The bound of the correlation and of each of its backward kernels
    (the same work): one FMA a channel for each pixel and displacement
    whose shifted pixel lies inside the image (the others meet the zero
    padding and need none), at the peak for the inputs' type (float32,
    or bf16 on the tensor cores: the kernels' own float32 FMAs on bf16
    data are their design, not the function's need), against the bytes
    of two C-channel maps and one (2K+1)**2-channel map of `elem_bytes`
    each (4 float32, 2 bf16), each moved once."""
    k = max_disp // stride
    n = 2 * k + 1
    offs = [(i - k) * stride for i in range(n)]
    rows = sum(max(h - abs(d), 0) for d in offs)
    cols = sum(max(w - abs(d), 0) for d in offs)
    peak = PEAK_BF16_FLOPS if elem_bytes == 2 else PEAK_F32_FLOPS
    t_ops = 2.0 * b * rows * cols * c / peak
    t_bytes = (elem_bytes * (2 * b * c * h * w + b * n * n * h * w)
               / PEAK_BYTES_S)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


# the kernels' dtypes: (torch dtype name, launch-counter suffix)
DTYPES = {"float32": "", "bfloat16": "_bf16"}
CORR_KERNELS = ("corr", "corr_bwd_f1", "corr_bwd_f2")


def bf16_ulps(got, want) -> float:
    """The largest |got - want| in bf16 ulps of `want`, an ulp being that
    of max(|want|, 2**-12 * max |want|): near a sum that cancels to ~0,
    a float32 difference of the order of the terms' rounding is many ulps
    of the small result, and the floor keeps those out of the count."""
    import torch

    w = want.float().abs()
    floor = w.max().clamp_min(1e-30) * 2.0 ** -12
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(w, floor))) - 7)
    return ((got.float() - want.float()).abs() / ulp).max().item()


def check_corr(shape, max_disp, stride, seed, bitwise=False,
               dtype="float32"):
    """Kernel vs correlation_reference on the card at one NCHW shape, in
    `dtype` (float32 or bfloat16): with `bitwise`, `torch.equal` (C = 256:
    the same sums in the same order, and 1/C exact); otherwise within
    KERNEL_TOL (float32) or one bf16 ulp (`bf16_ulps`). A bf16 call must
    also be bit for bit the float32 kernel on the upcast inputs, rounded
    to bf16. The kernel and the plain version are timed twice: device
    time (`ms`, `plain_ms`, torch.profiler) and the CUDA-event time of
    one call, host launch included (`call_ms`, `plain_call_ms`); with
    the registers and spills of the kernel's template instances of this
    dtype (nvcc's `-Xptxas -v`)."""
    import torch

    from deepof_tpu_torch.ops.corr import correlation_reference
    from deepof_tpu_torch.ops.cuda import build
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda

    bf16 = dtype == "bfloat16"
    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(shape, device="cuda", generator=g).to(getattr(torch,
                                                                   dtype))
    f2 = torch.randn(shape, device="cuda", generator=g).to(f1.dtype)
    got = correlation_cuda(f1, f2, max_disp, stride)
    want = correlation_reference(f1, f2, max_disp, stride)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    bound, bound_by = corr_bound_ms(*shape, max_disp, stride,
                                    f1.element_size())

    def kernel():
        return correlation_cuda(f1, f2, max_disp, stride)

    def plain():
        return correlation_reference(f1, f2, max_disp, stride)

    row = {"shape": list(shape), "max_disp": max_disp, "stride": stride,
           "dtype": dtype, "max_abs_err": err,
           "bitwise_equal": bool(torch.equal(got, want)),
           "ms": device_ms(kernel),
           "call_ms": time_ms(kernel), "plain_ms": device_ms(plain, iters=3),
           "plain_call_ms": time_ms(plain, warmup=1, iters=5),
           "bound_ms": bound, "bound_by": bound_by,
           "ptxas": ptxas_usage(build.build("corr")["log"], "corr_fwd",
                                bf16)}
    if bf16:
        rounded = correlation_cuda(f1.float(), f2.float(), max_disp,
                                   stride).bfloat16()
        row.update(max_ulps=bf16_ulps(got, want),
                   equals_f32_kernel_rounded=bool(torch.equal(got, rounded)))
    name = "corr" + DTYPES[dtype]
    emit("kernels", kernel=name, **row)
    close = (row["max_ulps"] <= 1 if bf16 else err <= KERNEL_TOL)
    if not ((row["bitwise_equal"] if bitwise else close)
            and row.get("equals_f32_kernel_rounded", True)):
        raise AssertionError(
            f"{name} kernel disagrees at {shape}: max abs err {err} ("
            + ("not bitwise equal" if bitwise else
               "limit one bf16 ulp" if bf16 else f"limit {KERNEL_TOL}")
            + f"), or not the float32 kernel rounded: {row}")
    return row


def ptxas_usage(log: str, kernel: str,
                bf16: bool = False) -> dict[str, dict]:
    """{"stride <S>" or "any stride": {"registers", "spill_stores",
    "spill_loads"}} of each template instance of `kernel` (a template
    on the stride, 0 being the generic instance, and on the element
    type: the bf16 instances with `bf16`, else the float32 ones), read
    from nvcc's `-Xptxas -v` output."""
    out: dict[str, dict] = {}
    entry = None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            entry = m.group(1)
            continue
        if (entry is None or kernel not in entry
                or ("nv_bfloat16" in entry) != bf16):
            continue
        stride = int(re.search(r"ILi(\d+)E", entry).group(1))
        key = f"stride {stride}" if stride else "any stride"
        row = out.setdefault(key, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            row["spill_stores"], row["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            row["registers"] = int(m.group(1))
    return out


def check_corr_bwd(shape, max_disp, stride, seed, timed=True,
                   bitwise=False, dtype="float32"):
    """Both backward kernels (`correlation_bwd_cuda`) vs
    correlation_backward_reference on the card at one NCHW shape: with
    `bitwise`, both gradients `torch.equal` to the plain backward (the
    training shape: C = 256, the same sums in the same order); otherwise
    the max abs error of each gradient relative to its largest entry,
    within KERNEL_TOL. Two calls must be bitwise equal (no atomics). With
    `timed`, each kernel's device time (torch.profiler, by kernel name;
    WARP_ROUNDS readings, `ms_runs`, the median reported), the CUDA-event
    time of one wrapper call (both launches), the plain backward's device
    and call times (both gradients at once), and each kernel's registers
    and spills by template instance (nvcc's `-Xptxas -v`). In bfloat16
    (`dtype`), each gradient must also be bit for bit the float32
    kernel's on the upcast inputs, rounded to bf16, and the non-bitwise
    limit is one bf16 ulp (`bf16_ulps`) in place of KERNEL_TOL."""
    import torch

    from deepof_tpu_torch.ops.corr import correlation_backward_reference
    from deepof_tpu_torch.ops.cuda import build
    from deepof_tpu_torch.ops.cuda.corr import correlation_bwd_cuda

    bf16 = dtype == "bfloat16"
    b, c, h, w = shape
    n = 2 * (max_disp // stride) + 1
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f1, f2, g = (torch.randn(s, device="cuda", generator=gen).to(
        getattr(torch, dtype)) for s in (shape, shape, (b, n * n, h, w)))

    def kernel():
        return correlation_bwd_cuda(f1, f2, g, max_disp, stride)

    def plain():
        return correlation_backward_reference(f1, f2, g, max_disp, stride)

    got, again, want = kernel(), kernel(), plain()
    rounded = ([t.bfloat16() for t in correlation_bwd_cuda(
        f1.float(), f2.float(), g.float(), max_disp, stride)]
        if bf16 else want)
    torch.cuda.synchronize()
    row = {"shape": list(shape), "max_disp": max_disp, "stride": stride,
           "dtype": dtype,
           "bitwise_repeatable": all(torch.equal(a, r)
                                     for a, r in zip(got, again))}
    for name, a, r, r32 in zip(("corr_bwd_f1", "corr_bwd_f2"), got, want,
                               rounded):
        scale = r.float().abs().max().item()
        diff = (a.float() - r.float()).abs().max().item()
        row[name] = {"max_abs_err": diff, "max_abs_grad": scale,
                     "rel_err": diff / max(scale, 1e-30),
                     "bitwise_equal": bool(torch.equal(a, r))}
        if bf16:
            row[name].update(max_ulps=bf16_ulps(a, r),
                             equals_f32_kernel_rounded=bool(
                                 torch.equal(a, r32)))
    if timed:
        runs = [device_ms_by_name(kernel, ("corr_bwd_f1", "corr_bwd_f2"))
                for _ in range(WARP_ROUNDS)]
        row.update({"call_ms": time_ms(kernel),
                    "plain_ms": device_ms(plain, iters=3),
                    "plain_call_ms": time_ms(plain, warmup=1, iters=5),
                    **dict(zip(("bound_ms", "bound_by"),
                               corr_bound_ms(*shape, max_disp, stride,
                                             f1.element_size())))})
        log = build.build("corr_bwd")["log"]
        for name in ("corr_bwd_f1", "corr_bwd_f2"):
            row[name]["ms_runs"] = [r[name] for r in runs]
            row[name]["ms"] = statistics.median(row[name]["ms_runs"])
            row[name]["ptxas"] = ptxas_usage(log, name, bf16)
    emit("kernels", kernel="corr_bwd" + DTYPES[dtype], **row)
    names = ("corr_bwd_f1", "corr_bwd_f2")

    def close(r):
        return r["max_ulps"] <= 1 if bf16 else r["rel_err"] <= KERNEL_TOL

    bad = [k for k in names
           if not ((row[k]["bitwise_equal"] if bitwise else close(row[k]))
                   and row[k].get("equals_f32_kernel_rounded", True))]
    if bad or not row["bitwise_repeatable"]:
        raise AssertionError(
            f"corr backward kernels ({dtype}) at {shape}, {max_disp} / "
            f"{stride}: {bad} off the plain backward ("
            + ("not bitwise equal" if bitwise else
               "by more than one bf16 ulp" if bf16 else
               f"by more than {KERNEL_TOL} of the largest entry")
            + f"), or not the float32 kernels rounded, or two calls "
            f"differ: {row}")
    return row


def warp_bound_ms(levels, grad: bool) -> tuple[float, str]:
    """Each input read once, each output written once: image, flow and
    output (forward); image, flow, cotangent and flow cotangent
    (gradient); against the float32 operations per pixel; summed over
    the levels [(B, C, H, W)] of one launch."""
    nbytes = flops = 0.0
    for b, c, h, w in levels:
        px = b * h * w
        nbytes += 4.0 * px * ((2 * c + 4) if grad else (2 * c + 2))
        flops += px * ((6 + 14 * c) if grad else (6 + 11 * c))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def grid_sample_grid(flow):
    """The flow (B, 2, H, W) as F.grid_sample's grid (B, H, W, 2): pixel
    coordinates normalised to [-1, 1] at align_corners, with the
    normalising factor (2 / (W-1), 2 / (H-1)) that maps its gradient back
    to pixels."""
    import torch

    b, _, h, w = flow.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=flow.device),
                            torch.arange(w, device=flow.device),
                            indexing="ij")
    norm = torch.tensor([2.0 / max(w - 1, 1), 2.0 / max(h - 1, 1)],
                        device=flow.device)
    grid = ((torch.stack([xs + flow[:, 0], ys + flow[:, 1]], -1) * norm - 1)
            .detach().requires_grad_(True))
    return grid, norm


def warm_path_flow(b, h, w, mag, g):
    """A flow (B, 2, H, W) like the warm start's warp input: a smooth
    prior on the head grid (H/2, W/2), `mag` pixels there, upsampled x2
    to input resolution by `upsample_flow` (vectors doubled)."""
    import torch
    import torch.nn.functional as F

    from deepof_tpu_torch.models.flownet2 import upsample_flow

    coarse = torch.randn((b, 2, h // 32, w // 32), device="cuda",
                         generator=g) * mag
    prior = F.interpolate(coarse, size=(h // 2, w // 2), mode="bilinear",
                          align_corners=False)
    return upsample_flow(prior, (h, w))


def check_warp(shape, mag, seed, rounds=WARP_ROUNDS, bitwise=False,
               smooth=False):
    """Both warp kernels (one level per launch) vs their plain versions
    on the card at one NCHW shape, with the library yardstick
    F.grid_sample(border, align_corners=True) and its gradient with
    respect to the grid. The flow is normal, `mag` pixels, or with
    `smooth` the warm start's kind (`warm_path_flow`); with `bitwise` the
    forward must equal the plain version bit for bit (F6). Each is timed
    twice: its device time (`ms`, `plain_ms`, `library_ms`; kernel and
    library `rounds` times each, in turns, `*_runs`, the median reported)
    and the CUDA-event time of one call, host launch included
    (`*call_ms`)."""
    import torch
    import torch.nn.functional as F

    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_cuda,
                                                warp_fwd_cuda)
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    b, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(shape, device="cuda", generator=g)
    flow = (warm_path_flow(b, h, w, mag, g) if smooth else
            torch.randn((b, 2, h, w), device="cuda", generator=g) * mag)
    ct = torch.randn(shape, device="cuda", generator=g)

    def plain_grad():
        f = flow.detach().requires_grad_(True)
        return torch.autograd.grad(backward_warp_reference(img, f), f, ct)[0]

    got, want = warp_fwd_cuda(img, flow), backward_warp_reference(img, flow)
    ggot, gwant = warp_flow_grad_cuda(img, flow, ct), plain_grad()
    grid, norm = grid_sample_grid(flow)

    def library():
        return F.grid_sample(img, grid, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib_out = library()
    lib_grad = torch.autograd.grad(lib_out, grid, ct, retain_graph=True)[0]
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    gerr = (ggot - gwant).abs().max().item()
    fwd_bound, fwd_by = warp_bound_ms([shape], grad=False)
    grad_bound, grad_by = warp_bound_ms([shape], grad=True)

    def times(kernel, plain, lib):
        runs = {"ms_runs": [], "library_ms_runs": []}
        for _ in range(rounds):
            runs["ms_runs"].append(device_ms(kernel, WARP_ITERS))
            runs["library_ms_runs"].append(device_ms(lib, WARP_ITERS))
        return {"ms": statistics.median(runs["ms_runs"]),
                "library_ms": statistics.median(runs["library_ms_runs"]),
                **runs, "plain_ms": device_ms(plain),
                **{k: time_ms(fn) for k, fn in (
                    ("call_ms", kernel), ("plain_call_ms", plain),
                    ("library_call_ms", lib))}}

    row = {
        "shape": list(shape), "flow_scale": mag, "smooth_flow": smooth,
        "flow_abs_max": flow.abs().max().item(),
        "fwd": {"max_abs_err": err,
                "bitwise_equal": bool(torch.equal(got, want)),
                **times(lambda: warp_fwd_cuda(img, flow),
                        lambda: backward_warp_reference(img, flow), library),
                "library_vs_plain_max_abs": (lib_out - want).abs().max()
                .item(),
                "bound_ms": fwd_bound, "bound_by": fwd_by},
        "flow_grad": {"max_abs_err": gerr,
                      **times(lambda: warp_flow_grad_cuda(img, flow, ct),
                              plain_grad,
                              lambda: torch.autograd.grad(
                                  lib_out, grid, ct, retain_graph=True)),
                      "library_vs_plain_max_abs": (
                          lib_grad * norm).permute(0, 3, 1, 2)
                      .sub(gwant).abs().max().item(),
                      "bound_ms": grad_bound, "bound_by": grad_by}}
    emit("kernels", kernel="warp", **row)
    fwd_ok = row["fwd"]["bitwise_equal"] if bitwise else err <= WARP_TOL
    if not (fwd_ok and gerr <= WARP_GRAD_TOL):
        raise AssertionError(f"warp kernels disagree at {shape} x{mag}: "
                             f"forward {err} (limit "
                             f"{'bitwise' if bitwise else WARP_TOL}), flow "
                             f"gradient {gerr} (limit {WARP_GRAD_TOL})")
    return row


def nonfinite_flow(shape, seed):
    """(image, flow, cotangent) on the card, NCHW, with NaN, +-inf and
    huge finite entries in the flow."""
    import torch

    b, c, h, w = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    img = torch.rand(shape, device="cuda", generator=g)
    flow = torch.randn((b, 2, h, w), device="cuda", generator=g) * 3
    ct = torch.randn(shape, device="cuda", generator=g)
    nan, inf = float("nan"), float("inf")
    for bi, ci, y, x, val in [
            (0, 0, 2, 3, nan), (0, 1, 4, 5, inf), (1, 0, 6, 7, -inf),
            (1, 1, 8, 9, 3e38), (0, 0, 10, 11, inf), (0, 1, 10, 11, nan),
            (1, 0, 12, 13, -3e38), (1, 1, 1, 2, -inf),
            # a NaN weight beside a side saturated at the left or top
            (0, 0, 5, 6, nan), (0, 1, 5, 6, -50.0),
            (1, 0, 9, 10, -50.0), (1, 1, 9, 10, nan)]:
        flow[bi, ci, y, x] = val
    return img, flow, ct


def check_warp_nonfinite(shape=(2, 3, 16, 20), seed=10):
    """Both warp kernels vs their plain versions on NaN, inf and huge
    flows: the same values, NaN where the plain version gives NaN."""
    import torch

    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_cuda,
                                                warp_fwd_cuda)
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    img, flow, ct = nonfinite_flow(shape, seed)
    got = warp_fwd_cuda(img, flow)
    ggot = warp_flow_grad_cuda(img, flow, ct)
    f = flow.detach().requires_grad_(True)
    want = backward_warp_reference(img, f)
    gwant = torch.autograd.grad(want, f, ct)[0]
    torch.cuda.synchronize()
    same = (torch.allclose(got, want.detach(), rtol=0, atol=WARP_TOL,
                           equal_nan=True)
            and torch.allclose(ggot, gwant, rtol=0, atol=WARP_GRAD_TOL,
                               equal_nan=True))
    emit("kernels", kernel="warp_nonfinite", shape=list(shape),
         nan_outputs=int(got.isnan().sum()),
         nan_flow_grads=int(ggot.isnan().sum()), agree=same)
    if not same:
        raise AssertionError("warp kernels disagree with the plain version "
                             "on non-finite flows")


def check_warp_levels(mag=5.0, seed=20, levels=None, kernel="warp_levels"):
    """Six levels (default the main path's, WARP_LEVELS) through one
    launch per direction, in the loss's layouts (images and cotangents
    as views of NHWC memory, planar flows), on normal flows of `mag` px:
    `warp_levels_row`."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    images, flows, cts = [], [], []
    for b, c, h, w in levels or WARP_LEVELS:
        images.append(torch.rand((b, h, w, c), device="cuda", generator=g)
                      .permute(0, 3, 1, 2))
        flows.append(torch.randn((b, 2, h, w), device="cuda", generator=g)
                     * mag)
        cts.append(torch.randn((b, h, w, c), device="cuda", generator=g)
                   .permute(0, 3, 1, 2))
    return warp_levels_row(kernel, images, flows, cts, g)


def warp_levels_row(kernel, images, flows, cts, g):
    """Levels (NCHW views) through one launch per direction: each level
    bit for bit its plain versions (`backward_warp_reference`,
    `warp_flow_grad_reference`); the two launches' device time
    (WARP_ROUNDS readings of WARP_ITERS calls each) beside the sums of
    the per-level bounds and of one grid_sample call a level (forward,
    and backward with respect to the grid), taken in turns; the same
    launches on a smooth flow (a 2.3 px shift plus 0.3 px of noise, where
    neighbouring pixels gather from the same rows); and the device
    kernels of one autograd forward and backward of `BackwardWarpLevels`
    on those views: the two warp kernels, no copy."""
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_levels_cuda,
                                                warp_fwd_levels_cuda)
    from deepof_tpu_torch.ops.warp import (BackwardWarpLevels,
                                           backward_warp_reference,
                                           warp_flow_grad_reference)

    shapes = [tuple(i.shape) for i in images]
    outs = warp_fwd_levels_cuda(images, flows)
    grads = warp_flow_grad_levels_cuda(images, flows, cts)
    levels = []
    for img, fl, ct, out, grad in zip(images, flows, cts, outs, grads):
        want = backward_warp_reference(img, fl)
        gwant = warp_flow_grad_reference(img, fl, ct)
        levels.append({"shape": list(img.shape),
                       "bitwise_equal": bool(torch.equal(out, want)),
                       "max_abs_err": (out - want).abs().max().item(),
                       "flow_grad_bitwise_equal": bool(torch.equal(grad,
                                                                   gwant)),
                       "flow_grad_max_abs_err": (grad - gwant).abs().max()
                       .item(),
                       "flow_abs_max": fl.abs().max().item()})
    grids = [grid_sample_grid(fl)[0] for fl in flows]

    def library():
        return [F.grid_sample(i, gr, mode="bilinear", padding_mode="border",
                              align_corners=True)
                for i, gr in zip(images, grids)]

    lib_outs = library()

    def library_grad():
        return torch.autograd.grad(lib_outs, grids, cts, retain_graph=True)

    def plain():
        return [backward_warp_reference(i, f) for i, f in zip(images, flows)]

    def plain_grad():
        return [warp_flow_grad_reference(i, f, c)
                for i, f, c in zip(images, flows, cts)]

    def fwd():
        return warp_fwd_levels_cuda(images, flows)

    def bwd():
        return warp_flow_grad_levels_cuda(images, flows, cts)

    smooth = [torch.full_like(f, 2.3)
              + 0.3 * torch.randn(f.shape, device="cuda", generator=g)
              for f in flows]

    def fwd_smooth():
        return warp_fwd_levels_cuda(images, smooth)

    def bwd_smooth():
        return warp_flow_grad_levels_cuda(images, smooth, cts)

    runs = {k: [] for k in ("fwd", "library_fwd", "grad", "library_grad",
                            "fwd_smooth", "grad_smooth")}
    for _ in range(WARP_ROUNDS):
        for k, fn in (("fwd", fwd), ("library_fwd", library),
                      ("grad", bwd), ("library_grad", library_grad),
                      ("fwd_smooth", fwd_smooth),
                      ("grad_smooth", bwd_smooth)):
            runs[k].append(device_ms(fn, WARP_ITERS))

    fs = [f.detach().requires_grad_(True) for f in flows]
    # one autograd forward and backward: its launches by the wrappers'
    # counters, the ops inside its autograd ops (no copy) from the CPU
    # trace, and its device kernels where CUPTI recorded them. On the
    # H100 machine a short session after other profiled work (a fit's
    # StepWindow) has recorded no device event, or only the second of
    # the two, in 5 tries of 5; such a session is redone, 3 times at
    # most, and the row says whether the device kernels were seen
    from deepof_tpu_torch.ops.cuda import warp as cw

    for _ in range(3):
        before = (cw.fwd_launches.count, cw.grad_launches.count)
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           acc_events=True) as prof:
            o = BackwardWarpLevels.apply(len(images), *images, *fs)
            torch.autograd.grad(o, fs, cts)
            torch.cuda.synchronize()
        autograd_launches = (cw.fwd_launches.count - before[0],
                             cw.grad_launches.count - before[1])
        autograd_kernels = device_kernel_counts(prof)
        if sum(autograd_kernels.values()) >= 2:
            break
    seen = sum(autograd_kernels.values()) >= 2
    autograd_copies = sorted({n for names in warp_op_children(prof).values()
                              for n in names if n in COPY_OPS})

    def direction(key, kernel_fn, plain_fn, lib_key, grad):
        bound, bound_by = warp_bound_ms(shapes, grad)
        return {"ms": statistics.median(runs[key]), "ms_runs": runs[key],
                "library_ms": statistics.median(runs[lib_key]),
                "library_ms_runs": runs[lib_key],
                "smooth_flow_ms": statistics.median(runs[key + "_smooth"]),
                "smooth_flow_ms_runs": runs[key + "_smooth"],
                "plain_ms": device_ms(plain_fn),
                "call_ms": time_ms(kernel_fn),
                "bound_ms": bound, "bound_by": bound_by}

    row = {"levels": levels,
           "fwd": {**direction("fwd", fwd, plain, "library_fwd", False),
                   "bitwise_equal": all(r["bitwise_equal"] for r in levels),
                   "max_abs_err": max(r["max_abs_err"] for r in levels)},
           "flow_grad": {**direction("grad", bwd, plain_grad, "library_grad",
                                     True),
                         "bitwise_equal": all(r["flow_grad_bitwise_equal"]
                                              for r in levels),
                         "max_abs_err": max(r["flow_grad_max_abs_err"]
                                            for r in levels)},
           "library": f"{len(images)} F.grid_sample(bilinear, border, "
                      "align_corners=True) calls; their autograd.grad wrt "
                      "the grids",
           "plain": "backward_warp_reference and warp_flow_grad_reference "
                    "level by level",
           "autograd_launches": list(autograd_launches),
           "autograd_copy_ops": autograd_copies,
           "autograd_device_kernels": autograd_kernels,
           "autograd_device_kernels_seen": seen}
    emit("kernels", kernel=kernel, **row)
    if not (row["fwd"]["bitwise_equal"] and row["flow_grad"]["bitwise_equal"]):
        raise AssertionError(f"{kernel}: fused warp launch disagrees with "
                             f"the plain versions: {levels}")
    if autograd_launches != (1, 1) or autograd_copies or (seen and (
            len(autograd_kernels) != 2 or sum(autograd_kernels.values()) != 2
            or not all("warp_" in k for k in autograd_kernels))):
        raise AssertionError(f"{kernel}: one autograd forward and backward "
                             f"of the levels launched {autograd_launches}, "
                             f"ran the ops {autograd_copies} and the device "
                             f"kernels {autograd_kernels}; want one warp "
                             f"kernel each way and no copy")
    return row


def check_warp_volume(seed=21, model_name="flownet_s"):
    """Both warp kernels at the Sintel volume loss's shape: the `sintel`
    preset's crop (224x480, batch 4, T = 10), six levels of B(T-1) = 36
    folded pairs, one launch per direction (`warp_levels_row`). The
    images are a random volume, LRN-normalised, resized to each level and
    folded as the loss folds them; the flows are an untrained full-width
    `model_name`'s on that volume, scaled (FlowNet-S: 112x240 down to
    4x8; Inception-v3: 112x240 down to 7x15, 28x60 twice); the
    cotangents normal."""
    import torch

    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.losses.pyramid import _resize, lrn_normalize
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.ops.warp import fold_pairs

    cfg = get_config("sintel")
    b, t = cfg.data.batch_size, cfg.data.time_step
    h, w = cfg.data.crop_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    vol = torch.rand((b, h, w, 3 * t), device="cuda", generator=g) - 0.35
    model = build_model(model_name, flow_channels=2 * (t - 1), seed=seed,
                        device="cuda")
    with torch.no_grad():
        flows = [f.permute(0, 2, 3, 1) * s for f, s in zip(
            model(vol.permute(0, 3, 1, 2).contiguous()), model.flow_scales)]
    del model
    norm = lrn_normalize(vol)
    images, fl = [], []
    for f in flows:
        nxt, flw = fold_pairs(_resize(norm, *f.shape[1:3]), f)
        images.append(nxt.permute(0, 3, 1, 2))
        fl.append(flw.permute(0, 3, 1, 2))
    cts = [torch.randn(i.shape, device="cuda", generator=g) for i in images]
    row = warp_levels_row("warp_volume" + ("" if model_name == "flownet_s"
                                           else f"_{model_name}"),
                          images, fl, cts, g)
    row["volume"] = {"model": model_name, "batch": b, "time_step": t,
                     "crop": [h, w],
                     "folded_pairs": b * (t - 1)}
    return row


# the Sintel volume loss's six levels of B(T-1) = 36 folded pairs
# (FlowNet-S at the sintel preset's 224x480 crop)
VOLUME_LEVELS = [(36, 3, 112, 240), (36, 3, 56, 120), (36, 3, 28, 60),
                 (36, 3, 14, 30), (36, 3, 7, 15), (36, 3, 4, 8)]
# the routes of a bf16 warp operand (loss.warp_impl)
GATHER_IMPLS = ("auto", "xla", "pallas")


def warp_bf16_bound_ms(levels, routes, grad: bool) -> tuple[float, str]:
    """`warp_bound_ms` of the bf16 instances: the image read at 2 bytes a
    value; the output (forward) or the cotangent (gradient) at 2 bytes on
    a Pallas-route level and 4 on an XLA-route one; the flow and the flow
    cotangent float32; the same float32 operations."""
    nbytes = flops = 0.0
    for (b, c, h, w), pallas in zip(levels, routes):
        px = b * h * w
        nbytes += px * (2 * c + 8 + (2 if pallas else 4) * c
                        + (8 if grad else 0))
        flops += px * ((6 + 14 * c) if grad else (6 + 11 * c))
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_warp_levels_bf16(levels=None, mag=5.0, seed=60,
                           kernel="warp_levels_bf16",
                           timed=("auto", "xla")) -> dict:
    """The bf16-image instances of both warp kernels over six levels in
    one launch per direction (default FlowNet-S's full-width loss levels,
    WARP_LEVELS), the images bf16 views of NHWC memory as the loss hands
    them, the flows float32, on every route of GATHER_IMPLS: each level's
    output (float32 on the XLA route, bf16 on the Pallas route) and flow
    gradient (from a cotangent of the output's dtype) bit for bit the
    plain versions'. The routes of `timed` are timed (device time, the
    median of WARP_ROUNDS readings, in turns with the library yardstick:
    F.grid_sample on the bf16 image and a bf16 grid, and its gradient
    with respect to the grid), beside the plain versions and the byte
    bound with the image at 2 bytes."""
    import torch
    import torch.nn.functional as F

    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_levels_cuda,
                                                warp_fwd_levels_cuda)
    from deepof_tpu_torch.ops.warp import (backward_warp_reference,
                                           pallas_route,
                                           warp_flow_grad_reference)

    levels = levels or WARP_LEVELS
    g = torch.Generator(device="cuda").manual_seed(seed)
    images, flows, cts32 = [], [], []
    for b, c, h, w in levels:
        images.append(torch.rand((b, h, w, c), device="cuda", generator=g)
                      .bfloat16().permute(0, 3, 1, 2))
        flows.append(torch.randn((b, 2, h, w), device="cuda", generator=g)
                     * mag)
        cts32.append(torch.randn((b, h, w, c), device="cuda", generator=g)
                     .permute(0, 3, 1, 2))
    grids = [grid_sample_grid(fl)[0].detach().bfloat16().requires_grad_(True)
             for fl in flows]
    lib_outs = [F.grid_sample(i, gr, mode="bilinear", padding_mode="border",
                              align_corners=True)
                for i, gr in zip(images, grids)]
    lib_cts = [c.bfloat16() for c in cts32]

    def library():
        return [F.grid_sample(i, gr, mode="bilinear", padding_mode="border",
                              align_corners=True)
                for i, gr in zip(images, grids)]

    def library_grad():
        return torch.autograd.grad(lib_outs, grids, lib_cts,
                                   retain_graph=True)

    row = {"shape": [list(s) for s in levels], "image_dtype": "bfloat16",
           "routes": {}}
    for impl in GATHER_IMPLS:
        routes = [pallas_route(impl, i.shape[2], i.shape[3]) for i in images]
        cts = [c.bfloat16() if p else c for c, p in zip(cts32, routes)]
        outs = warp_fwd_levels_cuda(images, flows, pallas=routes)
        grads = warp_flow_grad_levels_cuda(images, flows, cts)
        per = []
        for img, fl, ct, out, grad, p in zip(images, flows, cts, outs,
                                             grads, routes):
            want = backward_warp_reference(img, fl, p)
            gwant = warp_flow_grad_reference(img, fl, ct)
            per.append({
                "out_dtype": str(out.dtype).replace("torch.", ""),
                "bitwise_equal": bool(torch.equal(out, want)),
                "max_abs_err": (out.float() - want.float()).abs().max()
                .item(),
                "flow_grad_bitwise_equal": bool(torch.equal(grad, gwant)),
                "flow_grad_max_abs_err": (grad - gwant).abs().max().item()})
        entry = {"pallas_levels": routes, "levels": per,
                 "bitwise_equal": all(r["bitwise_equal"]
                                      and r["flow_grad_bitwise_equal"]
                                      for r in per),
                 "fwd": {"max_abs_err": max(r["max_abs_err"] for r in per)},
                 "flow_grad": {"max_abs_err": max(
                     r["flow_grad_max_abs_err"] for r in per)}}
        if impl in timed:
            rounds = WARP_ROUNDS if impl == timed[0] else 1

            def fwd(routes=routes):
                return warp_fwd_levels_cuda(images, flows, pallas=routes)

            def bwd(cts=cts):
                return warp_flow_grad_levels_cuda(images, flows, cts)

            def plain(routes=routes):
                return [backward_warp_reference(i, f, p)
                        for i, f, p in zip(images, flows, routes)]

            def plain_grad(cts=cts):
                return [warp_flow_grad_reference(i, f, c)
                        for i, f, c in zip(images, flows, cts)]

            for key, kern, pl, lib, grad in (
                    ("fwd", fwd, plain, library, False),
                    ("flow_grad", bwd, plain_grad, library_grad, True)):
                runs, lib_runs = [], []
                for _ in range(rounds):
                    runs.append(device_ms(kern, WARP_ITERS))
                    lib_runs.append(device_ms(lib, WARP_ITERS))
                bound, bound_by = warp_bf16_bound_ms(levels, routes, grad)
                entry[key].update({
                    "ms": statistics.median(runs), "ms_runs": runs,
                    "library_ms": statistics.median(lib_runs),
                    "library_ms_runs": lib_runs,
                    "plain_ms": device_ms(pl), "call_ms": time_ms(kern),
                    "bound_ms": bound, "bound_by": bound_by})
        row["routes"][impl] = entry
    row["library"] = (f"{len(levels)} F.grid_sample(bilinear, border, "
                      "align_corners=True) calls on the bf16 images and "
                      "bf16 grids; their autograd.grad wrt the grids")
    row["plain"] = ("backward_warp_reference and warp_flow_grad_reference "
                    "level by level, on the level's route")
    emit("kernels", kernel=kernel, **row)
    bad = [impl for impl, e in row["routes"].items()
           if not e["bitwise_equal"]]
    if bad:
        raise AssertionError(f"{kernel}: the bf16 warp instances disagree "
                             f"with the plain versions on the routes {bad}: "
                             f"{row['routes']}")
    return row


GATHER_STEPS = 4
GATHER_IMPLS_TRAINED = ("auto", "xla")


def cli_train_gather_bf16(work: str) -> dict:
    """`train --set loss.gather_dtype=bfloat16` at full width (FlowNet-S,
    384x512, batch 4, the CLI_TRAIN configuration) for GATHER_STEPS steps
    with an eval and a checkpoint at the last, under
    `loss.warp_impl=auto` (the default; FlowNet-S's finest level takes
    the XLA route, the five others the Pallas route, as the JAX package
    routes them on a TPU) and `xla` (every level float32 out): the loss's
    warps launch the bf16 instances, once a step and once an eval forward
    forward, once a step backward, and the float32 warp instances never.
    Then one step of the trained weights with the kernels against one
    with the plain versions (cuDNN deterministic): loss and gradients
    within TRAIN_LOSS_RTOL and TRAIN_GRAD_RTOL."""
    import torch

    from deepof_tpu_torch import cli
    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.train.loop import Trainer
    from deepof_tpu_torch.train.step import batch_to_device

    evals = eval_calls(SYNTHETIC_VAL, 4)
    t0 = time.monotonic()
    runs = {}

    def argv(impl):
        return [*CLI_TRAIN, "--set", f"train.eval_every={GATHER_STEPS}",
                "--set", f"train.ckpt_every_steps={GATHER_STEPS}",
                "--set", "loss.gather_dtype=bfloat16",
                "--set", f"loss.warp_impl={impl}", "--log-dir",
                os.path.join(work, f"cli_train_gather_bf16_{impl}")]

    for impl in GATHER_IMPLS_TRAINED:
        log_dir = os.path.join(work, f"cli_train_gather_bf16_{impl}")
        reset_kernel_counts()
        summary = run_cli(
            ["train", *argv(impl), "--steps", str(GATHER_STEPS)],
            os.path.join(work, f"cli_train_gather_bf16_{impl}.log"))
        launches = kernel_counts()
        records = check_run(log_dir, [2, 4], [GATHER_STEPS], [GATHER_STEPS])
        runs[impl] = {"launches": launches, **fit_row(summary, 4),
                      "losses": [r["loss"] for r in records
                                 if r["kind"] == "train"],
                      "eval": {k: records[-1][k]
                               for k in ("aee", "aae", "val_loss")}}
    # one step on the auto run's restored weights: the kernels against
    # the plain versions on the same batch
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["config", *argv("auto")])
    cfg = config_from_dict(json.loads(buf.getvalue()))
    trainer = Trainer(cfg, device="cuda")
    batch = batch_to_device(next(draw_batches(trainer, 1))[0],
                            trainer.device)
    torch.backends.cudnn.deterministic = True
    try:
        before = (cw.fwd_bf16_launches.count, cw.grad_bf16_launches.count)
        lk, gk = loss_and_grads(trainer.model, batch, trainer.dataset.mean,
                                cfg.loss)
        step_launches = (cw.fwd_bf16_launches.count - before[0],
                         cw.grad_bf16_launches.count - before[1])
        lp, gp = plain_warp_loss_and_grads(
            trainer.model, batch, trainer.dataset.mean, cfg.loss,
            flow_grad="reference")
    finally:
        torch.backends.cudnn.deterministic = False
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(gk, gp))
    del trainer
    row = {"steps": GATHER_STEPS, "eval_forwards": evals, "runs": runs,
           "kernel_vs_plain_loss_rel": loss_rel,
           "kernel_vs_plain_grad_max_rel": grad_rel,
           "kernel_step_launches": list(step_launches),
           "seconds": time.monotonic() - t0}
    emit("cli_train_gather_bf16", **row)
    want = want_counts(warp_fwd_bf16=GATHER_STEPS + evals,
                       warp_flow_grad_bf16=GATHER_STEPS)
    bad = {impl: r["launches"] for impl, r in runs.items()
           if r["launches"] != want}
    if bad:
        raise AssertionError(f"cli_train_gather_bf16: launches {bad}; want "
                             f"{want}")
    if step_launches != (1, 1) or not (loss_rel <= TRAIN_LOSS_RTOL
                                       and grad_rel <= TRAIN_GRAD_RTOL):
        raise AssertionError(
            f"cli_train_gather_bf16: a step with the bf16 warp kernels "
            f"({step_launches} launches) vs the plain versions: loss rel "
            f"{loss_rel} (limit {TRAIN_LOSS_RTOL}), gradient max rel "
            f"{grad_rel} (limit {TRAIN_GRAD_RTOL})")
    return row


def plain_corr_forward(fwd, x):
    """`fwd(x)` with FlowNet-C's correlation swapped for its plain version
    (`correlation_reference`) for this one call, as
    `plain_warp_loss_and_grads` swaps the loss's warp: no setting of the
    package routes a card tensor around the kernel."""
    from deepof_tpu_torch.models import flownet_c
    from deepof_tpu_torch.ops.corr import correlation_reference

    kernel_corr = flownet_c.correlation_nchw
    flownet_c.correlation_nchw = correlation_reference
    try:
        return fwd(x)
    finally:
        flownet_c.correlation_nchw = kernel_corr


def serve(cfg, n_requests: int = 24, n_threads: int = 4):
    """Full-width FlowNet-C through InferenceEngine on the card."""
    import numpy as np
    import torch

    from deepof_tpu_torch.ops.cuda.corr import launches
    from deepof_tpu_torch.serve.buckets import prepare_pair
    from deepof_tpu_torch.serve.engine import InferenceEngine, make_raw_forward

    natives = [(384, 512), (436, 1024)]
    rs = np.random.RandomState(cfg.train.seed)
    pairs = [tuple(rs.randint(0, 256, (*natives[i % 2], 3), dtype=np.uint8)
                   for _ in range(2)) for i in range(n_requests)]
    with InferenceEngine(cfg, device="cuda") as eng:
        # one warm-up dispatch (cuDNN algorithm choice, allocator) outside
        # the counted and timed run
        eng.submit(*pairs[0]).result(timeout=600)
        batches0 = eng.stats()["serve_batches"]
        results: list = [None] * n_requests

        def client(k: int) -> None:
            for i in range(k, n_requests, n_threads):
                results[i] = eng.submit(*pairs[i])

        launches.reset()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        responses = [f.result(timeout=600) for f in results]
        wall = time.perf_counter() - t0
        corr_launches = launches.count
        stats = eng.stats()
        dispatches = stats["serve_batches"] - batches0

        for (src, _), r in zip(pairs, responses):
            flow = r["flow"]
            if flow.shape != (*src.shape[:2], 2) or not np.isfinite(flow).all():
                raise AssertionError(f"bad response: shape {flow.shape} for "
                                     f"native {src.shape[:2]}")
        if corr_launches != dispatches or dispatches == 0:
            raise AssertionError(f"corr kernel launched {corr_launches} times "
                                 f"for {dispatches} dispatches")

        # one dispatch's raw output against the same model with the plain
        # correlation in place of the kernel, on the same card and input
        bucket = eng.buckets[0]
        x = np.stack([prepare_pair(*pairs[i], bucket, eng.mean)
                      for i in range(eng.max_batch)])
        fwd = make_raw_forward(eng.model)
        with torch.inference_mode():
            got = fwd(x)
            before = launches.count
            want = plain_corr_forward(fwd, x)
        if launches.count != before:
            raise AssertionError("the plain-corr dispatch launched the corr "
                                 "kernel")
        err = float(np.abs(got - want).max())
        lat = sorted(1e3 * r["latency_s"] for r in responses)
        row = {"requests": n_requests, "dispatches": dispatches,
               "corr_launches": corr_launches,
               "p50_ms": lat[int(0.50 * (len(lat) - 1))],
               "p99_ms": lat[int(0.99 * (len(lat) - 1))],
               "requests_per_s": n_requests / wall,
               "raw_flow_max_abs": float(np.abs(want).max()),
               "raw_vs_plain_corr_max_abs_err": err,
               "card": torch.cuda.get_device_name(0)}
        emit("serve", **row)
        if not err <= SERVE_TOL:
            raise AssertionError(f"served flow vs plain-corr model: max abs "
                                 f"err {err} > {SERVE_TOL}")
        profile(eng, fwd, x, pairs[:2])
    return row, corr_launches


def host_ms(fn, iters: int = 5) -> float:
    """Median host-clock time of one call, in ms."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2]


def _device_rows(prof):
    """(device us, row) of each device-side event row (kernels and
    copies): an operator's own row repeats the time of the kernels it
    launched, and a user annotation's device row (the optimizer's step)
    the time of the kernels inside it, so only kernel and copy rows are
    kept."""
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if (dev > 0 and str(e.device_type).endswith("CUDA")
                and not getattr(e, "is_user_annotation", False)
                and e.key != "Activity Buffer Request"):
            yield dev, e


def device_kernels(prof, iters: int) -> list[tuple[float, str]]:
    """(ms per iteration, name) of each device-side event, largest
    first."""
    return sorted(((dev / 1e3 / iters, e.key) for dev, e in
                   _device_rows(prof)), reverse=True)


def device_kernel_counts(prof) -> dict[str, int]:
    """{name: launches} of each device-side event in the session."""
    return {e.key: e.count for _, e in _device_rows(prof)}


def kernels_per_step(counts: dict[str, int], iters: int) -> dict:
    """Device kernels per step from `device_kernel_counts` over `iters`
    steps: all of them, the copies among them, and the warp kernels."""
    def per_step(pick):
        return sum(n for k, n in counts.items() if pick(k)) / iters

    return {"device_kernels_per_step": per_step(lambda k: True),
            "copy_kernels_per_step": per_step(lambda k: "copy" in k.lower()),
            "warp_kernels_per_step": per_step(lambda k: "warp_" in k)}


def warp_op_children(prof) -> dict[str, list[str]]:
    """{warp autograd op (BackwardWarpLevels and its backward): the names
    of every op run inside it}, over the session."""
    def below(ev):
        for c in ev.cpu_children:
            yield c.name
            yield from below(c)

    found: dict[str, set] = {}
    for e in prof.events():
        if e.name in ("BackwardWarpLevels", "BackwardWarpLevelsBackward"):
            found.setdefault(e.name, set()).update(below(e))
    return {k: sorted(v) for k, v in found.items()}


def profile(eng, fwd, x, pairs, iters: int = 3) -> None:
    """Where one request's time goes: host preprocess and postprocess
    per native size, one padded dispatch (copy in, forward, copy out) by
    CUDA events, and the device time by kernel from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from deepof_tpu_torch.serve.buckets import flow_to_native, prepare_pair

    bucket = eng.buckets[0]
    raw = fwd(x)
    host = {}
    for src, tgt in pairs:
        hw = src.shape[:2]
        host[f"{hw[0]}x{hw[1]}"] = {
            "prepare_ms": host_ms(lambda: prepare_pair(src, tgt, bucket,
                                                       eng.mean)),
            "postprocess_ms": host_ms(lambda: flow_to_native(
                raw[0], eng.cfg, bucket, hw))}
    dispatch_ms = time_ms(lambda: fwd(x), warmup=1, iters=10)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        for _ in range(iters):
            fwd(x)
        torch.cuda.synchronize()
    kernels = device_kernels(prof, iters)
    busy = sum(t for t, _ in kernels)
    corr = sum(t for t, k in kernels if "corr_fwd" in k)
    emit("profile", bucket=list(bucket), batch=int(x.shape[0]), host=host,
         dispatch_ms=dispatch_ms, device_time_visible=busy > 0,
         device_busy_ms=busy, corr_ms=corr,
         corr_share_of_busy=(corr / busy) if busy else None,
         idle_share_of_dispatch=(1 - busy / dispatch_ms) if busy else None,
         top=[{"ms": t, "name": k[:90]} for t, k in kernels[:10]])


# the precision tiers and the video streams of the serving slice
SERVE_TIERS = ("f32", "bf16", "int8")
STREAM_SESSIONS = 4
STREAM_FRAMES = 12
STREAM_SHIFT = (2, 3)  # (dy, dx) pixels a step of the synthetic video


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms for the bitwise gates of the
    serving phases (their timings run under the defaults)."""
    import torch

    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def p50_p99(ms: list[float]) -> dict:
    ms = sorted(ms)
    if not ms:
        return {"p50_ms": None, "p99_ms": None}
    return {"p50_ms": ms[int(0.50 * (len(ms) - 1))],
            "p99_ms": ms[int(0.99 * (len(ms) - 1))]}


def epe(a, b) -> float:
    import numpy as np

    return float(np.mean(np.sqrt(np.sum((a - b) ** 2, axis=-1))))


def run_clients(n: int, work) -> float:
    """`work(k)` on `n` threads at once; the wall-clock seconds."""
    t0 = time.perf_counter()
    threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("a client thread did not finish in 600 s")
    return time.perf_counter() - t0


def count_dispatches(eng) -> dict:
    """Wrap `eng._forward` to count its dispatches by (tier, mode) in the
    returned dict (the engine's own stats count them all together)."""
    inner = eng._forward
    counts: dict = {}

    def counting(key, x, prior=None):
        counts[key[1:]] = counts.get(key[1:], 0) + 1
        return inner(key, x, prior)

    eng._forward = counting
    return counts


def serve_tiers(cfg, n_requests: int = 24, n_threads: int = 4) -> dict:
    """Full-width FlowNet-C through one engine serving f32, bf16 and int8:
    per tier, `n_requests` pairs at native 384x512 from `n_threads`
    threads after one untimed request a thread (latency, requests/s,
    correlation launches against the dispatches, counted from 0 for each
    tier; the first tier also right after `warm()`, before any request,
    `first_tier_without_untimed_round`: the check on F14), the padded dispatch's time
    (CUDA events, and device busy from torch.profiler), its weight bytes
    and the device memory the tier adds, and its raw flow against the f32
    tier's on the same 8 pairs. Gates: finite flows of the native shape;
    the float32 correlation launched once a dispatch and nothing else
    (no `corr_bf16`: the bf16 tier computes in float32); each quantized
    tier differs from f32; a second dispatch gives the same bits (cuDNN
    deterministic); the int8 tier holds int8 weights on the card."""
    import numpy as np
    import torch

    from deepof_tpu_torch.serve.buckets import prepare_pair
    from deepof_tpu_torch.serve.engine import (InferenceEngine,
                                               build_serve_model)
    from deepof_tpu_torch.serve.quant import (Int8Layer, params_nbytes,
                                              quantize_model)

    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, precisions=SERVE_TIERS))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    model = build_serve_model(cfg, "cuda")
    memory = {"f32": {"params_nbytes": params_nbytes(model),
                      "allocated_before": before,
                      "allocated_after": torch.cuda.memory_allocated()}}
    for tier in SERVE_TIERS[1:]:
        before = torch.cuda.memory_allocated()
        tier_model = quantize_model(model, tier)
        torch.cuda.synchronize()
        memory[tier] = {"params_nbytes": params_nbytes(tier_model),
                        "allocated_before": before,
                        "allocated_after": torch.cuda.memory_allocated()}
        del tier_model
    rs = np.random.RandomState(cfg.train.seed + 1)
    h, w = cfg.data.image_size
    pairs = [tuple(rs.randint(0, 256, (h, w, 3), dtype=np.uint8)
                   for _ in range(2)) for _ in range(n_requests)]
    rows, raw = {}, {}
    with InferenceEngine(cfg, model=model, device="cuda") as eng:
        warmed = eng.warm()
        dispatches = count_dispatches(eng)
        bucket = eng.buckets[0]
        x = np.stack([prepare_pair(*pairs[i], bucket, eng.mean)
                      for i in range(eng.max_batch)])
        def timed_round(tier):
            results: list = [None] * n_requests

            def client(k: int) -> None:
                for i in range(k, n_requests, n_threads):
                    results[i] = eng.submit(*pairs[i], precision=tier)

            reset_kernel_counts()
            dispatches.clear()
            t0 = time.perf_counter()
            run_clients(n_threads, client)
            responses = [f.result(timeout=600) for f in results]
            return responses, time.perf_counter() - t0

        # F14: the first tier once right after warm(), with no untimed
        # request through the batcher before it
        responses, wall = timed_round(SERVE_TIERS[0])
        first_round = {**p50_p99([1e3 * r["latency_s"] for r in responses]),
                       "requests_per_s": n_requests / wall}
        for tier in SERVE_TIERS:
            # one untimed request per thread first, as `serve` takes one
            # warm-up dispatch outside its timed run
            for f in [eng.submit(*pairs[k], precision=tier)
                      for k in range(n_threads)]:
                f.result(timeout=600)
            responses, wall = timed_round(tier)
            counts = kernel_counts()
            n_disp = dispatches.get((tier, "cold"), 0)
            for (src, _), r in zip(pairs, responses):
                if (r["flow"].shape != (*src.shape[:2], 2)
                        or not np.isfinite(r["flow"]).all()
                        or r["precision"] != tier):
                    raise AssertionError(f"{tier}: bad response")
            if n_disp == 0 or counts != want_counts(corr=n_disp):
                raise AssertionError(f"{tier}: {n_disp} dispatches launched "
                                     f"{counts}; want the float32 corr "
                                     "once a dispatch and nothing else")

            def fwd(key=(bucket, tier, "cold")):
                return eng._forward(key, x)

            with cudnn_deterministic():
                raw[tier] = fwd()
                repeat = bool(np.array_equal(fwd(), raw[tier]))
            rows[tier] = {
                "requests": n_requests, "dispatches": n_disp,
                "corr_launches": counts["corr"],
                "corr_bf16_launches": counts["corr_bf16"],
                **p50_p99([1e3 * r["latency_s"] for r in responses]),
                "requests_per_s": n_requests / wall,
                "dispatch_ms": time_ms(fwd, warmup=2, iters=10),
                "device_busy_ms": device_ms(fwd, iters=3),
                **memory[tier],
                "repeat_bitwise": repeat}
        int8 = eng.tier_models["int8"]
        layers = [m for m in int8.modules() if isinstance(m, Int8Layer)]
        int8_ok = bool(layers) and all(
            m.q.dtype == torch.int8 and m.q.is_cuda for m in layers) and not [
            t for t in (*int8.parameters(), *int8.buffers())
            if t.is_floating_point() and t.dim() > 1]
        stats = eng.stats()
    for tier in SERVE_TIERS:
        rows[tier].update(
            epe_vs_f32=epe(raw[tier], raw["f32"]),
            max_abs_vs_f32=float(np.abs(raw[tier] - raw["f32"]).max()),
            raw_flow_abs_max=float(np.abs(raw[tier]).max()),
            raw_flow_abs_mean=float(np.abs(raw[tier]).mean()))
    row = {"tiers": rows, "warm": warmed["buckets"],
           "first_tier_without_untimed_round": {
               "tier": SERVE_TIERS[0], **first_round},
           "int8_weights_int8_on_card": int8_ok,
           "serve_tier_splits": stats["serve_tier_splits"],
           "serve_requests_by_tier": stats["serve_requests_by_tier"],
           "card": torch.cuda.get_device_name(0)}
    emit("serve_tiers", **row)
    bad = [t for t, r in rows.items() if not r["repeat_bitwise"]]
    bad += [t for t in SERVE_TIERS[1:] if rows[t]["max_abs_vs_f32"] == 0]
    if bad or not int8_ok:
        raise AssertionError(f"serve_tiers: tiers {bad} not repeatable or "
                             f"equal to f32; int8 weights int8: {int8_ok}")
    return row


def video(seed: int, frames: int, hw=(384, 512)) -> list:
    """A coherent synthetic video: one smooth texture with fine grain,
    moved by STREAM_SHIFT pixels a frame; BGR uint8 frames of `hw`."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rs = np.random.RandomState(seed)
    dy, dx = STREAM_SHIFT
    h, w = hw[0] + dy * frames, hw[1] + dx * frames
    coarse = torch.from_numpy(rs.rand(1, 3, h // 16 + 2, w // 16 + 2)
                              .astype(np.float32))
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear",
                           align_corners=False)[0].permute(1, 2, 0).numpy()
    tex = np.clip(200 * smooth + rs.randint(0, 56, (h, w, 3)), 0, 255)
    tex = tex.astype(np.uint8)
    return [np.ascontiguousarray(
        tex[dy * (frames - k):dy * (frames - k) + hw[0],
            dx * (frames - k):dx * (frames - k) + hw[1]])
        for k in range(frames)]


def dispatch_profile(fn, iters: int = 3) -> dict:
    """The device busy time of one call of `fn` and its eight largest
    device kernels, from torch.profiler over `iters` calls."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, iters)
    return {"device_busy_ms": sum(t for t, _ in kernels),
            "top": [{"ms": t, "name": k[:90]} for t, k in kernels[:8]]}


def serve_stream(cfg, sessions: int = STREAM_SESSIONS,
                 frames: int = STREAM_FRAMES) -> dict:
    """Full-width FlowNet-C with `serve.session.warm_start`: `sessions`
    video sessions of `frames` frames (`video`), one closed-loop client
    thread each, through `submit_next`. Reports cold and warm step
    latency apart, the device time of a cold and of a warm padded
    dispatch, the session counters, the kernel launches (counted from 0
    for the walk) against the dispatches of each mode, and each warm
    step's EPE against the cold (pairwise) flow of the same frames.
    Gates: the warp kernel once a warm dispatch and the correlation once
    a cold one, nothing else; finite flows; a warm dispatch with the warp
    kernel equals the same dispatch with the plain warp, bit for bit
    (cuDNN deterministic; the stage's gate set to 1 for it, so the
    stage's output, which reads the warped frame, counts: at the served
    gate 0 it is multiplied out); a walk with warm_start off equals the
    pairwise walk bit for bit; close() leaves no sweeper thread."""
    import numpy as np
    import torch

    from deepof_tpu_torch.models import flownet2
    from deepof_tpu_torch.ops.warp import backward_warp_reference
    from deepof_tpu_torch.serve.buckets import prepare_pair
    from deepof_tpu_torch.serve.engine import InferenceEngine

    warm_cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, session=dataclasses.replace(cfg.serve.session,
                                               warm_start=True)))
    videos = [video(cfg.train.seed + 10 + s, frames, cfg.data.image_size)
              for s in range(sessions)]
    results = [[None] * frames for _ in range(sessions)]
    with InferenceEngine(warm_cfg, device="cuda") as eng:
        model = eng.model
        eng.warm()
        dispatches = count_dispatches(eng)

        def client(s: int) -> None:
            for f in range(frames):
                results[s][f] = eng.submit_next(
                    f"video{s}", videos[s][f]).result(timeout=600)

        reset_kernel_counts()
        wall = run_clients(sessions, client)
        counts = kernel_counts()
        n_warm = dispatches.get(("f32", "warm"), 0)
        n_cold = dispatches.get(("f32", "cold"), 0)
        stats = eng.stats()
        if not (n_warm and n_cold and counts == want_counts(
                corr=n_cold, warp_fwd=n_warm)):
            raise AssertionError(f"stream: {n_cold} cold and {n_warm} warm "
                                 f"dispatches launched {counts}")
        steps = [(s, f, results[s][f]) for s in range(sessions)
                 for f in range(1, frames)]
        if not all(np.isfinite(r["flow"]).all() for _, _, r in steps):
            raise AssertionError("stream: a non-finite flow")
        warm_epe = [epe(r["flow"], eng.submit(
            videos[s][f - 1], videos[s][f]).result(timeout=600)["flow"])
            for s, f, r in steps if r["warm"]]

        bucket = eng.buckets[0]
        x = np.stack([prepare_pair(videos[i % sessions][i // sessions],
                                   videos[i % sessions][i // sessions + 1],
                                   bucket, eng.mean)
                      for i in range(eng.max_batch)])
        prior = eng._forward((bucket, "f32", "cold"), x)

        def cold():
            return eng._forward((bucket, "f32", "cold"), x)

        def warm():
            return eng._forward((bucket, "f32", "warm"), x, prior)

        times = {f"{k}_dispatch": {"ms": time_ms(fn, warmup=2, iters=10),
                                   **dispatch_profile(fn)}
                 for k, fn in (("cold", cold), ("warm", warm))}
        refine = eng.refine_models["f32"]
        kernel_warp = flownet2.backward_warp_nchw
        with torch.no_grad(), cudnn_deterministic():
            refine.gate.fill_(1.0)
            try:
                got = warm()
                flownet2.backward_warp_nchw = backward_warp_reference
                want = warm()
            finally:
                flownet2.backward_warp_nchw = kernel_warp
                refine.gate.fill_(0.0)
        warm_plain_equal = bool(np.array_equal(got, want))
    cold_cfg = dataclasses.replace(warm_cfg, serve=dataclasses.replace(
        warm_cfg.serve, session=dataclasses.replace(
            warm_cfg.serve.session, warm_start=False)))
    walk = videos[0][:6]
    with InferenceEngine(cold_cfg, model=model, device="cuda") as eng, \
            cudnn_deterministic():
        eng.submit_next("v", walk[0]).result(timeout=600)
        streamed = [eng.submit_next("v", f).result(timeout=600)["flow"]
                    for f in walk[1:]]
        pairwise = [eng.submit(a, b).result(timeout=600)["flow"]
                    for a, b in zip(walk, walk[1:])]
    cold_walk_equal = all(np.array_equal(a, b)
                          for a, b in zip(streamed, pairwise))
    sweepers = [t.name for t in threading.enumerate()
                if t.name == "serve-session-sweeper"]
    lat = {mode: [1e3 * r["latency_s"] for _, _, r in steps
                  if r["warm"] == (mode == "warm")]
           for mode in ("cold", "warm")}
    row = {"sessions": sessions, "frames": frames,
           "shift_px": list(STREAM_SHIFT), "wall_s": wall,
           "steps_per_s": len(steps) / wall,
           "cold_steps": {"n": len(lat["cold"]), **p50_p99(lat["cold"])},
           "warm_steps": {"n": len(lat["warm"]), **p50_p99(lat["warm"])},
           **times, "dispatches": {"cold": n_cold, "warm": n_warm},
           "corr_launches": counts["corr"],
           "warp_fwd_launches": counts["warp_fwd"],
           "warm_epe_vs_cold": warm_epe,
           "warm_epe_vs_cold_mean": float(np.mean(warm_epe)),
           "warm_equals_plain_warp": warm_plain_equal,
           "cold_walk_equals_pairwise": cold_walk_equal,
           "sweepers_after_close": sweepers,
           **{k: v for k, v in stats.items()
              if k.startswith("serve_sessions_")
              or k in ("serve_warm_splits", "serve_session_latency_p50_ms",
                       "serve_session_latency_p99_ms")},
           "card": torch.cuda.get_device_name(0)}
    emit("serve_stream", **row)
    if not (warm_plain_equal and cold_walk_equal and not sweepers
            and np.isfinite(warm_epe).all()):
        raise AssertionError(f"serve_stream gates: warm == plain warp "
                             f"{warm_plain_equal}, cold walk == pairwise "
                             f"{cold_walk_equal}, sweepers {sweepers}")
    return row


SERVE_BENCH_REAL = {"overrides": ("model=flownet_c", "width_mult=1.0"),
                    "bucket": (384, 512), "native_hw": (384, 512),
                    "max_batch": 8, "requests": 32}
SERVE_BENCH_STREAM = {"frames": 32, "warm_frames": 12}
SERVE_BENCH_QUALITY = {"tiers": ("f32",), "requests": 8, "sample_rate": 0.5}


def serve_bench_phase(device: str = "cuda", real: dict = SERVE_BENCH_REAL,
                      stream: dict = SERVE_BENCH_STREAM,
                      quality: dict = SERVE_BENCH_QUALITY) -> dict:
    """The port's serving benchmark (`deepof_tpu_torch/tools/
    serve_bench.py`) in this process, three of its modes through their
    functions, the kernel counts set to 0 just before each:

      flownet_c  `serve_bench` on the real model, FlowNet-C at full width
                 and the paper geometry at 384x512, batch 8, with the
                 serial (max_batch=1) engine after it: one correlation
                 launch a cold dispatch, each engine's warm-up dispatch
                 included (its lattice is one f32 cold entry; the serial
                 engine dispatches each request alone); every flow of
                 both runs finite.
      stream     `stream_bench`: the fake-executor walks (no kernel) and
                 the warm walk of FlowNet-S at width 0.5: one warp launch
                 a warm step, plus two of the warm engine before it
                 serves (its construction's one-row check of the
                 refinement stage's grid, and its warm-up dispatch).
      quality    `quality_bench` on FlowNet-S at width 0.25: one launch of
                 the scorer's warp a scored request (the scores phase's,
                 then those the cost phase's sampling engine scored, as
                 its stats count them), plus one warm-up call of the
                 scorer in each engine that scores.

    Every other kernel's count stays 0. Fails on any error or mismatch."""
    import numpy as np
    import torch

    from deepof_tpu_torch.tools import serve_bench as sb

    t0 = time.monotonic()
    results = []
    run = sb.run_workload

    def recording(engine, requests, gap_ms, precision=None):
        out = run(engine, requests, gap_ms, precision)
        results.extend(out[2])
        return out

    reset_kernel_counts()
    sb.run_workload = recording
    try:
        real_row = sb.serve_bench(fake=False, device=device, serial=True,
                                  **real)
    finally:
        sb.run_workload = run
    counts = {"flownet_c": kernel_counts()}
    n = real_row["requests"]
    cold = real_row["dispatches"] + n + 2
    flows_ok = (len(results) == 2 * n and all(
        r is not None and r["flow"].shape == (*real["native_hw"], 2)
        and np.isfinite(r["flow"]).all() for r in results))

    reset_kernel_counts()
    stream_row = sb.stream_bench(device=device, **stream)
    counts["stream"] = kernel_counts()

    reset_kernel_counts()
    quality_row = sb.quality_bench(device=device, **quality)
    counts["quality"] = kernel_counts()
    sampled = quality_row["scored_quality_on"]
    scored = quality_row["tiers"]["f32"]["scored"]

    row = {"flownet_c": real_row, "stream": stream_row,
           "quality": quality_row, "launches": counts,
           "want": {"flownet_c": want_counts(corr=cold),
                    "stream": want_counts(
                        warp_fwd=(stream_row["warm_steps"] or 0) + 2),
                    "quality": want_counts(
                        warp_fwd_quality=scored + sampled + 2)},
           "cold_dispatches": cold, "quality_sampled": sampled,
           "flows_finite": flows_ok,
           # what the phase leaves behind for the phases after it
           "threads_after": sorted(t.name for t in threading.enumerate()),
           "card_reserved_gib_after": torch.cuda.memory_reserved() / 2**30,
           "seconds": time.monotonic() - t0}
    emit("serve_bench", p50_ms=real_row["latency_p50_ms"],
         p99_ms=real_row["latency_p99_ms"], **row)
    gates = {
        "errors": (real_row["errors"], stream_row["errors"],
                   stream_row["pairwise_errors"], stream_row["warm_errors"],
                   stream_row["warm_cold_errors"]) == (0,) * 5,
        "launches": counts == row["want"],
        "warm": (stream_row["warm_steps"], stream_row["warm_cold_fallbacks"])
        == (stream["warm_frames"] - 2, 1),
        "decodes": (stream_row["flow_bitwise_equal"],
                    stream_row["stream_decodes"],
                    stream_row["pairwise_decodes"],
                    stream_row["decode_saved"])
        == (True, stream["frames"], 2 * (stream["frames"] - 1),
            stream["frames"] - 1),
        "epe_vs_cold": stream_row["epe_vs_cold"] is not None
        and stream_row["epe_vs_cold"] <= 0.5,
        "scored": scored == quality_row["requests"],
        "flows_finite": flows_ok,
    }
    if not all(gates.values()):
        raise AssertionError(f"serve_bench gates {gates}")
    return row


def loss_and_grads(model, batch, mean, loss_cfg, compute_dtype=None,
                   dropout=None, smooth_border_mask=False):
    """One forward and backward at the model's current weights, no
    update, with the network's pair in `compute_dtype` (default float32)
    as the train step casts it, an action model's dropout `masks` and the
    loss's border mask as given: (loss, [gradient of each parameter])."""
    import torch

    from deepof_tpu_torch.train.step import model_losses

    model.zero_grad(set_to_none=True)
    total, _ = model_losses(model, batch, mean, loss_cfg,
                            smooth_border_mask=smooth_border_mask,
                            compute_dtype=compute_dtype or torch.float32,
                            dropout=dropout)
    total.backward()
    return total.item(), [p.grad.detach().clone()
                          for p in model.parameters()]


def plain_warp_loss_and_grads(model, batch, mean, loss_cfg,
                              compute_dtype=None, flow_grad="autograd",
                              **kw):
    """`loss_and_grads` with the loss's warp swapped for its plain
    version for this one call, as `serve` swaps the correlation: no
    setting of the package routes a card tensor around the kernels. The
    forward is `backward_warp_reference`; the flow gradient autograd of it
    (`flow_grad="autograd"`) or `warp_flow_grad_reference`
    ("reference": the gradient kernel's plain version, its bits). The
    loss's warped images are data: no image gradient."""
    import torch

    from deepof_tpu_torch.losses import pyramid
    from deepof_tpu_torch.ops.warp import (backward_warp_reference,
                                           pallas_route,
                                           warp_flow_grad_reference)

    class PlainWarp(torch.autograd.Function):
        @staticmethod
        def forward(ctx, image, flow, pallas):
            ctx.save_for_backward(image, flow)
            return backward_warp_reference(image, flow, pallas)

        @staticmethod
        def backward(ctx, g):
            image, flow = ctx.saved_tensors
            return None, warp_flow_grad_reference(image, flow, g), None

    def plain_warp_levels(images, flows, impl="auto"):
        # NHWC memory in both variants: the loss's reductions then sum in
        # the same order, so the two plain steps' forwards and losses are
        # the same bits (the kernel writes its output in its input's
        # layout); only the flow gradient's route differs. A bf16 image
        # takes each level's route as the kernels' wrapper does
        warp = (backward_warp_reference if flow_grad == "autograd"
                else PlainWarp.apply)
        return [warp(i.permute(0, 3, 1, 2), f.permute(0, 3, 1, 2),
                     pallas_route(impl, i.shape[1], i.shape[2]))
                .permute(0, 2, 3, 1).contiguous()
                for i, f in zip(images, flows)]

    kernel_warp = pyramid.backward_warp_levels
    pyramid.backward_warp_levels = plain_warp_levels
    try:
        return loss_and_grads(model, batch, mean, loss_cfg, compute_dtype,
                              **kw)
    finally:
        pyramid.backward_warp_levels = kernel_warp


def draw_batches(trainer, n: int):
    """The host batches of the next n steps from the trainer's step, drawn
    from the stream `Trainer.fit` draws (batch i of a fit from step s:
    derive_batch_rng(data_stream_seed(seed, s), i)), without its healer,
    pipeline or prefetcher, with the seconds each draw took."""
    import numpy as np

    from deepof_tpu_torch.data.pipeline import derive_batch_rng
    from deepof_tpu_torch.train import loop

    step = int(trainer.state.step)
    if hasattr(loop, "data_stream_seed"):
        seed = loop.data_stream_seed(trainer.cfg.train.seed, step)
    else:  # a checkout from before the command line
        seed = np.array([trainer.cfg.train.seed, step], np.uint32)
    for i in range(n):
        t0 = time.perf_counter()
        batch = trainer.dataset.sample_train(trainer.cfg.data.batch_size,
                                             rng=derive_batch_rng(seed, i))
        yield batch, time.perf_counter() - t0


def host_metrics(m: dict) -> dict:
    """A train step's metrics on the host: the step returns them as
    tensors on the card (it decides its update there), here floats and
    lists; numbers pass as they are."""
    return {k: v.tolist() if hasattr(v, "tolist") else v
            for k, v in m.items()}


def steps_in_sequence(trainer, n: int) -> list[dict]:
    """n train steps, each on a batch drawn just before it and copied to
    the card inside the step (no prefetcher): each step's metrics, with
    the draw (`data_ms`) and the step, copy and metric read-back included
    (`step_ms`), on the host clock."""
    trainer.model.train()
    out = []
    for batch, data_s in draw_batches(trainer, n):
        t0 = time.perf_counter()
        metrics = host_metrics(trainer.train_step(trainer.state, batch))
        metrics["step_ms"] = 1e3 * (time.perf_counter() - t0)
        metrics["data_ms"] = 1e3 * data_s
        out.append(metrics)
    return out


def train(cfg):
    """Full-width FlowNet-S training steps on the card, batches drawn in
    sequence: one warm-up step, TRAIN_STEPS counted and timed steps, then
    one step's loss and gradients with the warp kernels against the plain
    warp. The loss warps its six levels in one launch per direction, so
    each kernel launches once a step."""
    import numpy as np
    import torch

    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.train.loop import Trainer
    from deepof_tpu_torch.train.step import batch_to_device

    trainer = Trainer(cfg, device="cuda")
    steps_in_sequence(trainer, 1)  # cuDNN algorithm choice, allocator
    reset_warp_counts()
    steps = steps_in_sequence(trainer, TRAIN_STEPS)
    launches = (cw.fwd_launches.count, cw.grad_launches.count)
    levels = len(steps[0]["scale_total"])

    # the same weights and batch through the plain warp; cuDNN's
    # weight-gradient algorithms use atomics unless deterministic
    batch = batch_to_device(next(draw_batches(trainer, 1))[0],
                            trainer.device)
    torch.backends.cudnn.deterministic = True
    try:
        lk, gk = loss_and_grads(trainer.model, batch, trainer.dataset.mean,
                                cfg.loss)
        before = (cw.fwd_launches.count, cw.grad_launches.count)
        lp, gp = plain_warp_loss_and_grads(
            trainer.model, batch, trainer.dataset.mean, cfg.loss)
        if (cw.fwd_launches.count, cw.grad_launches.count) != before:
            raise AssertionError("the plain-warp step launched a warp kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   .item() for a, b in zip(gk, gp))
    totals = [m["total"] for m in steps]
    row = {"model": cfg.model, "width_mult": cfg.width_mult,
           "image_size": list(cfg.data.image_size),
           "batch": cfg.data.batch_size, "steps": TRAIN_STEPS,
           "params": sum(p.numel() for p in trainer.model.parameters()),
           "totals": totals, "grad_norms": [m["grad_norm"] for m in steps],
           "updates_skipped": sum(m["update_skipped"] for m in steps),
           "step_ms_median": float(np.median([m["step_ms"] for m in steps])),
           "step_ms": [m["step_ms"] for m in steps],
           "data_ms_median": float(np.median([m["data_ms"] for m in steps])),
           "warp_fwd_launches": launches[0],
           "warp_flow_grad_launches": launches[1],
           "pyramid_levels": levels,
           "kernel_vs_plain_loss_rel": loss_rel,
           "kernel_vs_plain_grad_max_rel": grad_rel}
    emit("train", **row)
    if not all(np.isfinite(totals)) or row["updates_skipped"]:
        raise AssertionError(f"non-finite training losses: {totals}")
    if launches != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"warp kernels launched {launches} times in "
                             f"{TRAIN_STEPS} steps of {levels} levels; "
                             f"want one a step each")
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_RTOL):
        raise AssertionError(
            f"train step with the warp kernels vs the plain warp: loss rel "
            f"{loss_rel} (limit {TRAIN_LOSS_RTOL}), gradient max rel "
            f"{grad_rel} (limit {TRAIN_GRAD_RTOL})")
    train_profile(trainer)
    return row


def profile_steps(trainer, iters: int):
    """(ms per step on the host clock, torch.profiler session of `iters`
    more steps), each on a batch already on the card."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from deepof_tpu_torch.train.step import batch_to_device

    batches = [batch_to_device(b, trainer.device)
               for b, _ in draw_batches(trainer, iters)]
    step = trainer.train_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        step(trainer.state, b)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / iters
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        for b in batches:
            step(trainer.state, b)
        torch.cuda.synchronize()
    return step_ms, prof


def step_kernels(repo: str | None = None, iters: int = 3) -> dict:
    """Device kernels per full-width FlowNet-S training step (the `train`
    phase's configuration), by name, with the `deepof_tpu_torch` package
    of the checkout at `repo` (default: this one). To compare two
    checkouts, one process each, in one call on the card:

        python3 -c "import chip_smoke as cs; cs.step_kernels('other/')"
    """
    import torch

    if repo is not None:
        sys.path.insert(0, repo)
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)
    from deepof_tpu_torch.train.loop import Trainer

    # full float32, as `main` runs the train phase
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    with tempfile.TemporaryDirectory(dir=work_root()) as log_dir:
        # a checkout from before the training log has no train.log_dir
        train_cfg = (TrainConfig(log_dir=log_dir) if "log_dir" in {
            f.name for f in dataclasses.fields(TrainConfig)}
            else TrainConfig())
        trainer = Trainer(ExperimentConfig(
            data=DataConfig(dataset="synthetic"), train=train_cfg),
            device="cuda")
        steps_in_sequence(trainer, 1)
        step_ms, prof = profile_steps(trainer, iters)
    counts = device_kernel_counts(prof)
    row = {"repo": repo or ".", "step_ms": step_ms,
           "device_busy_ms": sum(t for t, _ in device_kernels(prof, iters)),
           **kernels_per_step(counts, iters),
           "top_by_count": {k[:120]: n / iters for k, n in sorted(
               counts.items(), key=lambda kv: -kv[1])[:40]}}
    emit("step_kernels", **row)
    return row


def train_profile(trainer, iters: int = 3) -> None:
    """Where a training step's time goes: the step on a batch already on
    the card (host clock around a synchronised step), device busy time by
    kernel from torch.profiler, the warp kernels' share of it, the device
    kernels per step (copies among them), and the ops run inside the
    warp's autograd ops (no copy may be among them)."""
    step_ms, prof = profile_steps(trainer, iters)
    kernels = device_kernels(prof, iters)
    busy = sum(t for t, _ in kernels)
    warp = sum(t for t, k in kernels if "warp_" in k)
    warp_ops = warp_op_children(prof)
    copies = sorted({n for names in warp_ops.values() for n in names
                     if n in COPY_OPS})
    emit("train_profile", batch=trainer.cfg.data.batch_size,
         step_ms=step_ms,
         pairs_per_s=trainer.cfg.data.batch_size / (step_ms / 1e3),
         device_time_visible=busy > 0, device_busy_ms=busy,
         idle_share_of_step=(1 - busy / step_ms) if busy else None,
         warp_ms=warp, warp_share_of_busy=(warp / busy) if busy else None,
         **kernels_per_step(device_kernel_counts(prof), iters),
         warp_op_children=warp_ops,
         top=[{"ms": t, "name": k[:90]} for t, k in kernels[:10]])
    if copies:
        raise AssertionError(f"the warp's autograd ops made copies: {copies}")


HTTP_REQUESTS = 32
HTTP_THREADS = 4
HTTP_DEADLINED = 4
HTTP_DEGRADED = 2
HTTP_STREAM_FRAMES = 12
HTTP_TOL = 1e-5  # of the largest entry: a row's bits may follow its slot
# label-free quality scoring on serve_http (obs.quality_*): the sampled
# share and its seed, the reference's size, the drift factor and budget
# of the verdict; the drift stage's requests a round and its rounds at most
HTTP_QUALITY = {"quality_sample_rate": 0.5, "quality_seed": 3,
                "quality_ref_samples": 8, "quality_drift_factor": 1.5,
                "quality_budget": 0.25}
HTTP_DRIFT_REQUESTS = 8
HTTP_DRIFT_ROUNDS = 6
# the score triple on the card vs the numpy reference on the same row:
# float32 sums in another order (the warp kernel gives the plain
# version's bits)
QUALITY_RTOL = 1e-4


def http_call(address, method: str, path: str, body=None,
              headers=None) -> tuple[int, str, object, float]:
    """One request on a connection of its own: (status, content type,
    parsed JSON or bytes, client-clock ms)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*address, timeout=600)
    conn.request(method, path, None if body is None else json.dumps(body),
                 headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    ms = 1e3 * (time.perf_counter() - t0)
    ctype = resp.getheader("Content-Type")
    if ctype == "application/json":
        data = json.loads(data)
    return resp.status, ctype, data, ms


def b64_png(img) -> str:
    import base64

    from deepof_tpu_torch.io.png import png_bytes

    return base64.b64encode(png_bytes(img)).decode()


def serve_http(cfg) -> dict:
    """The HTTP server of `serve/server.py` in this process (on a thread,
    port 0) over full-width FlowNet-C at the 384x512 bucket, batch 8, in
    the f32 and bf16 tiers, with warm-start sessions, label-free quality
    scoring (HTTP_QUALITY: half the requests sampled) and the incident
    plane (`obs.incidents`, the recorder installed on the engine as
    `run_server` installs it):
      - HTTP_REQUESTS `POST /v1/flow` from HTTP_THREADS client threads,
        PNG pairs of consecutive frames of a synthetic video at the
        bucket's size (base64, written by `io/png.py`): each flow equal
        to `engine.submit` of the same arrays, or within HTTP_TOL of its
        largest entry (cuDNN deterministic);
      - one request in `flo` format and one in `png`;
      - HTTP_DEADLINED requests with `X-Deadline-Ms: 1`: 504, counted in
        deadline_* and not in serve_server_errors;
      - HTTP_DEGRADED requests with `X-Degrade-Level: 1`: served in bf16,
        counted in degrade_tier_downgrades;
      - a stream of HTTP_STREAM_FRAMES frames on `/v1/flow/stream`: 202,
        then 200s, warm from the second pair; then its DELETE;
      - `/healthz`, and `/metrics` through `parse_prometheus`;
      - quality: every sampled request scored once, by one launch of the
        float32 warp kernel on the head's grid (`warp_fwd_quality`), none
        dropped; scored triples equal to the numpy reference's on the
        same rows within QUALITY_RTOL;
      - the drift: the `replica_degrade` fault (`resilience/faults.py`,
        armed by `serve/server.py::install_replica_faults`) then adds 25
        px to every flow; rounds of HTTP_DRIFT_REQUESTS requests until
        the quality verdict is exhausted, the sampler's picks in that
        stage equal to the scored count; `/healthz` commits one critical
        `quality_drift` bundle; then `python -m deepof_tpu_torch
        incidents list` exits 1, `ack` 0, `list` 0;
    with the client-clock p50/p99 beside the engine's histogram p50/p99,
    and the launches counted from 0 over the requests: the correlation
    once a cold dispatch (f32 and bf16: the float32 kernel), the warp
    once a warm dispatch and once a scored request."""
    import base64

    import numpy as np
    import torch

    from deepof_tpu_torch.io.flo import FLO_TAG
    from deepof_tpu_torch.obs import incident
    from deepof_tpu_torch.obs.export import parse_prometheus
    from deepof_tpu_torch.obs.quality import QualitySampler, score_pair_np
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.resilience.faults import FaultConfig
    from deepof_tpu_torch.serve.engine import InferenceEngine
    from deepof_tpu_torch.serve.server import (_log_serve_summary,
                                               build_server,
                                               install_replica_faults)

    log_dir = tempfile.mkdtemp(prefix="serve_http-", dir=work_root())
    cfg = dataclasses.replace(
        cfg, serve=dataclasses.replace(
            cfg.serve, precisions=("f32", "bf16"), host="127.0.0.1", port=0,
            session=dataclasses.replace(cfg.serve.session, warm_start=True)),
        obs=dataclasses.replace(cfg.obs, incidents=True, **HTTP_QUALITY),
        train=dataclasses.replace(cfg.train, log_dir=log_dir))
    h, w = cfg.data.image_size
    clip = video(40, HTTP_REQUESTS + 1, (h, w))
    pairs = list(zip(clip[:-1], clip[1:]))
    bodies = [{"prev": b64_png(a), "next": b64_png(b)} for a, b in pairs]
    frames = video(41, HTTP_STREAM_FRAMES, (h, w))
    t0 = time.monotonic()
    scored_rows: list = []
    with InferenceEngine(cfg, device="cuda", ledger_dir=log_dir) as eng, \
            cudnn_deterministic():
        eng.incidents = incident.install(cfg, log_dir, "serve")
        inner_score = eng._quality._score_fn

        def recording(bucket, x, flow):
            out = inner_score(bucket, x, flow)
            if len(scored_rows) < 4:
                scored_rows.append((x[0].copy(), flow[0].copy(), out))
            return out

        eng._quality._score_fn = recording
        warm = eng.warm()
        warm_rows = ledger_rows(log_dir)
        warm_trace_s = eng._ledger.trace_s
        dispatches = count_dispatches(eng)
        httpd = build_server(cfg, eng)
        server_thread = threading.Thread(target=httpd.serve_forever,
                                         daemon=True, name="serve-http")
        server_thread.start()
        address = httpd.server_address[:2]
        try:
            reset_kernel_counts()
            results: list = [None] * HTTP_REQUESTS

            def client(k: int) -> None:
                for i in range(k, HTTP_REQUESTS, HTTP_THREADS):
                    results[i] = http_call(address, "POST", "/v1/flow",
                                           bodies[i])

            wall = run_clients(HTTP_THREADS, client)
            fmt = {f: http_call(address, "POST", "/v1/flow",
                                {**bodies[0], "format": f})
                   for f in ("flo", "png")}
            late = [http_call(address, "POST", "/v1/flow", bodies[i],
                              {"X-Deadline-Ms": "1"})
                    for i in range(HTTP_DEADLINED)]
            degraded = [http_call(address, "POST", "/v1/flow", bodies[i],
                                  {"X-Degrade-Level": "1"})
                        for i in range(HTTP_DEGRADED)]
            stream = [http_call(address, "POST", "/v1/flow/stream",
                                {"session": "clip", "frame": b64_png(f)})
                      for f in frames]
            deleted = http_call(address, "DELETE", "/v1/flow/stream/clip")
            drained = eng._quality.drain(120.0)
            counts = kernel_counts()
            dispatches = dict(dispatches)  # the reference's go uncounted
            health = http_call(address, "GET", "/healthz")
            metrics = http_call(address, "GET", "/metrics")
            stats = eng.stats()
            # the in-process reference: the same arrays through submit
            want = [f.result(timeout=600)["flow"] for f in
                    [eng.submit(a, b) for a, b in pairs]]
            # the drift: from here every dispatch's flow is 25 px off
            install_replica_faults(eng, dataclasses.replace(
                cfg, resilience=dataclasses.replace(
                    cfg.resilience, faults=FaultConfig(
                        enabled=True, replica_degrade_at=(0,),
                        replica_fault_after=eng.stats()[
                            "serve_responses"]))))
            eng._quality.drain(120.0)
            index0, scored0 = (eng._quality_index,
                               eng._quality.stats()["serve_quality_scored"])
            drift = []
            for _ in range(HTTP_DRIFT_ROUNDS):
                drift += [http_call(address, "POST", "/v1/flow", bodies[i])
                          for i in range(HTTP_DRIFT_REQUESTS)]
                eng._quality.drain(120.0)
                verdict = http_call(address, "GET", "/healthz")[2]
                if verdict["serve_quality"]["exhausted"]:
                    break
            drift_stats = eng.stats()
            # the final stats record `run_server` appends at its exit,
            # which `tail` reads
            _log_serve_summary(cfg, eng)
            index1 = eng._quality_index
            quality_launches = cw.quality_launches.count
        finally:
            httpd.shutdown()
            httpd.server_close()
    sampler = QualitySampler(cfg.obs.quality_sample_rate,
                             cfg.obs.quality_seed)
    drift_picks = sum(sampler.sample(i) for i in range(index0, index1))
    triple_rel = max(
        float(np.max(np.abs(np.array(t) - np.array(score_pair_np(x, f)))
                     / np.abs(np.array(score_pair_np(x, f)))))
        for x, f, t in scored_rows)
    bundles = incident.list_incidents(log_dir)
    verbs, tails = {}, {}
    for name, verb in (("list", ["incidents", "list"]), ("tail", ["tail"]),
                       ("ack", ["incidents", "ack"]),
                       ("tail after ack", ["tail"]),
                       ("list again", ["incidents", "list"])):
        res = subprocess.run(
            [sys.executable, "-m", "deepof_tpu_torch", *verb,
             "--log-dir", log_dir], capture_output=True, text=True,
            timeout=120, cwd=os.path.dirname(os.path.abspath(__file__)))
        verbs[name] = res.returncode
        if verb == ["tail"]:
            line = json.loads(res.stdout.strip().splitlines()[-1])
            tails[name] = {
                "unacked_critical": line["incidents"]["unacked_critical"],
                "quality_exhausted": line["serve"]["quality"]["exhausted"]}
    got = [np.frombuffer(base64.b64decode(r[2]["flow_b64"]), "<f4")
           .reshape(r[2]["shape"]) for r in results]
    diffs = [float(np.abs(g - x).max() / max(np.abs(x).max(), 1e-30))
             for g, x in zip(got, want)]
    client_ms = [r[3] for r in results]
    parsed = parse_prometheus(metrics[2].decode())
    n_cold = sum(v for (t, m), v in dispatches.items() if m == "cold")
    n_warm = sum(v for (t, m), v in dispatches.items() if m == "warm")
    flo = fmt["flo"][2]
    q = drift_stats["serve_quality"]
    row = {"requests": HTTP_REQUESTS, "threads": HTTP_THREADS,
           "wall_s": wall, "requests_per_s": HTTP_REQUESTS / wall,
           "client": p50_p99(client_ms),
           "engine_hist_p50_ms": stats["serve_latency_p50_ms"],
           "engine_hist_p99_ms": stats["serve_latency_p99_ms"],
           "max_rel_diff_vs_submit": max(diffs),
           "bitwise_equal_to_submit": sum(d == 0.0 for d in diffs),
           "flo": [fmt["flo"][0], fmt["flo"][1], len(flo)],
           "png": [fmt["png"][0], fmt["png"][1], len(fmt["png"][2])],
           "deadline_statuses": [r[0] for r in late],
           "degraded": [[r[0], r[2].get("precision")] for r in degraded],
           "stream_statuses": [r[0] for r in stream],
           "stream_warm": [r[2].get("warm") for r in stream],
           "stream_client_ms": p50_p99([r[3] for r in stream[2:]]),
           "delete_status": deleted[0],
           "dispatches": {f"{t}_{m}": v for (t, m), v in dispatches.items()},
           "launches": counts,
           "healthz_status": health[0], "metrics_samples": len(parsed),
           **{k: stats[k] for k in (
               "deadline_requests", "deadline_enqueue_expired",
               "deadline_flush_expired", "deadline_wait_expired",
               "degrade_tier_downgrades", "serve_server_errors",
               "serve_errors", "serve_responses_by_tier",
               "serve_session_latency_p50_ms",
               "serve_session_latency_p99_ms")},
           "quality": {
               **{k: stats[k] for k in (
                   "serve_quality_sampled", "serve_quality_scored",
                   "serve_quality_dropped", "serve_quality_errors",
                   "serve_quality_photo_p50", "serve_quality_census_p50",
                   "serve_quality_smooth_p50")},
               "scorer_drained": drained,
               "warp_fwd_quality_launches": counts["warp_fwd_quality"],
               "triple_max_rel_vs_numpy": triple_rel,
               "ref_p50": q["ref_p50"], "current_p50": q["current_p50"],
               "drift_ratio": q["drift_ratio"], "breaches": q["breaches"],
               "burn": q["burn"], "exhausted": q["exhausted"],
               "drift_requests": len(drift),
               "drift_statuses": sorted({r[0] for r in drift}),
               "drift_scored": (drift_stats["serve_quality_scored"]
                                - scored0),
               "drift_sampler_picks": drift_picks,
               "scored_total": drift_stats["serve_quality_scored"],
               "warp_fwd_quality_launches_total": quality_launches},
           "incidents": {
               "bundles": [{k: m.get(k) for k in ("id", "kind", "severity",
                                                   "role")}
                           for m in bundles],
               "incident_captured": drift_stats["incident_captured"],
               "incident_deduped": drift_stats["incident_deduped"],
               "verb_rcs": verbs, "tail": tails},
           "ledger": ledger_summary(warm_rows),
           "ledger_trace_s": warm_trace_s,
           "exec_dispatches": stats["exec_dispatches"],
           "exec_mfu_nominal": stats["exec_mfu_nominal"],
           "seconds": time.monotonic() - t0,
           "card": torch.cuda.get_device_name(0)}
    shutil.rmtree(log_dir, ignore_errors=True)
    emit("serve_http", **row)
    warmed = {f"serve:{e['bucket'][0]}x{e['bucket'][1]}:{e['tier']}:"
              f"{e['mode']}" for e in warm["buckets"]}
    expired = sum(stats[k] for k in ("deadline_enqueue_expired",
                                     "deadline_flush_expired",
                                     "deadline_wait_expired"))
    rq = row["quality"]
    checks = {
        "flows": all(r[0] == 200 for r in results)
        and max(diffs) <= HTTP_TOL,
        "formats": fmt["flo"][:2] == (200, "application/octet-stream")
        and np.frombuffer(flo[:4], "<f4")[0] == np.float32(FLO_TAG)
        and fmt["png"][:2] == (200, "image/png"),
        "deadlines": [r[0] for r in late] == [504] * HTTP_DEADLINED
        and all(r[2]["error"] == "deadline_exceeded" for r in late)
        and stats["deadline_requests"] == HTTP_DEADLINED and expired
        >= HTTP_DEADLINED and stats["serve_server_errors"] == 0,
        "degrade": [r[2].get("precision") for r in degraded]
        == ["bf16"] * HTTP_DEGRADED
        and stats["degrade_tier_downgrades"] == HTTP_DEGRADED,
        "stream": [r[0] for r in stream]
        == [202] + [200] * (HTTP_STREAM_FRAMES - 1)
        and [r[2].get("warm") for r in stream[1:]]
        == [False] + [True] * (HTTP_STREAM_FRAMES - 2)
        and deleted[0] == 200,
        "health": health[0] == 200 and metrics[0] == 200
        and parsed.get("deepof_serve_responses")
        == stats["serve_responses"]
        and parsed.get("deepof_serve_quality_scored")
        == stats["serve_quality_scored"],
        "launches": n_cold > 0 and n_warm == HTTP_STREAM_FRAMES - 2
        and counts == want_counts(
            corr=n_cold, warp_fwd=n_warm,
            warp_fwd_quality=stats["serve_quality_scored"]),
        "quality": drained and rq["serve_quality_scored"] > 0
        and rq["serve_quality_scored"] == rq["serve_quality_sampled"]
        == rq["warp_fwd_quality_launches"]
        and rq["serve_quality_dropped"] == rq["serve_quality_errors"] == 0
        and rq["warp_fwd_quality_launches_total"] == rq["scored_total"]
        and triple_rel <= QUALITY_RTOL,
        "drift": not stats["serve_quality"]["exhausted"]
        and rq["exhausted"] and rq["drift_statuses"] == [200]
        and rq["drift_scored"] == drift_picks > 0,
        "incidents": [b["kind"] for b in row["incidents"]["bundles"]]
        == ["quality_drift"]
        and row["incidents"]["bundles"][0]["severity"] == "critical"
        and verbs == {"list": 1, "tail": 9, "ack": 0, "tail after ack": 7,
                      "list again": 0},
        # a row per warmed (bucket, tier, mode) and the scorer's, every
        # library found built; every dispatch timed for the MFU
        "ledger": len(warmed) == 4 and set(warm_rows) == warmed | {
            f"quality:{h}x{w}"} and libraries_found(warm_rows)
        and stats["exec_dispatches"] == stats["serve_batches"]}
    if not all(checks.values()):
        raise AssertionError(f"serve_http: {checks}")
    return row


SERVE_FRAMES = 5
SERVE_HW = (384, 512)  # the frames' size: the bucket's


# the served run's configuration: `cli_train_job`'s (its checkpoint holds
# the accumulator of optim.grad_accum=2, which the restore's template
# must have too)
SERVE_RUN = ["--model", "flownet_c", "--synthetic",
             "--set", f"data.image_size=[{SERVE_HW[0]},{SERVE_HW[1]}]",
             "--set", "optim.grad_accum=2"]


def serve_argv(log_dir: str, extra: tuple = ()) -> list:
    return ["serve", *SERVE_RUN, *extra, "--log-dir", log_dir]


def cli_serve(work: str, log_dir: str, extra: tuple = (),
              while_booting=None) -> dict:
    """`python -m deepof_tpu_torch serve --model flownet_c` on the
    checkpoint of a run in `log_dir` (full width): in a process of its
    own, its "serving" line awaited, one pair posted, a SIGTERM, and exit
    code 0 within `serve.fleet.drain_timeout_s` (10 s) of it, with
    serve_* keys in its heartbeat.json. Then offline mode in this
    process: `serve --input` over a directory of SERVE_FRAMES PNG frames
    at the bucket's size writes SERVE_FRAMES - 1 `.flo` files, each equal
    to `predict`'s for the same pair (cuDNN deterministic).
    `while_booting()` runs while the server boots (its `started_s` is
    then reported as overlapped, beside its own `boot.ready_s`)."""
    import signal

    import numpy as np

    from deepof_tpu_torch.io.flo import read_flo
    from deepof_tpu_torch.io.png import write_png

    t0 = time.monotonic()
    log_path = os.path.join(work, "cli_serve.log")
    argv = serve_argv(log_dir, ("--set", "serve.port=0",
                                "--set", "obs.heartbeat_period_s=0.2",
                                *extra))
    frames = video(42, SERVE_FRAMES, SERVE_HW)
    with open(log_path + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", CLI_SUBPROCESS, *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            if while_booting is not None:
                while_booting()
            line = {}
            while "serving" not in line:
                text = proc.stdout.readline()
                if not text:
                    raise AssertionError(f"cli_serve: the server exited "
                                         f"(rc {proc.wait()}) before "
                                         f"serving; see {log_path}.err")
                if text.startswith("{"):
                    line = json.loads(text)
            started_s = time.monotonic() - t0
            host, port = line["serving"][len("http://"):].split(":")
            reply = http_call((host, int(port)), "POST", "/v1/flow",
                              {"prev": b64_png(frames[0]),
                               "next": b64_png(frames[1])})
            time.sleep(0.5)  # a heartbeat after the response
            t_term = time.monotonic()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
            drain_s = time.monotonic() - t_term
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(os.path.join(log_dir, "heartbeat.json")) as f:
        hb = json.load(f)
    frame_dir = os.path.join(work, "cli_serve_frames")
    os.makedirs(frame_dir, exist_ok=True)
    for i, fr in enumerate(frames):
        write_png(os.path.join(frame_dir, f"f{i:03d}.png"), fr)
    names = sorted(os.listdir(frame_dir))
    out_off = os.path.join(work, "cli_serve_offline")
    out_pred = os.path.join(work, "cli_serve_predict")
    with cudnn_deterministic():
        offline = run_cli(serve_argv(log_dir, extra) + [
            "--input", frame_dir, "--out", out_off, "--no-png"],
            os.path.join(work, "cli_serve_offline.log"))
        run_cli(["predict", *SERVE_RUN, *extra,
                 "--log-dir", log_dir, "--out", out_pred, "--no-png",
                 "--pairs", *[f"{os.path.join(frame_dir, a)}:"
                              f"{os.path.join(frame_dir, b)}"
                              for a, b in zip(names, names[1:])]],
                os.path.join(work, "cli_serve_predict.log"))
    flos = sorted(os.listdir(out_off))
    equal = (flos == sorted(os.listdir(out_pred))
             and all(np.array_equal(read_flo(os.path.join(out_off, n)),
                                    read_flo(os.path.join(out_pred, n)))
                     for n in flos))
    row = {"serving_line": line, "started_s": started_s,
           "started_beside": ("untimed checks of later phases"
                              if while_booting is not None else "nothing"),
           "status": reply[0], "client_ms": reply[3], "rc": rc,
           "drain_s": drain_s,
           "heartbeat": {k: hb.get(k) for k in (
               "serve_requests", "serve_responses", "serve_errors",
               "serve_latency_p50_ms", "wedged", "dev_mem_bytes_in_use")},
           "offline": offline, "offline_flo": flos,
           "offline_equals_predict": equal,
           "seconds": time.monotonic() - t0}
    emit("cli_serve", **row)
    if not (reply[0] == 200 and rc == 0 and drain_s <= 10.0
            and hb.get("serve_responses") == 1 and not hb.get("wedged")
            and offline["pairs"] == SERVE_FRAMES - 1
            and offline["errors"] == 0
            and len(flos) == SERVE_FRAMES - 1 and equal):
        raise AssertionError(f"cli_serve: {row}")
    return row


# the fleet phases: FlowNet-C at full width from `python -m
# deepof_tpu_torch serve --replicas 2` (and `--autoscale`) on the served
# run's checkpoint, each replica a process of its own on the card
FLEET_REQUESTS = 64   # per load, from FLEET_THREADS client threads
FLEET_THREADS = 8
FLEET_PAIRS = 16      # distinct PNG pairs, cycled
FLEET_SESSIONS = 2
FLEET_FRAMES = 6
FLEET_SPILL = 2       # serve.fleet.spill_in_flight: the load spreads
FLEET_FAULT_AFTER = 8  # the drill's crash: responses past the clean load
FLEET_DRILL_ROUNDS = 6  # loads of FLEET_REQUESTS at most until it crashes
FLEET_AFTER_REQUESTS = 32  # on the respawned fleet, with the streams
FLEET_SLOTS = 4       # replica-<i>/ckpt links made for i < this
FLEET_AFTER_SCALE_S = 2.0  # the burst goes on this long past scale-up
FLEET_FLAGS = ("--set", "serve.port=0",
               "--set", "obs.heartbeat_period_s=0.5",
               "--set", "serve.fleet.poll_s=0.2",
               "--set", "serve.session.warm_start=true")


def gpu_memory_mib() -> int:
    """The card's memory in use, MiB, as nvidia-smi reads it (every
    process's, the CUDA contexts included)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=memory.used",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout
    return int(out.strip().splitlines()[0])


def gpu_compute_pids() -> list[int]:
    """The pids nvidia-smi lists as holding a CUDA context on the card,
    one a context (in a container they may be another namespace's)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def link_checkpoints(fleet_dir: str, run_dir: str) -> None:
    """A replica restores from `<its log_dir>/ckpt`, as the JAX fleet's
    does (ROADMAP F16): link the served run's checkpoints there for every
    slot the fleet may spawn."""
    for i in range(FLEET_SLOTS):
        d = os.path.join(fleet_dir, f"replica-{i}")
        os.makedirs(d, exist_ok=True)
        os.symlink(os.path.abspath(os.path.join(run_dir, "ckpt")),
                   os.path.join(d, "ckpt"))


def spawn_serving(argv: list, log_path: str):
    """`python -m deepof_tpu_torch <argv>` started in a process of its
    own, as a user runs it, and not waited for (`await_serving`)."""
    err = open(log_path + ".err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deepof_tpu_torch", *argv],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=err, text=True)
    err.close()
    proc.argv, proc.log_path = argv, log_path
    proc.started_at = time.monotonic()
    return proc


def await_serving(proc):
    """A `spawn_serving` process with its parsed "serving" line and its
    address, once it has announced itself."""
    line: dict = {}
    while "serving" not in line:
        text = proc.stdout.readline()
        if not text:
            raise AssertionError(
                f"{proc.argv[:2]}: exited (rc {proc.wait()}) before "
                f"serving; see {proc.log_path}.err")
        if text.startswith("{"):
            line = json.loads(text)
    TIMELINE.append([f"{os.path.basename(proc.log_path)} ready",
                     round(proc.started_at - START, 2),
                     round(time.monotonic() - proc.started_at, 2)])
    host, port = line["serving"][len("http://"):].split(":")
    return proc, line, (host, int(port))


def start_serving(argv: list, log_path: str):
    """`python -m deepof_tpu_torch <argv>` in a process of its own, as a
    user runs it; returns it with its parsed "serving" line."""
    return await_serving(spawn_serving(argv, log_path))


def running(pid: int) -> bool:
    """Whether `pid` is a process that has not exited (a zombie, exited
    and not yet reaped by its new parent, runs no more)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def stop_serving(proc, pids=(), grace_s: float = 2.0):
    """SIGTERM, the exit code and the seconds to it, and the `pids` still
    running `grace_s` after the server exited: what it left behind. Only
    once that is read are they, and the server if it hung, SIGKILLed."""
    import signal

    t0 = time.monotonic()
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.monotonic() - t0
    deadline = time.monotonic() + grace_s
    left = [p for p in pids if running(p)]
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        left = [p for p in left if running(p)]
    for pid in left:
        with contextlib.suppress(ProcessLookupError):
            os.kill(pid, signal.SIGKILL)
    return rc, seconds, left


def healthz(address) -> dict:
    return http_call(address, "GET", "/healthz")[2]


def wait_health(address, ok, what: str, timeout_s: float = 240.0,
                seen: list | None = None) -> dict:
    """Poll /healthz until `ok(stats)`; the stats. Each poll's stats go to
    `seen` when it is given."""
    deadline = time.monotonic() + timeout_s
    while True:
        h = healthz(address)
        if seen is not None:
            seen.append(h)
        if ok(h):
            return h
        if time.monotonic() > deadline:
            state = {k: h.get(k) for k in ("fleet_states", "fleet_ready",
                                           "degrade_level", "fleet_retired")}
            raise AssertionError(f"no {what} within {timeout_s} s: {state}")
        time.sleep(0.2)


def fleet_load(address, bodies: list, n: int = FLEET_REQUESTS,
               threads: int = FLEET_THREADS) -> dict:
    """`n` POST /v1/flow from `threads` client threads, the bodies
    cycled: every reply (status, JSON or error text, client ms), the wall
    seconds and requests/s."""
    replies: list = [None] * n

    def client(k: int) -> None:
        for i in range(k, n, threads):
            try:
                replies[i] = http_call(address, "POST", "/v1/flow",
                                       bodies[i % len(bodies)])
            except Exception as e:  # noqa: BLE001 - a drop is a failure
                replies[i] = (-1, None, f"{type(e).__name__}: {e}", 0.0)

    wall = run_clients(threads, client)
    ok = [r for r in replies if r[0] == 200]
    return {"replies": replies, "wall_s": wall, "ok": len(ok),
            "requests_per_s": n / wall,
            "client": p50_p99([r[3] for r in ok]),
            "statuses": dict(collections.Counter(r[0] for r in replies))}


def replica_records(fleet_dir: str) -> dict[int, list[dict]]:
    """Each replica directory's kind="serve" records (one a replica
    process that exited by SIGTERM)."""
    out = {}
    for name in sorted(os.listdir(fleet_dir)):
        path = os.path.join(fleet_dir, name, "metrics.jsonl")
        if name.startswith("replica-") and os.path.exists(path):
            out[int(name.split("-")[1])] = [
                r for r in read_records(os.path.join(fleet_dir, name))
                if r.get("kind") == "serve"]
    return out


def launches_match_dispatches(rec: dict, verified: int = 0) -> bool:
    """FlowNet-C serving: one correlation launch a cold dispatch and one
    warp launch a warm one, so the two add up to the replica's
    dispatches and the `verified` re-runs of its deep verify; no bf16
    correlation (the bf16 tier computes in float32) and no backward
    kernel."""
    k = rec["kernel_launches"]
    return (k["corr"] + k["warp_fwd"] == rec["serve_batches"] + verified
            and all(v == 0 for n, v in k.items()
                    if n not in ("corr", "warp_fwd")))


#: the fleet's serving lattice (SERVE_RUN under FLEET_FLAGS: the 384x512
#: bucket, f32, cold and warm), as `warmup --serve` publishes it
FLEET_LATTICE = ("serve:384x512:f32:cold", "serve:384x512:f32:warm")


def start_warmup_serve(work: str, extra: tuple = ()) -> tuple:
    """`warmup --serve --serve-only --artifacts <work>/exec` on the
    fleet's config (SERVE_RUN, FLEET_FLAGS, `extra`) in a process of its
    own, the single writer, started and left running: main starts it
    ahead of cli_serve, so the two overlap. Returns (the process, its
    start on the monotonic clock, its stderr path, the flags)."""
    flags = [*SERVE_RUN, *FLEET_FLAGS, *extra]
    err = os.path.join(work, "warmup_serve.err")
    with open(err, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "deepof_tpu_torch", "warmup", "--serve",
             "--serve-only", "--artifacts", os.path.join(work, "exec"),
             *flags, "--log-dir", os.path.join(work, "warmup_serve")],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=f, text=True)
    return proc, time.monotonic(), err, flags


def publish_artifacts(work: str, extra: tuple = (), device: str = "cuda",
                      warmup=None) -> dict:
    """The artifact plane (`serve/artifacts.py`) on the fleet's config,
    before serve_fleet boots its replicas from the store:
      - the `warmup --serve` process of `start_warmup_serve` (`warmup`,
        else started here) ends rc 0: each FLEET_LATTICE entry
        published with the libraries its call launched (corr for the
        cold one, warp for the warm one) and indexed;
      - `artifacts list` and `artifacts verify` rc 0, `artifacts verify
        --deep` rc 0 with no drift (the lattice traced in this process,
        each fingerprint the index's).
    Returns the row; row["store"] is the store serve_fleet boots from,
    and row["flags"] the publishing config's (`artifacts_corrupt` checks
    a corrupted copy of the store on them)."""
    t0 = time.monotonic()
    store = os.path.join(work, "exec")
    proc, started, err, flags = warmup or start_warmup_serve(work, extra)
    out, _ = proc.communicate(timeout=600)
    warmup_s = time.monotonic() - started  # to its exit
    if proc.returncode != 0:
        raise AssertionError(f"warmup --serve: rc {proc.returncode}; see "
                             f"{err}")
    rep = json.loads(out.strip().splitlines()[-1])
    verbs = {}
    # the deep verify takes the publishing config's flags (--synthetic
    # only resets what --set sets again here)
    deep = [f for f in flags if f != "--synthetic"]
    for key, argv in (("list", ["list"]), ("verify", ["verify"]),
                      ("deep", ["verify", "--deep", *deep])):
        verbs[key] = run_verb(["artifacts", *argv, "--dir", store],
                              os.path.join(work, f"artifacts_{key}.log"))
    row = {
        "store": store, "warmup_s": warmup_s,
        "published": rep["artifacts"],
        "entries": {b["mode"]: {"fingerprint": b["fingerprint"],
                                "libraries": b["libraries"],
                                "artifact": b["artifact"]}
                    for b in rep["buckets"]},
        "verbs": {k: {"rc": rc, **({"total": v.get("total"),
                                    "ok": v.get("ok"),
                                    "drift": v.get("drift"),
                                    "unindexed": v.get("unindexed")}
                                   if isinstance(v, dict) else {})}
                  for k, (rc, v) in verbs.items()},
        "flags": flags}
    row["seconds"] = time.monotonic() - t0
    emit("publish_artifacts", **row)
    checks = {
        "published": rep["artifacts"]["published"]
        == rep["artifacts"]["index_entries"] == len(FLEET_LATTICE)
        and [b["libraries"] for b in rep["buckets"]] == (
            [["corr"], ["warp"]] if device == "cuda" else [[], []]),
        "verbs": verbs["list"][0] == verbs["verify"][0] == 0
        and verbs["deep"][0] == 0
        and verbs["deep"][1]["ok"] == len(FLEET_LATTICE)
        and not verbs["deep"][1]["drift"]}
    if not all(checks.values()):
        raise AssertionError(f"publish_artifacts: {checks}")
    return row


def artifacts_corrupt(work: str, published: dict) -> dict:
    """The artifact plane's reject path, on the card, after
    `publish_artifacts` (`published`, its row): a copy of the store with
    one byte of its cold entry's corr library flipped. `artifacts
    verify` on it rc 1 naming crc_mismatch, and an engine on the copy
    over an empty build directory (this process's BUILD_DIR and loaded
    libraries swapped for the call, and put back; the fleet's config
    without the warm start, whose construction would run the forward
    before `warm()`; so another config digest, an index miss) rejects
    corr loudly (stderr, exec_artifact_rejects: the library and the
    entry) and builds it from source in its first call (the row's
    cache_verdict "miss", one library built). Nothing in it is timed:
    main runs it while serve_fleet's replicas boot."""
    from pathlib import Path

    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.obs.ledger import load_ledger
    from deepof_tpu_torch.ops.cuda import build
    from deepof_tpu_torch.serve.artifacts import MANIFEST, verify_entry
    from deepof_tpu_torch.serve.engine import InferenceEngine

    # one byte of the cold entry's corr library
    copy = os.path.join(work, "exec_corrupt")
    shutil.copytree(published["store"], copy)
    fp = published["entries"]["cold"]["fingerprint"]
    flags = published["flags"]
    with open(os.path.join(copy, fp, MANIFEST)) as f:
        lib = os.path.join(copy, fp, json.load(f)["libraries"][0]["file"])
    with open(lib, "r+b") as f:
        f.seek(os.path.getsize(lib) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))
    bad_rc, bad = run_verb(["artifacts", "verify", "--dir", copy],
                           os.path.join(work, "artifacts_corrupt.log"))
    _, cfg_dict = run_verb(["config", *flags, "--set",
                            "serve.session.warm_start=false", "--set",
                            f"serve.artifacts_dir={copy}"],
                           os.path.join(work, "config.log"))
    cfg = config_from_dict(cfg_dict)
    saved = (build.BUILD_DIR, build._libs)
    built_before = len(build.built_names())
    t = time.monotonic()
    stderr = io.StringIO()
    try:
        build.BUILD_DIR = Path(work) / "build_cold"
        build._libs = {}
        with contextlib.redirect_stderr(stderr), InferenceEngine(
                cfg, device="cuda",
                ledger_dir=os.path.join(work, "corrupt")) as eng:
            warm = eng.warm()
            stats = eng.stats()
    finally:
        build.BUILD_DIR, build._libs = saved
    rows = {r["name"]: r for r in load_ledger(os.path.join(work, "corrupt"))
            if r["kind"] == "exec"}
    out = {"fingerprint": fp, "verify_rc": bad_rc,
           "corrupt": bad.get("corrupt"),
           "why": verify_entry(copy, fp)["why"],
           "library_fetch": warm.get("libraries"),
           "built_from_source": build.built_names()[built_before:],
           "rows": {n: {"compile_kind": r["compile_kind"],
                        "cache_verdict": r["cache_verdict"]}
                    for n, r in rows.items()},
           "warned": "REJECT" in stderr.getvalue(),
           **{k: stats[k] for k in (
               "exec_artifact_rejects", "exec_index_hits",
               "exec_index_misses", "exec_index_rejects")},
           "seconds": time.monotonic() - t}
    shutil.rmtree(copy, ignore_errors=True)
    emit("artifacts_corrupt", **out)
    if not (out["verify_rc"] == 1 and out["corrupt"] == [fp]
            and out["why"].startswith("crc_mismatch")
            and out["library_fetch"] == {"corr": "reject:crc_mismatch"}
            and out["built_from_source"] == ["corr"] and out["warned"]
            and out["exec_artifact_rejects"] == 2
            and out["exec_index_misses"] == 1
            and out["rows"] == {FLEET_LATTICE[0]: {
                "compile_kind": "first_step", "cache_verdict": "miss"}}):
        raise AssertionError(f"artifacts_corrupt: {out}")
    return out


def cold_tree_boots(work: str, extra: tuple = ()) -> dict:
    """On demand (not in `main`): what the artifact store saves a replica
    on a cold tree. A 2-step full-width FlowNet-C run (SERVE_RUN) and a
    store published from this checkout (`warmup --serve --serve-only`,
    FLEET_FLAGS: warm start, so corr and warp), then `serve` booted
    twice from a copy of `deepof_tpu_torch/` in an empty root (its
    `build/` cold): without `--artifacts` (each library built by nvcc
    under the build lock), and, the copy's `build/` emptied again, with
    it (each library installed from the store). Each boot's split (the
    announce line's `boot`: `library_load_s`, `library_fetch`, ...),
    its spawn-to-ready seconds (the Popen to the announce line) and its
    ledger rows' verdicts, in one emitted line."""
    root = os.path.dirname(os.path.abspath(__file__))
    flags = [*SERVE_RUN, *FLEET_FLAGS, *extra]
    run = os.path.join(work, "run")
    run_cli(["train", *SERVE_RUN, *extra, "--steps", "2", "--log-dir", run],
            os.path.join(work, "cold_train.log"))
    store = os.path.join(work, "exec")
    subprocess.run([sys.executable, "-m", "deepof_tpu_torch", "warmup",
                    "--serve", "--serve-only", "--artifacts", store, *flags,
                    "--log-dir", os.path.join(work, "warmup")], cwd=root,
                   check=True, stdout=subprocess.DEVNULL, timeout=600)
    cold = os.path.join(work, "cold_root")
    shutil.copytree(os.path.join(root, "deepof_tpu_torch"),
                    os.path.join(cold, "deepof_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    boots = {}
    for name, more in (("without_store", ()),
                       ("with_store", ("--artifacts", store))):
        shutil.rmtree(os.path.join(cold, "build"), ignore_errors=True)
        d = os.path.join(work, f"boot_{name}")
        os.makedirs(d)
        os.symlink(os.path.join(run, "ckpt"), os.path.join(d, "ckpt"))
        t0 = time.monotonic()
        with open(os.path.join(d, "stderr.log"), "w") as err:
            proc = subprocess.Popen(
                [sys.executable, "-m", "deepof_tpu_torch", "serve", *flags,
                 *more, "--log-dir", d], cwd=cold, stdout=subprocess.PIPE,
                stderr=err, text=True)
        line: dict = {}
        while "serving" not in line:
            text = proc.stdout.readline()
            if not text:
                raise AssertionError(f"cold_tree_boots {name}: exited (rc "
                                     f"{proc.wait()}) before serving")
            if text.startswith("{"):
                line = json.loads(text)
        ready_s = time.monotonic() - t0
        rc, _, _ = stop_serving(proc)
        from deepof_tpu_torch.obs.ledger import load_ledger

        boots[name] = {
            "spawn_to_ready_s": ready_s, "rc": rc, "boot": line["boot"],
            "built": sorted(os.listdir(os.path.join(
                cold, "build", "deepof_tpu_torch"))),
            "rows": {r["name"]: {k: r[k] for k in (
                "compile_kind", "cache_verdict", "cache_hits",
                "cache_misses", "compile_s", "resolve_s")}
                for r in load_ledger(d) if r["kind"] == "exec"
                and r["compile_kind"] != "deep_verify"}}
    row = {"boots": boots}
    emit("cold_tree_boots", **row)
    return row


def serve_fleet(work: str, run_dir: str, extra: tuple = (),
                device: str = "cuda", artifacts: str | None = None,
                while_booting=None, after_drain=None) -> dict:
    """`serve --replicas 2 --model flownet_c` on the served run's
    checkpoint (SERVE_RUN: full width, the 384x512 bucket, max_batch 8,
    f32, warm-start sessions), each replica-<i>/ckpt linked to the run's
    (F16), booting from the artifact store `artifacts` when given
    (`publish_artifacts`: each replica's final record shows every
    FLEET_LATTICE entry resolved through the index, no reject, and
    every entry deep-verified ok), against `serve` alone under the same
    load:
      - `serve` alone: FLEET_REQUESTS POST /v1/flow from FLEET_THREADS
        client threads (requests/s, client p50/p99), SIGTERM, exit 0;
      - one fleet (spill at FLEET_SPILL in flight, so the load spreads)
        with `replica_crash` armed at replica 1 FLEET_FAULT_AFTER
        responses past the most the clean load can give it:
        - the clean load, the same as `serve` alone's, with no eviction;
          nvidia-smi counts one more CUDA context a replica and none for
          the supervisor;
        - the crash drill: rounds of the same load until replica 1 has
          crashed, answered >= 99% (every failure structured), then its
          respawn: its spawn-to-ready seconds, and the card's memory
          before the kill and after the respawn;
        - on the respawned fleet, FLEET_SESSIONS streams of FLEET_FRAMES
          frames through /v1/flow/stream and FLEET_AFTER_REQUESTS more
          pairs (fewer than re-arm the respawn's crash);
        - SIGTERM: exit 0 within serve.fleet.drain_timeout_s and no
          replica process running after the supervisor's exit; one
          eviction, one crash and one respawn in all;
      - each replica's final record (replica 1's from its respawn): it
        served, and its correlation and warp launches add up to its
        dispatches, the warps at most the warm steps (a warm dispatch may
        carry both sessions'); every flow of every load and stream
        within HTTP_TOL of `engine.submit` / `submit_next` in this
        process on the same weights, computed once the fleet has drained.
    `while_booting()` runs while the fleet's replicas boot (main runs
    untimed checks there: F17's engine process, the store's corrupted
    copy, a kernel step against a plain one), so their
    spawn-to-ready seconds are reported as overlapped; `serve` alone's
    boot runs alone. `after_drain()` runs once the fleet has drained,
    before this phase's reference, verbs and checks (main starts
    serve_autoscale's fleet there)."""
    import base64

    import numpy as np

    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.predict import restore_params
    from deepof_tpu_torch.serve.engine import InferenceEngine

    t0 = time.monotonic()
    h, w = SERVE_HW
    rs = np.random.RandomState(50)
    pairs = [(rs.randint(0, 256, (h, w, 3), dtype=np.uint8),
              rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
             for _ in range(FLEET_PAIRS)]
    bodies = [{"prev": b64_png(a), "next": b64_png(b)} for a, b in pairs]
    clips = [video(51 + s, FLEET_FRAMES, SERVE_HW)
             for s in range(FLEET_SESSIONS)]
    clip_frames = [[b64_png(f) for f in clip] for clip in clips]
    base = [*SERVE_RUN, *FLEET_FLAGS, *extra]
    row: dict = {}
    # contexts on the card before the fleet: this process's
    apps_before = gpu_compute_pids() if device == "cuda" else []

    # -- `serve` alone
    proc, line, address = start_serving(
        ["serve", *base, "--log-dir", run_dir],
        os.path.join(work, "serve_single.log"))
    try:
        single = fleet_load(address, bodies)
    finally:
        rc, drain_s, _ = stop_serving(proc)
    single_rec = [r for r in read_records(run_dir)
                  if r.get("kind") == "serve"][-1]
    row["single"] = {k: single[k] for k in (
        "requests_per_s", "client", "statuses", "wall_s")}
    row["single"].update(rc=rc, drain_s=drain_s,
                         kernel_launches=single_rec["kernel_launches"],
                         serve_batches=single_rec["serve_batches"],
                         boot=single_rec.get("boot"))

    # -- the fleet: the clean load, the crash drill, the streams
    fleet_dir = os.path.join(work, "serve_fleet")
    link_checkpoints(fleet_dir, run_dir)
    argv = ["serve", "--replicas", "2", *base, "--set",
            f"serve.fleet.spill_in_flight={FLEET_SPILL}",
            "--set", "obs.trace=true",
            "--set", "resilience.faults.enabled=true",
            "--set", "resilience.faults.replica_crash_at=[1]",
            "--set", f"resilience.faults.replica_fault_after="
                     f"{FLEET_REQUESTS + FLEET_FAULT_AFTER}",
            *(("--artifacts", artifacts) if artifacts else ()),
            "--log-dir", fleet_dir]
    proc = spawn_serving(argv, os.path.join(work, "serve_fleet.log"))
    pids: list = []
    rounds: list = []
    try:
        if while_booting is not None:
            with spanned("serve_fleet while_booting"):
                while_booting()
            if device == "cuda":
                import torch

                torch.cuda.empty_cache()  # the card's memory, read below
        proc, line, address = await_serving(proc)
        ready = wait_health(address, lambda s: s.get("fleet_ready") == 2,
                            "two replicas ready")
        pids = [r["pid"] for r in ready["replicas"]]
        apps = gpu_compute_pids() if device == "cuda" else []
        load = fleet_load(address, bodies)
        clean = healthz(address)
        mem_before = gpu_memory_mib() if device == "cuda" else None
        while (len(rounds) < FLEET_DRILL_ROUNDS
               and healthz(address)["fleet_crashes"] == 0):
            rounds.append(fleet_load(address, bodies))
        back = wait_health(
            address, lambda s: s.get("fleet_ready") == 2
            and s.get("fleet_respawns", 0) >= 1, "respawn ready")
        pids += [r["pid"] for r in back["replicas"]]
        mem_after = gpu_memory_mib() if device == "cuda" else None
        streams: list = [None] * FLEET_SESSIONS

        def stream(k: int) -> None:
            streams[k] = [http_call(address, "POST", "/v1/flow/stream",
                                    {"session": f"clip{k}", "frame": f})
                          for f in clip_frames[k]]

        run_clients(FLEET_SESSIONS, stream)
        after = fleet_load(address, bodies, n=FLEET_AFTER_REQUESTS)
    finally:
        rc, drain_s, left = stop_serving(proc, pids)
    if after_drain is not None:
        after_drain()
    recs = {i: r[-1] for i, r in replica_records(fleet_dir).items()}
    summary = [r for r in read_records(fleet_dir)
               if r.get("kind") == "serve"][-1]
    # the in-process reference on the same weights and configuration
    with open(os.path.join(fleet_dir, "replica-0", "config.json")) as f:
        rcfg = config_from_dict(json.load(f))
    with spanned("serve_fleet reference"), InferenceEngine(
            rcfg, model=restore_params(rcfg, device=device),
            device=device) as eng:
        want = [f.result(timeout=600)["flow"] for f in
                [eng.submit(a, b) for a, b in pairs]]
        want_stream = [[eng.submit_next(f"clip{k}", fr).result(timeout=600)
                        for fr in clip] for k, clip in enumerate(clips)]

    def rel(reply, ref) -> float:
        got = np.frombuffer(base64.b64decode(reply[2]["flow_b64"]),
                            "<f4").reshape(reply[2]["shape"])
        return float(np.abs(got - ref).max()
                     / max(np.abs(ref).max(), 1e-30))

    drill = [r for d in rounds for r in d["replies"]]
    diffs = [rel(r, want[i % FLEET_PAIRS])
             for d in (load, *rounds, after)
             for i, r in enumerate(d["replies"]) if r[0] == 200]
    stream_diffs = [rel(r, ref["flow"]) for s, ws in zip(streams,
                                                          want_stream)
                    for r, ref in zip(s, ws) if r[0] == 200]
    warm_steps = sum(bool(r[2].get("warm")) for s in streams for r in s
                     if r[0] == 200)
    failures = [r for r in drill if r[0] != 200]
    respawned = next(r for r in back["replicas"] if r["replica"] == 1)
    row["fleet"] = {k: load[k] for k in ("requests_per_s", "client",
                                         "statuses", "wall_s")}
    row["fleet"].update(
        spawn_to_ready_s=[r["ready_s"] for r in ready["replicas"]],
        boot_beside=("untimed checks (F17's engine process, the store's "
                     "corrupted copy, a kernel step against a plain "
                     "one)" if while_booting is not None else "nothing"),
        routed=clean["fleet_routed"],
        evictions=clean["fleet_evictions"],
        nvidia_smi_compute_pids={"before": apps_before, "fleet": apps},
        parent_pid=proc.pid, replica_pids=pids)
    row["drill"] = {
        "rounds": len(rounds), "requests": len(drill),
        "ok": len(drill) - len(failures),
        "statuses": dict(collections.Counter(r[0] for r in drill)),
        "requests_per_s": [d["requests_per_s"] for d in rounds],
        "failures": [[r[0], str(r[2])[:120]] for r in failures],
        "respawn_ready_s": respawned["ready_s"],
        "respawn_incarnation": respawned["incarnation"],
        "memory_mib_before_kill": mem_before,
        "memory_mib_after_respawn": mem_after}
    row["after_respawn"] = {
        "statuses": after["statuses"], "requests_per_s":
        after["requests_per_s"],
        "stream_statuses": [[r[0] for r in s] for s in streams],
        "warm_steps": warm_steps}
    # a boot's split (serve/server.py): each replica's final record, the
    # supervisor's spawn-to-ready beside it (replica 1's from its respawn)
    spawned = {r["replica"]: r["ready_s"] for r in ready["replicas"]}
    spawned[1] = respawned["ready_s"]
    row["boot"] = {i: {**(r.get("boot") or {}),
                       "supervisor_ready_s": spawned.get(i)}
                   for i, r in recs.items()}
    # the artifact plane's counters of each replica's final record
    art_keys = ("exec_index_hits", "exec_index_misses", "exec_index_rejects",
                "exec_artifact_rejects", "exec_deep_verify_ok",
                "exec_deep_verify_demoted", "exec_deep_verify_pending")
    row["artifacts"] = {i: {k: r.get(k) for k in art_keys}
                        for i, r in recs.items()}
    row.update(
        rc=rc, drain_s=drain_s, replicas_left=left,
        max_rel_diff_vs_submit=max(diffs),
        max_rel_diff_vs_submit_next=max(stream_diffs),
        replicas={i: {k: r.get(k) for k in (
            "kernel_launches", "serve_batches", "serve_responses",
            "serve_sessions_warm_steps", "serve_latency_p50_ms",
            "serve_latency_p99_ms")} for i, r in recs.items()},
        **{k: summary[k] for k in (
            "fleet_evictions", "fleet_crashes", "fleet_respawns",
            "fleet_failovers", "fleet_retries", "fleet_broken")})
    row["speedup_requests_per_s"] = (load["requests_per_s"]
                                     / single["requests_per_s"])
    # the verbs that read a run, on the drill's tree: `tail --fleet`
    # (rc 4 from the eviction), `analyze` (the replicas aggregated) and
    # one merged trace of the router and the replicas
    from deepof_tpu_torch.obs.aggregate import aggregate_run

    tail_rc, tail = run_verb(["tail", "--log-dir", fleet_dir, "--fleet"],
                             os.path.join(work, "serve_fleet_tail.log"))
    an_rc, an = run_verb(["analyze", "--log-dir", fleet_dir, "--no-plot"],
                         os.path.join(work, "serve_fleet_analyze.log"))
    merged = aggregate_run(fleet_dir)
    # the replicas' ledgers: a row per warmed (bucket, tier, mode) in each
    # replica's own dir, and `tail --fleet` diffing every replica against
    # replica 0's (fingerprints and library builds; first-call seconds
    # and memory bounded loosely: replicas boot under each other's load)
    replica_ledgers = {i: ledger_rows(os.path.join(fleet_dir,
                                                   f"replica-{i}"))
                       for i in recs}
    gate_rc, gate = run_verb(
        ["tail", "--log-dir", fleet_dir, "--fleet", "--ledger-baseline",
         os.path.join(fleet_dir, "replica-0", "ledger.jsonl"),
         "--ledger-compile-factor", "1000", "--ledger-memory-factor",
         "1000"], os.path.join(work, "serve_fleet_ledger_tail.log"))
    children = (gate.get("ledger_diff") or {}).get("children") or {}
    row["verbs"] = {
        "tail_rc": tail_rc,
        "tail_fleet": {k: (tail.get("fleet") or {}).get(k) for k in (
            "evictions", "crashes", "respawns", "broken")},
        "tail_incidents": tail.get("incidents"),
        "analyze_rc": an_rc,
        "analyze_processes": sorted(an.get("processes") or {}),
        "analyze_merged_requests": (an.get("merged") or {}).get("requests"),
        "merged_trace": {k: merged[k] for k in (
            "spans", "flows", "request_ids", "requests_correlated")},
        "merged_processes": [p["name"] for p in merged["processes"]],
        "ledger_tail_rc": gate_rc, "ledger_children": children,
        "replica_ledgers": {i: ledger_summary(r)
                            for i, r in replica_ledgers.items()}}
    row["seconds"] = time.monotonic() - t0
    emit("serve_fleet", **row)
    served = {i: r for i, r in recs.items() if r["serve_responses"]}
    # a store's deep verify re-runs each lattice entry once after warm():
    # one corr launch (the cold entry) and one warp launch (the warm one)
    rounds_verified = {
        i: ((r.get("exec_deep_verify_ok") or 0)
            + (r.get("exec_deep_verify_demoted") or 0)) // len(FLEET_LATTICE)
        for i, r in recs.items()}
    checks = {
        "single": single["ok"] == FLEET_REQUESTS and row["single"]["rc"] == 0
        and launches_match_dispatches(single_rec),
        "fleet_flows": load["ok"] == FLEET_REQUESTS
        and clean["fleet_evictions"] == 0
        and after["ok"] == FLEET_AFTER_REQUESTS
        and row["max_rel_diff_vs_submit"] <= HTTP_TOL,
        "streams": all([r[0] for r in s] == [202] + [200] * (
            FLEET_FRAMES - 1) for s in streams)
        and warm_steps == FLEET_SESSIONS * (FLEET_FRAMES - 2)
        and row["max_rel_diff_vs_submit_next"] <= HTTP_TOL,
        "replicas_served": sorted(served) == [0, 1],
        # a warm dispatch may carry both sessions' steps
        "launches": all(launches_match_dispatches(
            r, 2 * rounds_verified[i]) and r["kernel_launches"]["corr"] > 0
            for i, r in served.items())
        and 0 < sum(r["kernel_launches"]["warp_fwd"] - rounds_verified[i]
                    for i, r in recs.items())
        <= sum(r["serve_sessions_warm_steps"] for r in recs.values())
        == warm_steps,
        # one context a replica, none in the supervisor (nvidia-smi's
        # pids may be another namespace's, so they are counted)
        "no_cuda_in_parent": device != "cuda"
        or (len(apps) == len(apps_before) + 2
            and proc.pid not in apps),
        "drill": bool(rounds) and summary["fleet_crashes"] == 1
        and len(drill) - len(failures) >= math.ceil(0.99 * len(drill))
        and all(r[0] > 0 and isinstance(r[2], dict) and "error" in r[2]
                for r in failures)
        and summary["fleet_evictions"] == 1
        and summary["fleet_respawns"] == 1
        and (mem_before is None or abs(mem_after - mem_before) <= 512),
        "drain": rc == 0 and drain_s <= 10.0 and not left,
        # no incident plane here (obs.incidents off): the eviction gives
        # the code
        "verbs": tail_rc == 4 and row["verbs"]["tail_fleet"]["evictions"]
        == 1 and an_rc == 0
        and row["verbs"]["analyze_processes"] == ["replica-0", "replica-1"]
        and row["verbs"]["merged_processes"][1:] == ["replica-0",
                                                     "replica-1"]
        and merged["requests_correlated"] >= 1,
        "ledger": gate_rc == 4 and sorted(children) == ["replica-0",
                                                        "replica-1"]
        and not any(c["fingerprint_drift"] or c["unexpected_recompiles"]
                    for c in children.values())
        and all(set(r) == {"serve:384x512:f32:cold", "serve:384x512:f32:warm"}
                and libraries_found(r, needed=device == "cuda")
                for r in replica_ledgers.values()),
        "boot": all(b.get("warm_s") is not None
                    and b.get("ready_s") is not None
                    and (device != "cuda"
                         or b.get("cuda_context_s") is not None)
                    for b in row["boot"].values()),
        "artifacts": artifacts is None or all(
            (a["exec_index_hits"], a["exec_index_rejects"],
             a["exec_artifact_rejects"], a["exec_deep_verify_ok"],
             a["exec_deep_verify_demoted"])
            == (len(FLEET_LATTICE), 0, 0, len(FLEET_LATTICE), 0)
            for a in row["artifacts"].values())}
    if not all(checks.values()):
        raise AssertionError(f"serve_fleet: {checks}")
    return row


AUTOSCALE_WINDOWS = {"serve.fleet.max_in_flight": 8,
                     "serve.fleet.autoscale_period_s": 0.25,
                     "serve.fleet.autoscale_up_after_s": 1.0,
                     "serve.fleet.autoscale_up_cooldown_s": 60.0,
                     "serve.fleet.autoscale_down_after_s": 2.0,
                     "serve.fleet.autoscale_down_cooldown_s": 3.0,
                     "serve.degrade.enabled": "true",
                     "serve.degrade.period_s": 0.1,
                     "serve.degrade.escalate_after_s": 0.3,
                     "serve.degrade.escalate_cooldown_s": 0.5,
                     "serve.degrade.recover_after_s": 1.0,
                     "serve.degrade.recover_cooldown_s": 0.5}


def spawn_autoscale(work: str, run_dir: str, extra: tuple = ()):
    """serve_autoscale's `serve --autoscale` started (its replica-<i>/ckpt
    links made first) and not waited for: main starts it once
    serve_fleet has drained, so its first replica boots beside
    serve_fleet's verbs and checks."""
    h, w = SERVE_HW
    fleet_dir = os.path.join(work, "serve_autoscale")
    link_checkpoints(fleet_dir, run_dir)
    argv = ["serve", "--autoscale", "--min-replicas", "1",
            "--max-replicas", "2", *SERVE_RUN, *FLEET_FLAGS,
            "--set", "serve.precisions=('f32','bf16')",
            "--set", f"serve.buckets=[[{h},{w}],[{h // 2},{w // 2}]]",
            *[x for k, v in AUTOSCALE_WINDOWS.items()
              for x in ("--set", f"{k}={v}")],
            *extra, "--log-dir", fleet_dir]
    return spawn_serving(argv, os.path.join(work, "serve_autoscale.log"))


def serve_autoscale(work: str, run_dir: str, proc, extra: tuple = (),
                    device: str = "cuda") -> dict:
    """`serve --autoscale --min-replicas 1 --max-replicas 2` on the served
    run's checkpoint with the tiers (f32, bf16), the buckets 384x512 and
    192x256, the brownout controller on, and short windows:
      - a burst of FLEET_THREADS closed-loop clients saturates the one
        replica (router occupancy 1 at serve.fleet.max_in_flight 8): the
        brownout level climbs to >= L1 (default-tier requests served at
        bf16) and the autoscaler scales up; the burst runs until the new
        replica is ready (its spawn-to-ready seconds), and
        FLEET_AFTER_SCALE_S past it;
      - calm: the level walks back to L0 and the autoscaler retires one
        replica (counted as retired, not as an eviction);
      - SIGTERM: exit 0, no replica process running after the
        supervisor's exit; each replica's final record: its correlation
        and warp launches add up to its dispatches, the bf16 tier's
        dispatches ran the float32 correlation kernel (the tier computes
        in float32 with rounded weights) and no bf16 kernel;
      - every flow of the burst within HTTP_TOL of `engine.submit` in
        this process on the same weights, at the tier and the bucket its
        reply names (f32 or bf16; the bucket or, from L2, the smaller),
        computed while the level walks back and the pool scales down.
    `proc`: its fleet as `spawn_autoscale` started it (main starts it
    when serve_fleet's fleet has drained, so its first replica boots
    beside untimed work: the row's `spawned_before_phase_s` says for how
    long)."""
    import base64

    import numpy as np

    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.predict import restore_params
    from deepof_tpu_torch.serve.engine import InferenceEngine

    t0 = time.monotonic()
    h, w = SERVE_HW
    rs = np.random.RandomState(60)
    pairs = [(rs.randint(0, 256, (h, w, 3), dtype=np.uint8),
              rs.randint(0, 256, (h, w, 3), dtype=np.uint8))
             for _ in range(4)]
    bodies = [{"prev": b64_png(a), "next": b64_png(b)} for a, b in pairs]
    fleet_dir = os.path.join(work, "serve_autoscale")
    spawned_before_phase_s = t0 - proc.started_at
    proc, line, address = await_serving(proc)
    pids: list = []
    stop = threading.Event()
    replies: list = []  # (the body's index, the reply)
    polls: list = []  # /healthz during the burst
    try:
        first = healthz(address)
        pids = [r["pid"] for r in first["replicas"]]

        def client(k: int) -> None:
            i = k
            while not stop.is_set():
                try:
                    r = http_call(address, "POST", "/v1/flow",
                                  bodies[i % len(bodies)])
                except Exception as e:  # noqa: BLE001 - a drop fails
                    r = (-1, None, f"{type(e).__name__}: {e}", 0.0)
                replies.append((i % len(bodies), r))
                i += FLEET_THREADS

        burst_t0 = time.monotonic()
        clients = [threading.Thread(target=client, args=(k,), daemon=True)
                   for k in range(FLEET_THREADS)]
        for c in clients:
            c.start()
        try:
            scaled = wait_health(address, lambda s: s.get("fleet_ready") == 2,
                                 "scale-up ready", timeout_s=300.0,
                                 seen=polls)
            time.sleep(FLEET_AFTER_SCALE_S)  # the new replica serves too
        finally:
            stop.set()
            for c in clients:
                c.join(timeout=120)
        burst_s = time.monotonic() - burst_t0
        pids += [r["pid"] for r in scaled["replicas"]]
        new = next(r for r in scaled["replicas"] if r["replica"] == 1)
        # the in-process reference, one a (pair, tier, bucket) the
        # burst's replies name, on the replicas' weights and
        # configuration, while the pool calms
        with open(os.path.join(fleet_dir, "replica-0",
                               "config.json")) as f:
            rcfg = config_from_dict(json.load(f))
        keys = sorted({(k, r[2]["precision"], tuple(r[2]["bucket"]))
                       for k, r in replies if r[0] == 200})
        with spanned("serve_autoscale reference"), InferenceEngine(
                rcfg, model=restore_params(rcfg, device=device),
                device=device) as eng:
            futs = {key: eng.submit(*pairs[key[0]], precision=key[1],
                                    degrade_level=0 if key[2] == (h, w)
                                    else 2)
                    for key in keys}
            want = {key: f.result(timeout=600) for key, f in futs.items()}
        calm = wait_health(
            address, lambda s: s.get("degrade_level") == 0
            and s.get("fleet_retired") == 1, "L0 and one replica retired",
            timeout_s=120.0)
    finally:
        stop.set()
        rc, drain_s, left = stop_serving(proc, pids)
    records = read_records(fleet_dir)
    events = [(r.get("event"), r.get("reason")) for r in records
              if r.get("event")]
    summary = [r for r in records if r.get("kind") == "serve"
               and "fleet_replicas" in r][-1]
    recs = {i: r[-1] for i, r in replica_records(fleet_dir).items()}

    def label(reply) -> str:
        return (f"{reply['precision']} "
                f"{reply['bucket'][0]}x{reply['bucket'][1]}")

    def rel(k: int, reply) -> float:
        ref = want[(k, reply["precision"], tuple(reply["bucket"]))]
        if list(ref["bucket"]) != reply["bucket"]:
            return math.inf
        got = np.frombuffer(base64.b64decode(reply["flow_b64"]),
                            "<f4").reshape(reply["shape"])
        return float(np.abs(got - ref["flow"]).max()
                     / max(np.abs(ref["flow"]).max(), 1e-30))

    diffs: dict = {}
    for k, r in replies:
        if r[0] == 200:
            diffs[label(r[2])] = max(diffs.get(label(r[2]), 0.0),
                                     rel(k, r[2]))
    replies = [r for _, r in replies]
    row = {"burst_requests": len(replies), "burst_s": burst_s,
           "burst_statuses": dict(collections.Counter(r[0]
                                                      for r in replies)),
           "burst_client": p50_p99([r[3] for r in replies if r[0] == 200]),
           "max_rel_diff_vs_submit": diffs,
           "burst_by_tier_and_bucket": dict(collections.Counter(
               label(r[2]) for r in replies if r[0] == 200)),
           "levels_seen": sorted({p.get("degrade_level", 0)
                                  for p in polls}),
           "max_level": max(p.get("degrade_level", 0) for p in polls),
           "scale_up_ready_s": new["ready_s"],
           "first_replica_ready_s": first["replicas"][0]["ready_s"],
           "spawned_before_phase_s": spawned_before_phase_s,
           "events": events, "rc": rc, "drain_s": drain_s,
           "replicas_left": left,
           "calm": {k: calm.get(k) for k in (
               "degrade_level", "fleet_retired", "fleet_replicas",
               "fleet_evictions")},
           **{k: summary.get(k) for k in (
               "fleet_autoscale_up", "fleet_autoscale_down",
               "fleet_autoscale_blocked_max", "fleet_retired",
               "fleet_evictions", "degrade_escalations",
               "degrade_recoveries", "degrade_transitions")},
           "replicas": {i: {k: r.get(k) for k in (
               "kernel_launches", "serve_batches", "serve_responses",
               "serve_responses_by_tier", "degrade_tier_downgrades",
               "degrade_bucket_downgrades")} for i, r in recs.items()},
           "seconds": time.monotonic() - t0,
           "seconds_from_spawn": time.monotonic() - proc.started_at}
    emit("serve_autoscale", **row)
    bf16 = sum(r["serve_responses_by_tier"].get("bf16", 0)
               for r in recs.values())
    checks = {
        "burst": all(r[0] > 0 for r in replies)
        and row["burst_statuses"].get(200, 0) >= 0.99 * len(replies)
        and max(diffs.values(), default=math.inf) <= HTTP_TOL,
        "scale_up": any(e == "scale_up" for e, _ in events),
        "brownout": row["max_level"] >= 1 and bf16 > 0
        and sum(r["degrade_tier_downgrades"] for r in recs.values()) > 0,
        "recovery": calm["degrade_level"] == 0
        and any(e == "degrade_recover" for e, _ in events),
        "retired": summary["fleet_retired"] == 1
        and summary["fleet_evictions"] == 0
        and any(e == "scale_down" for e, _ in events),
        "launches": sorted(recs) == [0, 1]
        and all(launches_match_dispatches(r)
                and r["kernel_launches"]["corr"] > 0
                for r in recs.values()),
        "drain": rc == 0 and drain_s <= 10.0 and not left}
    if not all(checks.values()):
        raise AssertionError(f"serve_autoscale: {checks}")
    return row


def corr_counters() -> list:
    """The launch counters of the correlation kernels: the forward and the
    two backward kernels, float32 and bf16."""
    from deepof_tpu_torch.ops.cuda import corr as cc

    return [cc.launches, cc.bwd_f1_launches, cc.bwd_f2_launches,
            cc.bf16_launches, cc.bwd_f1_bf16_launches,
            cc.bwd_f2_bf16_launches]


def kernel_counts() -> dict[str, int]:
    """The launch counts of the correlation kernels (forward and the two
    backward kernels, float32 and bf16) and of the two warp kernels
    (`warp_counters`)."""
    return {c.name: c.count for c in (*corr_counters(), *warp_counters())}


def want_counts(**counts) -> dict[str, int]:
    """`kernel_counts()`'s keys, 0 but where `counts` says."""
    want = dict.fromkeys(kernel_counts(), 0)
    want.update(counts)
    return want


def reset_kernel_counts() -> None:
    for c in corr_counters():
        c.reset()
    reset_warp_counts()


def swapped_corr_loss_and_grads(model, batch, mean, loss_cfg, compute_dtype,
                                kernel_backward: bool):
    """`loss_and_grads` with FlowNet-C's correlation forward swapped for
    `correlation_reference` for this one call, and its backward for the
    kernels (`correlation_bwd_cuda`, `kernel_backward`) or for
    `correlation_backward_reference`, as `serve` swaps the forward: no
    setting of the package routes a card tensor around the kernels.
    FlowNet-CS's base stage is a FlowNetC, so the swap covers it too."""
    import torch

    from deepof_tpu_torch.models import flownet_c
    from deepof_tpu_torch.ops.corr import (correlation_backward_reference,
                                           correlation_reference)
    from deepof_tpu_torch.ops.cuda.corr import correlation_bwd_cuda

    backward = (correlation_bwd_cuda if kernel_backward
                else correlation_backward_reference)

    class SwappedCorrelation(torch.autograd.Function):
        @staticmethod
        def forward(ctx, f1, f2, max_disp, stride):
            ctx.geometry = (max_disp, stride)
            ctx.save_for_backward(f1, f2)
            return correlation_reference(f1, f2, max_disp, stride)

        @staticmethod
        def backward(ctx, g):
            f1, f2 = ctx.saved_tensors
            return (*backward(f1, f2, g.contiguous(), *ctx.geometry),
                    None, None)

    kernel_corr = flownet_c.correlation_nchw
    flownet_c.correlation_nchw = (
        lambda f1, f2, max_disp, stride: SwappedCorrelation.apply(
            f1, f2, max_disp, stride))
    try:
        return loss_and_grads(model, batch, mean, loss_cfg, compute_dtype)
    finally:
        flownet_c.correlation_nchw = kernel_corr


def plain_corr_comparison(trainer, batch) -> dict:
    """One forward and backward of `trainer`'s model on `batch` (on the
    card), in the trainer's compute dtype, cuDNN deterministic, four
    ways: with the correlation kernels (`kernel`), with the plain forward
    and the backward kernels (`plain_fwd`), and twice with the plain
    forward and backward (`plain`, `plain_again`). `kernel` vs `plain`
    is the check; `kernel` vs `plain_fwd` differs only in the forward
    kernel and `plain_fwd` vs `plain` only in the backward kernels, so
    the two say which side carries a gap (the kernels compute the plain
    versions' bits, so none should); `plain_again` vs `plain`
    (`plain_repeat`) is the spread of the step itself. For each pair:
    the loss's and the gradient norm's relative differences, and the
    largest difference of one parameter's gradient over that tensor's
    largest entry, with its name. Raises if a swapped step launched a
    correlation kernel that it swapped out, or the kernel step launched
    one of the other dtype."""
    import torch

    from deepof_tpu_torch.train.step import compute_dtype

    dtype = compute_dtype(trainer.cfg)
    args = (trainer.model, batch, trainer.dataset.mean, trainer.cfg.loss,
            dtype)
    names = [n for n, _ in trainer.model.named_parameters()]
    suffix = DTYPES[trainer.cfg.train.compute_dtype]
    keys = [k + suffix for k in CORR_KERNELS]
    others = [c.name for c in corr_counters() if c.name not in keys]
    runs, launched = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, step in (
                ("kernel", loss_and_grads),
                ("plain_fwd", lambda *a: swapped_corr_loss_and_grads(
                    *a, kernel_backward=True)),
                ("plain", lambda *a: swapped_corr_loss_and_grads(
                    *a, kernel_backward=False)),
                ("plain_again", lambda *a: swapped_corr_loss_and_grads(
                    *a, kernel_backward=False))):
            before = kernel_counts()
            runs[name] = step(*args)
            after = kernel_counts()
            launched[name] = [after[k] - before[k] for k in keys]
            if any(after[k] != before[k] for k in others):
                raise AssertionError(f"{name} step ({dtype}) launched a "
                                     f"correlation kernel of another dtype: "
                                     f"{before} -> {after}")
    finally:
        torch.backends.cudnn.deterministic = False
    if (0 in launched["kernel"] or launched["plain"] != [0, 0, 0]
            or launched["plain_again"] != [0, 0, 0]
            or launched["plain_fwd"] != [0, *launched["kernel"][1:]]):
        raise AssertionError(f"corr kernel launches {launched} in the "
                             f"kernel, plain-forward and plain steps")

    def norm(grads):
        return float(torch.sqrt(sum(g.square().sum() for g in grads)))

    def compare(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        rel = [((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
               .item() for x, y in zip(ga, gb)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        return {"loss_rel": abs(la - lb) / abs(lb),
                "grad_norm_rel": abs(norm(ga) - norm(gb)) / norm(gb),
                "grad_max_rel": rel[worst], "grad_max_rel_at": names[worst]}

    loss, grads = runs["kernel"]
    return {"loss": loss, "grad_norm": norm(grads),
            "kernel_vs_plain_corr": compare("kernel", "plain"),
            "fwd_kernel_only": compare("kernel", "plain_fwd"),
            "bwd_kernels_only": compare("plain_fwd", "plain"),
            "plain_repeat": compare("plain_again", "plain")}


def plain_corr_spread(model: str = "flownet_cs", batches: int = 8) -> dict:
    """`plain_corr_comparison` on `batches` batches of a fresh full-width
    trainer, batch by batch. On demand, on the card:

        python3 -c "import chip_smoke as cs; cs.plain_corr_spread()"
    """
    import torch

    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)
    from deepof_tpu_torch.train.loop import Trainer
    from deepof_tpu_torch.train.step import batch_to_device

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory(dir=work_root()) as log_dir:
        trainer = Trainer(ExperimentConfig(
            model=model, data=DataConfig(dataset="synthetic"),
            train=TrainConfig(log_dir=log_dir)), device="cuda")
        rows = [plain_corr_comparison(trainer,
                                      batch_to_device(b, trainer.device))
                for b, _ in draw_batches(trainer, batches)]
    emit("plain_corr_spread", model=model, batches=rows)
    return {"model": model, "batches": rows}


# steps timed on a card-resident batch (then as many again under the
# profiler) by the FlowNet-C and FlowNet-CS training phases, after one
# warm-up step; their warp launches a step (the loss, and FlowNet-CS's
# refinement input)
CORR_TRAIN_STEPS = 3
CORR_MODEL_WARPS = {"flownet_c": 1, "flownet_cs": 2}


def corr_trainer(model: str, work: str, compute_dtype: str = "float32"):
    """A full-width Trainer on the card (384x512, batch 4, paper
    geometry, synthetic data) in `compute_dtype`, after one warm-up step
    (cuDNN algorithm choice, allocator): (trainer, that step's metrics)."""
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)
    from deepof_tpu_torch.train.loop import Trainer

    cfg = ExperimentConfig(
        model=model, data=DataConfig(dataset="synthetic"),
        train=TrainConfig(log_dir=os.path.join(
            work, f"train_{model}{DTYPES[compute_dtype]}"),
            compute_dtype=compute_dtype))
    trainer = Trainer(cfg, device="cuda")
    return trainer, steps_in_sequence(trainer, 1)[0]


def step_figures(trainer) -> dict:
    """CORR_TRAIN_STEPS steps on card-resident batches timed on the host
    clock and as many under torch.profiler (`profile_steps`): step ms,
    pairs/s, device busy and idle share, the correlation kernels' and the
    warps' device ms a step and the correlation kernels' share of busy,
    each kernel's launches a step (counted from 0 here), device kernels a
    step and the top 10 device kernels."""
    reset_kernel_counts()
    step_ms, prof = profile_steps(trainer, CORR_TRAIN_STEPS)
    counts = kernel_counts()
    kernels = device_kernels(prof, CORR_TRAIN_STEPS)
    busy = sum(t for t, _ in kernels)
    by_kernel = {name: sum(t for t, k in kernels if key in k)
                 for name, key in (("corr", "corr_fwd"),
                                   ("corr_bwd_f1", "corr_bwd_f1"),
                                   ("corr_bwd_f2", "corr_bwd_f2"),
                                   ("warp", "warp_"))}
    batch = trainer.cfg.data.batch_size
    return {"steps": CORR_TRAIN_STEPS, "step_ms": step_ms,
            "pairs_per_s": batch / (step_ms / 1e3),
            "device_time_visible": busy > 0, "device_busy_ms": busy,
            "idle_share_of_step": (1 - busy / step_ms) if busy else None,
            "kernel_ms_per_step": by_kernel,
            "corr_share_of_busy": (sum(v for k, v in by_kernel.items()
                                       if k != "warp") / busy)
            if busy else None,
            "launches_per_step": {k: v / (2 * CORR_TRAIN_STEPS)
                                  for k, v in counts.items()},
            "launches": counts,
            **kernels_per_step(device_kernel_counts(prof), CORR_TRAIN_STEPS),
            "top": [{"ms": t, "name": k[:90]} for t, k in kernels[:10]]}


def cost_volume_dtype(trainer, batch) -> str:
    """The dtype of the cost volume of one forward of `trainer`'s model on
    `batch`, its pair cast as the train step casts it (no gradient)."""
    import torch

    from deepof_tpu_torch.models import flownet_c
    from deepof_tpu_torch.train.step import compute_dtype, model_losses

    seen = []
    kernel_corr = flownet_c.correlation_nchw

    def recorded(*args):
        out = kernel_corr(*args)
        seen.append(str(out.dtype))
        return out

    flownet_c.correlation_nchw = recorded
    try:
        with torch.no_grad():
            model_losses(trainer.model, batch, trainer.dataset.mean,
                         trainer.cfg.loss,
                         compute_dtype=compute_dtype(trainer.cfg))
    finally:
        flownet_c.correlation_nchw = kernel_corr
    if len(set(seen)) != 1:
        raise AssertionError(f"cost volumes of one forward: {seen}")
    return seen[0].replace("torch.", "")


def train_corr_model(model: str, work: str,
                     compute_dtype: str = "float32") -> dict:
    """Full-width FlowNet-C or FlowNet-CS training on the card (384x512,
    batch 4, paper geometry) in `compute_dtype` (`train.compute_dtype`):
    one warm-up step, then `step_figures` (corr, corr_bwd_f1 and
    corr_bwd_f2 of the dtype once a step and those of the other dtype
    never; the warps once for FlowNet-C, twice for FlowNet-CS). Then one
    step against the plain correlation, forward and backward, on the
    same weights and batch, split into the forward's and the backward's
    share, with the plain step's own spread (`plain_corr_comparison`).
    In bfloat16 also: the cost volume's dtype, a float32 trainer of the
    same seed measured by `step_figures` in the same phase (`f32`), and
    the two warm-up steps' losses, from the same weights and batch."""
    import numpy as np

    from deepof_tpu_torch.train.step import batch_to_device

    trainer, first = corr_trainer(model, work, compute_dtype)
    fig = step_figures(trainer)
    batch = batch_to_device(next(draw_batches(trainer, 1))[0],
                            trainer.device)
    vs_plain = plain_corr_comparison(trainer, batch)
    phase = f"train_{model}{DTYPES[compute_dtype]}"
    row = {"model": model, "compute_dtype": compute_dtype,
           "image_size": list(trainer.cfg.data.image_size),
           "batch": trainer.cfg.data.batch_size,
           "corr_geometry": [trainer.model.max_disp,
                             trainer.model.corr_stride],
           "params": sum(p.numel() for p in trainer.model.parameters()),
           "param_dtypes": sorted({str(p.dtype) for p in
                                   trainer.model.parameters()}),
           **fig, **vs_plain}
    if compute_dtype != "float32":
        row["cost_volume_dtype"] = cost_volume_dtype(trainer, batch)
        del trainer, batch
        f32, f32_first = corr_trainer(model, work)
        row["f32"] = step_figures(f32)
        del f32
        row["first_step_loss"] = first["total"]
        row["first_step_loss_f32"] = f32_first["total"]
        row["first_step_loss_rel_to_f32"] = (
            abs(first["total"] - f32_first["total"])
            / abs(f32_first["total"]))
    emit(phase, **row)
    if not (np.isfinite(row["loss"]) and np.isfinite(row["grad_norm"])):
        raise AssertionError(f"{phase}: non-finite loss {row['loss']} or "
                             f"gradient norm {row['grad_norm']}")
    warps = CORR_MODEL_WARPS[model]
    want = want_counts(warp_fwd=warps, warp_flow_grad=warps,
                       **{k + DTYPES[compute_dtype]: 1
                          for k in CORR_KERNELS})
    if fig["launches_per_step"] != want:
        raise AssertionError(f"{phase}: kernel launches a step "
                             f"{fig['launches_per_step']}; want {want}")
    if row["param_dtypes"] != ["torch.float32"] or row.get(
            "cost_volume_dtype", compute_dtype) != compute_dtype:
        raise AssertionError(f"{phase}: parameters {row['param_dtypes']}, "
                             f"cost volume {row.get('cost_volume_dtype')}")
    # the kernels compute the plain versions' bits, so the loss is equal
    # and each gradient differs only by the step's other reductions
    # (cuDNN and atomics): the gate of each pair, the forward's and the
    # backward's share as much as the whole. Two plain steps must meet
    # the same gate, or the gate would measure the step and not the
    # kernels
    spread = vs_plain["plain_repeat"]
    for pair in ("kernel_vs_plain_corr", "fwd_kernel_only",
                 "bwd_kernels_only", "plain_repeat"):
        gap = vs_plain[pair]
        if not (gap["loss_rel"] == 0
                and gap["grad_max_rel"] <= TRAIN_GRAD_RTOL):
            raise AssertionError(
                f"{phase}: train step, {pair}: {gap} (limits: loss equal, "
                f"each gradient {TRAIN_GRAD_RTOL} of its largest entry; "
                f"two plain steps: {spread})")
    if fig["device_busy_ms"] <= 0:
        raise AssertionError(f"{phase}: torch.profiler recorded no device "
                             "time")
    return row


REPEAT_STEPS = 3


def repeat_flownet_cs(work: str) -> dict:
    """F15: REPEAT_STEPS plain FlowNet-CS steps (forward and backward, no
    update, one batch, the same weights), full width, under cuDNN
    deterministic, each against the first: the loss, and each gradient
    bit for bit (the parameters whose gradients differ, with the largest
    difference). First with the x2 flow upsample as `F.interpolate` (the
    port before F15's fix), then with `models/flownet2.py::upsample_flow`.
    Then the ops that `torch.use_deterministic_algorithms(True,
    warn_only=True)` warns about in one step of each (that mode also
    swaps some ops for deterministic versions, so it names ops; the
    repeat without it is the check)."""
    import warnings

    import torch
    import torch.nn.functional as F

    from deepof_tpu_torch.models import flownet2
    from deepof_tpu_torch.train.step import batch_to_device

    trainer, _ = corr_trainer("flownet_cs", work)
    batch = batch_to_device(next(draw_batches(trainer, 1))[0],
                            trainer.device)
    args = (trainer.model, batch, trainer.dataset.mean, trainer.cfg.loss)
    names = [n for n, _ in trainer.model.named_parameters()]

    def interpolate_upsample(flow, hw):
        return F.interpolate(flow, size=hw, mode="bilinear",
                             align_corners=False) * 2.0

    def repeat():
        (l0, g0), *rest = [loss_and_grads(*args)
                           for _ in range(REPEAT_STEPS)]
        diff = {}
        for _, gs in rest:
            for n, a, b in zip(names, g0, gs):
                d = (a - b).abs().max().item()
                if d > 0:
                    diff[n] = max(d, diff.get(n, 0.0))
        return {"steps": REPEAT_STEPS,
                "loss_equal": all(lk == l0 for lk, _ in rest),
                "grads_bitwise_equal": not diff,
                "grads_differing": len(diff),
                "largest_diffs": dict(sorted(diff.items(),
                                             key=lambda kv: -kv[1])[:5])}

    def warned():
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                loss_and_grads(*args)
            finally:
                torch.use_deterministic_algorithms(False)
        return sorted({str(w.message)[:200] for w in caught
                       if "determinis" in str(w.message)})

    fixed = flownet2.upsample_flow
    row = {}
    torch.backends.cudnn.deterministic = True
    try:
        for key, fn in (("interpolate_upsample", interpolate_upsample),
                        ("fixed_weight_upsample", fixed)):
            flownet2.upsample_flow = fn
            row[key] = {**repeat(), "deterministic_mode_warns": warned()}
    finally:
        flownet2.upsample_flow = fixed
        torch.backends.cudnn.deterministic = False
    del trainer
    emit("repeat_flownet_cs", **row)
    got = row["fixed_weight_upsample"]
    if not (got["loss_equal"] and got["grads_bitwise_equal"]):
        raise AssertionError(f"repeat_flownet_cs: FlowNet-CS steps are not "
                             f"bitwise repeatable: {row}")
    return row


def repeat_learning_flownet_c(steps: int = 20) -> dict:
    """F26, on demand (not in `main`): the FlowNet-C learning test's model
    and config (`tests/test_torch_learning.py`: width 0.25, max_disp 3,
    stride 1, 64x64, batch 8, blobs at 8 px), `steps` of its training
    first, then REPEAT_STEPS forward-and-backward passes on one batch at
    the same weights, each gradient against the first's bit for bit,
    under three settings: PyTorch's defaults, cuDNN deterministic, and
    `torch.use_deterministic_algorithms(True)` with cuDNN deterministic.
    Names the parameters whose gradients differ in backward order (the
    first is the layer nearest the loss whose backward varies) and the
    module class that owns each."""
    import numpy as np
    import torch

    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              LossConfig, OptimConfig,
                                              TrainConfig)
    from deepof_tpu_torch.core.device import disable_tf32
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.state import create_train_state
    from deepof_tpu_torch.train.step import batch_to_device, make_train_step

    disable_tf32()
    cfg = ExperimentConfig(
        model="flownet_c", width_mult=0.25, corr_max_disp=3, corr_stride=1,
        loss=LossConfig(weights=(16, 8, 4, 2, 1, 1)),
        optim=OptimConfig(learning_rate=1e-4, epochs_per_decay=2),
        data=DataConfig(dataset="synthetic", image_size=(64, 64),
                        gt_size=(64, 64), batch_size=8),
        train=TrainConfig(seed=0, log_dir=os.path.join(work_root(), "f26")))
    ds = SyntheticData(cfg.data, num_train=512, max_shift=8.0,
                       style="blobs", n_blobs=40)
    model = build_model("flownet_c", width_mult=0.25, corr_max_disp=3,
                        corr_stride=1, device="cuda")
    state = create_train_state(model, cfg.optim, lambda s: 3e-4)
    step = make_train_step(model, cfg, ds.mean)
    rng = np.random.RandomState(0)
    for _ in range(steps):
        step(state, ds.sample_train(8, rng=rng))
    batch = batch_to_device(ds.sample_train(8, rng=rng), torch.device("cuda"))
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = type(mod).__name__
    names = [n for n, _ in model.named_parameters()]

    def repeat() -> dict:
        (l0, g0), *rest = [loss_and_grads(model, batch, ds.mean, cfg.loss)
                           for _ in range(REPEAT_STEPS)]
        diff = {}
        for _, gs in rest:
            for n, a, b in zip(names, g0, gs):
                d = (a - b).abs().max().item()
                if d > 0:
                    diff[n] = max(d, diff.get(n, 0.0))
        backward_order = [n for n in reversed(names) if n in diff]
        return {"loss_equal": all(lk == l0 for lk, _ in rest),
                "grads_bitwise_equal": not diff,
                "grads_differing": len(diff), "of": len(names),
                "first_in_backward_order": (
                    {"param": backward_order[0],
                     "module": owner[backward_order[0]],
                     "max_abs_diff": diff[backward_order[0]]}
                    if backward_order else None),
                "modules_differing": sorted({owner[n] for n in diff}),
                "largest_diffs": dict(sorted(diff.items(),
                                             key=lambda kv: -kv[1])[:5])}

    row = {"steps_before": steps, "repeats": REPEAT_STEPS}
    settings = (("defaults", False, False), ("cudnn_deterministic", True,
                                             False),
                ("deterministic_algorithms", True, True))
    prev = (torch.backends.cudnn.deterministic,
            torch.are_deterministic_algorithms_enabled())
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        for key, cudnn_det, algos in settings:
            torch.backends.cudnn.deterministic = cudnn_det
            torch.use_deterministic_algorithms(algos)
            try:
                row[key] = repeat()
            except RuntimeError as e:  # an op with no deterministic kernel
                row[key] = {"error": str(e)[:300]}
    finally:
        torch.backends.cudnn.deterministic = prev[0]
        torch.use_deterministic_algorithms(prev[1])
    emit("repeat_learning_flownet_c", **row)
    return row


# `train --model flownet_c --synthetic` at full width: 384x512, batch 4,
# a train record every 2 steps, an eval and a checkpoint at step 8
CLI_TRAIN_C = ["--model", "flownet_c", "--synthetic",
               "--set", "data.image_size=[384,512]",
               "--set", "data.gt_size=[384,512]",
               "--set", "data.batch_size=4",
               "--set", "train.eval_batch_size=4",
               "--set", "train.log_every=2", "--set", "train.eval_every=8",
               "--set", "train.ckpt_every_steps=8"]
CLI_C_STEPS = 8


def cli_train_flownet_c(work: str) -> dict:
    """FlowNet-C from the command line at full width: `train` for
    CLI_C_STEPS steps (an eval and a checkpoint at the last), then `eval`
    and `predict` from its checkpoint. Each path's kernel launches are
    counted from 0: in `train`, corr once per step and per eval forward,
    each backward kernel once per step; in `eval`, corr once per eval
    forward; in `predict`, once per dispatch. Finite loss, AEE and AAE,
    and two native-size .flo files."""
    import numpy as np

    from deepof_tpu_torch.io.flo import read_flo

    log_dir = os.path.join(work, "cli_train_flownet_c")
    reset_kernel_counts()
    summary = run_cli(["train", *CLI_TRAIN_C, "--steps", str(CLI_C_STEPS),
                       "--log-dir", log_dir],
                      os.path.join(work, "cli_train_flownet_c.log"))
    train = kernel_counts()
    records = check_run(log_dir, list(range(2, CLI_C_STEPS + 1, 2)),
                        [CLI_C_STEPS], [CLI_C_STEPS])
    evals = eval_calls(SYNTHETIC_VAL, 4)
    reset_kernel_counts()
    ev = run_cli(["eval", *CLI_TRAIN_C, "--log-dir", log_dir],
                 os.path.join(work, "cli_eval_flownet_c.log"))
    evaluate = kernel_counts()
    rs = np.random.RandomState(2)
    pairs = []
    for i in range(2):
        paths = [os.path.join(work, f"c_pair{i}_{k}.npy") for k in "ab"]
        for p in paths:
            np.save(p, rs.randint(0, 256, (384, 512, 3), np.uint8))
        pairs.append(":".join(paths))
    reset_kernel_counts()
    out = run_cli(["predict", *CLI_TRAIN_C, "--log-dir", log_dir, "--out",
                   os.path.join(work, "flows_c"), "--pairs", *pairs],
                  os.path.join(work, "cli_predict_flownet_c.log"))
    predict = kernel_counts()
    flows = [read_flo(p) for p in out["written"] if p.endswith(".flo")]
    row = {"steps": CLI_C_STEPS, **fit_row(summary, 4),
           "launches": {"train": train, "eval": evaluate,
                        "predict": predict},
           "eval_forwards": evals,
           "losses": [r["loss"] for r in records if r["kind"] == "train"],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"],
           "eval_cli": {k: ev[k] for k in ("aee", "aae", "val_loss")},
           "predicted": [list(f.shape) for f in flows]}
    emit("cli_train_flownet_c", **row)
    want_train = want_counts(corr=CLI_C_STEPS + evals,
                             corr_bwd_f1=CLI_C_STEPS,
                             corr_bwd_f2=CLI_C_STEPS,
                             warp_fwd=CLI_C_STEPS + evals,
                             warp_flow_grad=CLI_C_STEPS)
    if train != want_train:
        raise AssertionError(f"cli train flownet_c: launches {train}; want "
                             f"{want_train}")
    if (evaluate != want_counts(corr=evals, warp_fwd=evals)
            or not 1 <= predict["corr"] <= len(pairs)
            or predict != want_counts(corr=predict["corr"])):
        raise AssertionError(f"cli eval/predict flownet_c: launches "
                             f"{evaluate} / {predict}")
    if not all(np.isfinite(ev[k]) for k in ("aee", "aae", "val_loss")):
        raise AssertionError(f"eval flownet_c: non-finite metrics {ev}")
    if [f.shape for f in flows] != [(384, 512, 2)] * 2 or not all(
            np.isfinite(f).all() for f in flows):
        raise AssertionError(f"predict flownet_c wrote "
                             f"{[f.shape for f in flows]}")
    return row


def ledger_gate(work: str, serve_row: dict) -> dict:
    """The executable ledger's gate across models: `tail --ledger-baseline`
    of the resumed FlowNet-S run (`cli_train`, `cli_resume`) against the
    FlowNet-C run's ledger (`cli_train_flownet_c`): rc 8, with the
    `train_step` in its fingerprint drift, and the `ledger_drift` bundle
    it keeps. Beside it, the full-width rows of FlowNet-C's train step
    and of its serving forward (`serve_http`'s f32 cold row): FLOPs,
    temp bytes and first-call seconds. Adds `tail` calls only."""
    from deepof_tpu_torch.obs import incident

    run = os.path.join(work, "cli_train")
    base = os.path.join(work, "cli_train_flownet_c")
    rc, line = run_verb(["tail", "--log-dir", run, "--ledger-baseline", base],
                        os.path.join(work, "ledger_gate_tail.log"))
    diff = line.get("ledger_diff") or {}
    drift = [e["name"] for e in diff.get("fingerprint_drift") or []]
    train_c = ledger_rows(base)["train_step"]
    serve_c = serve_row["ledger"]["serve:384x512:f32:cold"]
    row = {"rc": rc, "fingerprint_drift": drift,
           "compared": diff.get("compared"),
           "bundles": [b["kind"] for b in incident.list_incidents(run)],
           "flownet_c_train_step": {k: train_c[k] for k in (
               "flops", "temp_bytes", "compile_s", "argument_bytes",
               "bytes_accessed", "fingerprint")},
           "flownet_c_trace_s": first_step_trace_s(base),
           "flownet_c_serve_f32_cold": {k: serve_c[k] for k in (
               "flops", "temp_bytes", "compile_s", "argument_bytes",
               "bytes_accessed", "fingerprint")}}
    emit("ledger_gate", **row)
    if (rc != 8 or "train_step" not in drift
            or row["bundles"] != ["ledger_drift"]):
        raise AssertionError(f"ledger_gate: {row}")
    return row


# `train --model flownet_c --set train.compute_dtype=bfloat16` at full
# width: CLI_TRAIN_C with an eval and a checkpoint at step CLI_C_BF16_STEPS
CLI_C_BF16_STEPS = 4
CLI_TRAIN_C_BF16 = [*CLI_TRAIN_C, "--set", "train.compute_dtype=bfloat16",
                    "--set", f"train.eval_every={CLI_C_BF16_STEPS}",
                    "--set", f"train.ckpt_every_steps={CLI_C_BF16_STEPS}"]


def cli_train_flownet_c_bf16(work: str) -> dict:
    """FlowNet-C from the command line at full width in bf16 compute:
    `train` for CLI_C_BF16_STEPS steps (an eval and a checkpoint at the
    last), then `eval` on the run. Each path's kernel launches are
    counted from 0: in `train`, corr_bf16 once per step and per eval
    forward, each bf16 backward kernel once per step; in `eval`,
    corr_bf16 once per eval forward; the float32 correlation kernels
    never (the warps stay float32). Finite losses and eval metrics, and a
    checkpoint of float32 tensors only (parameters and Adam's moments)."""
    import numpy as np

    from deepof_tpu_torch.train.checkpoint import CheckpointManager

    log_dir = os.path.join(work, "cli_train_flownet_c_bf16")
    steps = CLI_C_BF16_STEPS
    reset_kernel_counts()
    summary = run_cli(["train", *CLI_TRAIN_C_BF16, "--steps", str(steps),
                       "--log-dir", log_dir],
                      os.path.join(work, "cli_train_flownet_c_bf16.log"))
    train = kernel_counts()
    records = check_run(log_dir, list(range(2, steps + 1, 2)), [steps],
                        [steps])
    ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"), create=False)
    optim = ckpt.restore_raw(subtree="optimizer")
    tensors = list(ckpt.restore_raw(subtree="model").values()) + [
        t for st in optim["state"].values() for t in st.values()
        if t.is_floating_point()]
    ckpt_dtypes = sorted({str(t.dtype) for t in tensors})
    evals = eval_calls(SYNTHETIC_VAL, 4)
    reset_kernel_counts()
    ev = run_cli(["eval", *CLI_TRAIN_C_BF16, "--log-dir", log_dir],
                 os.path.join(work, "cli_eval_flownet_c_bf16.log"))
    evaluate = kernel_counts()
    row = {"steps": steps, **fit_row(summary, 4),
           "launches": {"train": train, "eval": evaluate},
           "eval_forwards": evals,
           "losses": [r["loss"] for r in records if r["kind"] == "train"],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"],
           "eval_cli": {k: ev[k] for k in ("aee", "aae", "val_loss")},
           "checkpoint_tensors": len(tensors),
           "checkpoint_dtypes": ckpt_dtypes}
    emit("cli_train_flownet_c_bf16", **row)
    want_train = want_counts(corr_bf16=steps + evals,
                             corr_bwd_f1_bf16=steps, corr_bwd_f2_bf16=steps,
                             warp_fwd=steps + evals, warp_flow_grad=steps)
    want_eval = want_counts(corr_bf16=evals, warp_fwd=evals)
    if train != want_train or evaluate != want_eval:
        raise AssertionError(f"cli flownet_c bf16: launches {train} / "
                             f"{evaluate}; want {want_train} / {want_eval}")
    if ckpt_dtypes != ["torch.float32"]:
        raise AssertionError(f"cli flownet_c bf16: checkpoint tensors of "
                             f"{ckpt_dtypes}")
    if not all(np.isfinite(ev[k]) for k in ("aee", "aae", "val_loss")):
        raise AssertionError(f"eval flownet_c bf16: non-finite metrics {ev}")
    return row


# the rest of the training loop at full width (FlowNet-C, 384x512, batch
# 4, f32): gradient accumulation 2, the span trace, a train record every
# step, evals and checkpoints at 4 and 8; run at 2 steps a call, at 1,
# and at 2 under remat (`cli_train_job`)
JOB_STEPS = 8
CLI_TRAIN_JOB = ["--model", "flownet_c", "--synthetic",
                 "--set", "data.image_size=[384,512]",
                 "--set", "data.gt_size=[384,512]",
                 "--set", "data.batch_size=4",
                 "--set", "train.eval_batch_size=4",
                 "--set", "train.log_every=1", "--set", "train.eval_every=4",
                 "--set", "train.ckpt_every_steps=4",
                 "--set", "optim.grad_accum=2", "--trace"]
JOB_RUNS = {"k2": ["--set", "train.steps_per_call=2"],
            "k1": ["--set", "train.steps_per_call=1"],
            "k2_remat": ["--set", "train.steps_per_call=2",
                         "--set", "train.remat=true"],
            "k2_depth0": ["--set", "train.steps_per_call=2",
                          "--set", "train.pipeline_depth=0"]}
# the metric fetches' depth of each run (the default is 2)
JOB_DEPTH = {"k2": 2, "k1": 2, "k2_remat": 2, "k2_depth0": 0}
# spans of the main thread (one a call: input_wait, dispatch; one a call
# due for a record, at log_every 1 every call: fetch, on the fetcher's
# thread; one an eval, one a cadence checkpoint) and of the data threads
MAIN_SPANS = ("input_wait", "dispatch", "fetch", "eval", "ckpt")
DATA_SPANS = ("put", "assemble")


def checkpoint_tensors(log_dir: str) -> dict:
    """Every tensor of the newest checkpoint under `log_dir`: the model's,
    Adam's moments and counts, and the gradient accumulator's."""
    import torch

    from deepof_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(os.path.join(log_dir, "ckpt"), create=False)
    out = {f"model.{k}": v for k, v in ckpt.restore_raw("model").items()}
    for i, st in ckpt.restore_raw("optimizer")["state"].items():
        out.update({f"adam.{i}.{k}": torch.as_tensor(v)
                    for k, v in st.items()})
    out.update({f"acc.{i}": t
                for i, t in enumerate(ckpt.restore_raw("acc") or ())})
    return out


def tensors_equal(a: dict, b: dict) -> list[str]:
    """The names whose tensors differ (or exist on one side only)."""
    import torch

    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def span_counts(log_dir: str) -> dict[str, int]:
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return dict(collections.Counter(e["name"] for e in events
                                    if e["ph"] == "X"))


def cli_train_job(work: str, extra: tuple = ()) -> dict:
    """`train --model flownet_c --set optim.grad_accum=2 --trace` at full
    width for JOB_STEPS micro-steps, under cuDNN's deterministic
    algorithms: at 2 steps a call, at 1, at 2 under remat, and at 2 with
    `train.pipeline_depth=0` (the others run at the default depth 2: the
    metrics fetched on the fetcher's thread, up to 2 calls behind the
    dispatch; at most 2 in flight, at 0 one). Each run's
    launches are counted from 0: the correlation forward once a
    micro-step (twice under remat) and once an eval forward, each
    backward kernel once a micro-step, the warp forward once a micro-step
    and an eval forward, its flow gradient once a micro-step. The K = 2
    run's records fall at the stride ends 2, 4, 6, 8; its trace has the
    loop's spans, its final heartbeat the card's memory; its records the
    model TFLOP/s and the nominal MFU. The four runs' losses at 2, 4, 6
    and 8, their evals and their final checkpoints' tensors are equal bit
    for bit. Beside them, each depth's idle share of the card in the same
    job's fit (`job_idle`) and the optimizer's device time a micro-step
    (`optimizer_ms`). `extra` is appended to every command (a CPU
    rehearsal's device and sizes)."""
    evals = 2 * eval_calls(SYNTHETIC_VAL, 4)
    t0 = time.monotonic()
    runs = {}
    with cudnn_deterministic():
        for name, flags in JOB_RUNS.items():
            log_dir = os.path.join(work, f"cli_train_job_{name}")
            reset_kernel_counts()
            summary = run_cli(["train", *CLI_TRAIN_JOB, *flags, *extra,
                               "--steps", str(JOB_STEPS), "--log-dir",
                               log_dir],
                              os.path.join(work, f"cli_train_job_{name}.log"))
            launches = kernel_counts()
            k = 1 if name == "k1" else 2
            records = check_run(log_dir, list(range(k, JOB_STEPS + 1, k)),
                                [4, JOB_STEPS], [4, JOB_STEPS])
            with open(os.path.join(log_dir, "heartbeat.json")) as f:
                hb = json.load(f)
            runs[name] = {
                "k": k, "log_dir": log_dir, "summary": summary,
                "launches": launches, "heartbeat": hb,
                "ledger": ledger_summary(ledger_rows(log_dir)),
                "spans": span_counts(log_dir),
                "losses": {r["step"]: r["loss"] for r in records
                           if r["kind"] == "train"},
                "evals": [{key: r[key] for key in ("step", "aee", "aae",
                                                   "val_loss")}
                          for r in records if r["kind"] == "eval"]}
    k2, k1, remat = runs["k2"], runs["k1"], runs["k2_remat"]
    # `tail` of the traced K = 2 run: rc 0, its heartbeat at the fit's end
    tail_rc, tail = run_verb(["tail", "--log-dir", k2["log_dir"]],
                             os.path.join(work, "cli_train_job_tail.log"))
    common = sorted(k2["losses"])
    tensors = {name: checkpoint_tensors(r["log_dir"])
               for name, r in runs.items()}
    ckpt_diff = {name: tensors_equal(tensors["k2"], tensors[name])
                 for name in ("k1", "k2_remat", "k2_depth0")}
    row = {"steps": JOB_STEPS, "grad_accum": 2, "eval_forwards": evals,
           "runs": {name: {
               "steps_per_call": r["k"],
               **fit_row(r["summary"], 4),
               "launches": r["launches"],
               "record_steps": sorted(r["losses"]),
               "losses": [r["losses"][s] for s in common],
               "heartbeat_step_time_median_s":
                   r["heartbeat"]["step_time_median_s"],
               "heartbeat_per_step_over_fit_median": (
                   r["heartbeat"]["step_time_median_s"] / r["k"]
                   / (r["summary"]["step_ms_median"] / 1e3)),
               "model_tflops": r["summary"].get("model_tflops"),
               "mfu_nominal": r["summary"].get("mfu_nominal"),
               **{k: r["summary"][k] for k in (
                   "pipeline_depth", "pipeline_max_in_flight",
                   "pipeline_fetches", "pipeline_fetch_s")},
               "ledger": r["ledger"]}
               for name, r in runs.items()},
           "spans_k2": k2["spans"],
           "heartbeat_k2": {key: k2["heartbeat"].get(key) for key in (
               "step", "beats", "step_time_median_s", "wedges",
               "dev_mem_bytes_in_use", "dev_mem_peak_bytes", "rss_bytes")},
           "seconds": time.monotonic() - t0,
           "idle_by_depth": {d: job_idle(work, d, extra)
                             for d in (2, 0)} if not extra else None,
           "optimizer": optimizer_ms() if not extra else None,
           "checkpoint_tensors": len(tensors["k2"]),
           "checkpoint_differs": ckpt_diff,
           "evals_k2": k2["evals"],
           "tail_k2": {"rc": tail_rc, "step": tail.get("step"),
                       "heartbeat_step": tail["heartbeat"]["step"],
                       "wedged": tail["heartbeat"]["wedged"],
                       "recent_steps_per_sec":
                           tail.get("recent_steps_per_sec"),
                       "phase_share": tail.get("phase_share")}}
    emit("cli_train_job", **row)
    if (tail_rc, tail.get("step"), tail["heartbeat"]["step"]) != (
            0, JOB_STEPS, k2["heartbeat"]["step"]):
        raise AssertionError(f"cli_train_job: tail {row['tail_k2']}")
    # each run's ledger: its train and eval steps' rows, libraries found
    # built; K = 2 and K = 1 are other computations, remat another again
    fps = {name: r["ledger"]["train_step"]["fingerprint"]
           for name, r in runs.items() if "train_step" in r["ledger"]}
    if (any(sorted(r["ledger"]) != ["eval_step", "train_step"]
            or not libraries_found(r["ledger"], needed=not extra)
            for r in runs.values())
            or len({fps["k2"], fps["k1"], fps["k2_remat"]}) != 3):
        raise AssertionError(f"cli_train_job: ledger rows "
                             f"{ {n: r['ledger'] for n, r in runs.items()} }")
    steps = JOB_STEPS
    for name, r in runs.items():
        corr = steps * (2 if name == "k2_remat" else 1) + evals
        want = want_counts(corr=corr, corr_bwd_f1=steps, corr_bwd_f2=steps,
                           warp_fwd=steps + evals, warp_flow_grad=steps)
        if r["launches"] != want:
            raise AssertionError(f"cli_train_job {name}: launches "
                                 f"{r['launches']}; want {want}")
    for name, r in runs.items():
        fetcher = {k: v for k, v in r["summary"].items()
                   if k.startswith("pipeline_")}
        # one fetch a call (log_every 1); at most `depth` in flight
        if (fetcher["pipeline_depth"] != JOB_DEPTH[name]
                or not 1 <= fetcher["pipeline_max_in_flight"]
                <= max(JOB_DEPTH[name], 1)
                or fetcher["pipeline_fetches"] != JOB_STEPS // r["k"]):
            raise AssertionError(f"cli_train_job {name}: fetcher {fetcher}")
    for name in ("k1", "k2_remat", "k2_depth0"):
        got = [runs[name]["losses"][s] for s in common]
        want = [k2["losses"][s] for s in common]
        if got != want or runs[name]["evals"] != k2["evals"]:
            raise AssertionError(
                f"cli_train_job: {name} losses {got} / evals "
                f"{runs[name]['evals']} are not the K = 2 run's {want} / "
                f"{k2['evals']} bit for bit")
        if ckpt_diff[name]:
            raise AssertionError(f"cli_train_job: {name}'s final checkpoint "
                                 f"differs from K = 2's in "
                                 f"{ckpt_diff[name][:10]}")
    calls = steps // 2
    want_spans = {"input_wait": calls, "dispatch": calls, "fetch": calls,
                  "eval": 2, "ckpt": 2}
    if ({s: k2["spans"].get(s) for s in MAIN_SPANS} != want_spans
            or not all(k2["spans"].get(s, 0) >= calls for s in DATA_SPANS)
            or set(k2["spans"]) != set(MAIN_SPANS + DATA_SPANS)):
        raise AssertionError(f"cli_train_job: trace spans {k2['spans']}; "
                             f"want {want_spans} and >= {calls} of "
                             f"{DATA_SPANS}")
    import torch

    hb = k2["heartbeat"]
    if (hb["step"] != steps or hb["wedges"]
            or (torch.cuda.is_available()
                and (hb["dev_mem_bytes_in_use"] is None
                     or hb["dev_mem_peak_bytes"] is None))):
        raise AssertionError(f"cli_train_job: final heartbeat {hb}")
    for name, r in runs.items():
        tf = r["summary"].get("model_tflops")
        if not (tf and tf > 0 and r["summary"].get("mfu_nominal", 0) > 0):
            raise AssertionError(f"cli_train_job {name}: no model_tflops / "
                                 f"mfu_nominal in the summary")
    return row


def job_idle(work: str, depth: int, extra: tuple = ()) -> dict:
    """The card's idle share in the training job's fit at a fetch depth:
    `cli_train_job`'s configuration at K = 2 with no eval and no cadence
    checkpoint, 14 micro-steps, calls 3 to 6 (8 micro-steps) under
    torch.profiler and the host clock (`StepWindow`)."""
    import io

    from deepof_tpu_torch import cli
    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.train.loop import Trainer

    log_dir = os.path.join(work, f"job_idle_depth{depth}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["config", *[a for a in CLI_TRAIN_JOB if a != "--trace"],
                  *JOB_RUNS["k2"], *extra,
                  "--set", f"train.pipeline_depth={depth}",
                  "--set", "train.eval_every=0",
                  "--set", "train.ckpt_every_steps=0",
                  "--log-dir", log_dir])
    cfg = config_from_dict(json.loads(out.getvalue()))
    with contextlib.redirect_stdout(io.StringIO()):
        trainer = Trainer(cfg, device="cuda")
        step = trainer.train_step
        window = StepWindow(step, 2, 6)
        trainer.train_step = window
        summary = trainer.fit(max_steps=14)
    row = window.row(cfg.data.batch_size)
    return {"depth": depth, "idle_share": row["idle_share_of_step"],
            "call_ms": row["step_ms"],
            "device_busy_ms_per_call": row["device_busy_ms_per_step"],
            "step_ms_median": summary["step_ms_median"],
            "step_call_ms_median": summary["phase_dispatch_ms_median"],
            "pipeline_max_in_flight": summary["pipeline_max_in_flight"]}


def optimizer_ms() -> dict:
    """The optimizer's time a micro-step on full-width FlowNet-C's 39.3 M
    parameters (`TrainState.apply_gradients`: the accumulator, the clip's
    absence, Adam and the device-side commit), at grad_accum 1 and 2:
    device ms (torch.profiler) and the call by CUDA events."""
    import torch

    from deepof_tpu_torch.core.config import OptimConfig
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.schedule import step_decay_schedule
    from deepof_tpu_torch.train.state import create_train_state, global_norm

    model = build_model("flownet_c", device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, device="cuda", generator=gen) * 1e-3
    grads = [p.grad for p in model.parameters()]
    norm = global_norm(grads)
    finite = torch.isfinite(norm)
    out = {"params": sum(p.numel() for p in model.parameters())}
    for k in (1, 2):
        cfg = OptimConfig(grad_accum=k)
        state = create_train_state(model, cfg, step_decay_schedule(cfg, 1))

        def apply():
            state.apply_gradients(norm, finite)

        out[f"grad_accum_{k}"] = {"device_ms": device_ms(apply, iters=10),
                                  "call_ms": time_ms(apply, warmup=2,
                                                     iters=10)}
    return out


# a preempted run with injected faults at full width (FlowNet-C, 384x512,
# batch 4, f32, gradient accumulation 2): a poisoned dispatch at index 3
# (the call from loop step 3 to 4, so step 4 is skipped), a decode fault
# at micro-batch 2, and the first cadence checkpoint corrupted after it
# commits: it is written at loop step 4 and named by the applied steps,
# 3; no eval (the epoch is 16 steps)
PREEMPT_STEPS = 12
PREEMPT_SIGNAL_AT = 5
CLI_PREEMPT = ["--model", "flownet_c", "--synthetic",
               "--set", "data.image_size=[384,512]",
               "--set", "data.gt_size=[384,512]",
               "--set", "data.batch_size=4",
               "--set", "train.log_every=1", "--set", "train.eval_every=0",
               "--set", "train.ckpt_every_steps=4",
               "--set", "train.keep_ckpts=5",
               "--set", "optim.grad_accum=2",
               "--set", "obs.heartbeat_period_s=0.05",
               "--set", "resilience.faults.enabled=true",
               "--set", "resilience.faults.dispatch_at=[3]",
               "--set", "resilience.faults.decode_at=[2]",
               "--set", "resilience.faults.ckpt_corrupt_at=[3]"]
PREEMPT_SKIPPED = 4  # the poisoned step
PREEMPT_CORRUPT = 3  # the corrupted checkpoint
# the command line in a process of its own with cuDNN's deterministic
# algorithms (cli.main turns TF32 off itself, as it does for every user)
CLI_SUBPROCESS = (
    "import sys, torch\n"
    "torch.backends.cudnn.deterministic = True\n"
    "from deepof_tpu_torch import cli\n"
    "sys.exit(cli.main(sys.argv[1:]))\n")


def heartbeat_step(log_dir: str) -> int:
    try:
        with open(os.path.join(log_dir, "heartbeat.json")) as f:
            return int(json.load(f)["step"])
    except (OSError, ValueError, KeyError):
        return -1


def preempted_run(log_dir: str, log_path: str, extra: tuple) -> dict:
    """`train` with CLI_PREEMPT for PREEMPT_STEPS steps in a process of
    its own, sent one SIGTERM once its heartbeat shows step >=
    PREEMPT_SIGNAL_AT: its exit code, summary and records."""
    import signal

    argv = ["train", *CLI_PREEMPT, *extra, "--steps", str(PREEMPT_STEPS),
            "--log-dir", log_dir]
    with open(log_path, "w") as out, open(log_path + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", CLI_SUBPROCESS, *argv],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=out,
            stderr=err)
        try:
            deadline = time.monotonic() + 600
            while heartbeat_step(log_dir) < PREEMPT_SIGNAL_AT:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(
                        f"cli_preempt_faults: the run ended (rc "
                        f"{proc.returncode}) or stalled before step "
                        f"{PREEMPT_SIGNAL_AT}; see {log_path}(.err)")
                time.sleep(0.01)
            signalled_at = heartbeat_step(log_dir)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log_path) as f:
        last = f.read().strip().splitlines()[-1]
    return {"rc": rc, "signalled_at": signalled_at,
            "summary": json.loads(last) if rc == 0 else None,
            "records": read_records(log_dir)}


def cli_preempt_faults(work: str, extra: tuple = ()) -> dict:
    """A full-width FlowNet-C run (CLI_PREEMPT) in a process of its own,
    preempted by a SIGTERM at step >= 5: it exits 0 after a final
    checkpoint that verifies (named by its applied steps: its stop step
    less the skipped one); the poisoned step was skipped in place (one
    skipped update) and the decode fault retried. Then its resume, with
    the restore of every checkpoint after the corrupted one failing too
    (`ckpt_restore_at`): it falls back past the corrupted checkpoint to
    step 0 and trains to PREEMPT_STEPS. The
    preempted run's losses up to its stop and the resume's losses equal
    those of an uninterrupted run with the same faults, bit for bit.
    The uninterrupted run's launches are counted: each kernel once a
    step (a skipped step computes before it skips)."""
    from deepof_tpu_torch.resilience.verify import verify_run
    from deepof_tpu_torch.train.checkpoint import CheckpointManager

    run_dir = os.path.join(work, "cli_preempt")
    t0 = time.monotonic()
    stage_s = {}
    with cudnn_deterministic():
        pre = preempted_run(run_dir, os.path.join(work, "cli_preempt.log"),
                            extra)
        stage_s["preempted"] = time.monotonic() - t0
        if pre["rc"] != 0:
            raise AssertionError(f"cli_preempt_faults: the preempted run "
                                 f"exited {pre['rc']}")
        stopped = [r for r in pre["records"] if r["kind"] == "warn"
                   and "signal 15 received" in r["message"]]
        stop = stopped[0]["step"] if stopped else None
        report = verify_run(run_dir)
        newer = [st for st in CheckpointManager(
            os.path.join(run_dir, "ckpt"), create=False).all_steps()
            if st > PREEMPT_CORRUPT]
        resume = run_cli(["train", *CLI_PREEMPT, *extra, "--set",
                          f"resilience.faults.ckpt_restore_at={newer}",
                          "--steps", str(PREEMPT_STEPS), "--log-dir",
                          run_dir],
                         os.path.join(work, "cli_preempt_resume.log"))
        resume_records = read_records(run_dir)[len(pre["records"]):]
        stage_s["resume"] = time.monotonic() - t0 - sum(stage_s.values())
        ref_dir = os.path.join(work, "cli_preempt_ref")
        reset_kernel_counts()
        ref = run_cli(["train", *CLI_PREEMPT, *extra, "--steps",
                       str(PREEMPT_STEPS), "--log-dir", ref_dir],
                      os.path.join(work, "cli_preempt_ref.log"))
        launches = kernel_counts()
        stage_s["uninterrupted"] = (time.monotonic() - t0
                                    - sum(stage_s.values()))
    ref_records = read_records(ref_dir)

    def losses(records):
        return {r["step"]: r["loss"] for r in records
                if r["kind"] == "train"}

    want = losses(ref_records)
    got_pre, got_resume = losses(pre["records"]), losses(resume_records)
    resumed_from = [r["step"] for r in resume_records if r["kind"] == "info"
                    and r.get("message", "").startswith("resumed from")]
    summary = pre["summary"]
    keys = ("skipped_updates", "data_sample_retries", "fault_dispatch",
            "fault_decode", "fault_ckpt_corrupt", "ckpt_saves",
            "step_ms_median")
    final = None if stop is None else stop - 1  # one skipped update
    row = {"seconds": time.monotonic() - t0, "stage_seconds": stage_s,
           "signalled_at_step": pre["signalled_at"], "stopped_at": stop,
           "final_checkpoint": final,
           "final_checkpoint_verified": final in report["valid_steps"],
           "valid_steps": report["valid_steps"],
           "corrupt_steps": report["corrupt_steps"],
           "preempted": {k: summary.get(k) for k in keys},
           "resume": {"restore_faults_at": newer,
                      "resumed_from": resumed_from,
                      **{k: resume.get(k) for k in (
                          "fault_ckpt_restore", "ckpt_verify_failures",
                          "ckpt_restore_failures", "ckpt_restore_fallbacks",
                          "skipped_updates", "step_ms_median")}},
           "uninterrupted": {k: ref.get(k) for k in keys},
           "launches": launches,
           "losses_preempted": got_pre, "losses_uninterrupted": want,
           "preempted_equal": got_pre == {s: want.get(s) for s in got_pre},
           "resume_equal": got_resume == want}
    emit("cli_preempt_faults", **row)
    if not (stop is not None and PREEMPT_SIGNAL_AT <= stop < PREEMPT_STEPS
            and row["final_checkpoint_verified"]
            and report["corrupt_steps"] == [PREEMPT_CORRUPT]):
        raise AssertionError(f"cli_preempt_faults: stopped at {stop}, "
                             f"checkpoints {report}")
    for name, s in (("preempted", summary), ("uninterrupted", ref)):
        if not (s["skipped_updates"] == 1 and s["data_sample_retries"] >= 1
                and s["fault_dispatch"] == 1 and s["fault_decode"] == 1
                and s["fault_ckpt_corrupt"] == 1):
            raise AssertionError(f"cli_preempt_faults: {name} run's fault "
                                 f"counters {row[name]}")
    if not (resumed_from == [0] and resume["ckpt_verify_failures"] >= 1
            and resume["fault_ckpt_restore"] == len(newer)):
        raise AssertionError(f"cli_preempt_faults: the resume {row['resume']}"
                             f" did not fall back past step "
                             f"{PREEMPT_CORRUPT} to step 0")
    steps = PREEMPT_STEPS
    if launches != want_counts(corr=steps, corr_bwd_f1=steps,
                               corr_bwd_f2=steps, warp_fwd=steps,
                               warp_flow_grad=steps):
        raise AssertionError(f"cli_preempt_faults: launches {launches}")
    if sorted(want) != [s for s in range(1, steps + 1)
                        if s != PREEMPT_SKIPPED] or not (
            row["preempted_equal"] and row["resume_equal"]):
        raise AssertionError("cli_preempt_faults: the preempted and resumed "
                             "losses are not the uninterrupted run's bit for "
                             "bit")
    return row


def work_root() -> str:
    """`build/` of this checkout (ignored by git): where the runs of the
    training phases write their logs and checkpoints."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    return root


# the full-width training configuration of the command-line phases
# (FlowNet-S, 384x512, batch 4, f32; the flyingchairs preset's model is
# not ported, so --model flownet_s)
CLI_TRAIN = ["--model", "flownet_s", "--set", "data.dataset=synthetic",
             "--set", "data.image_size=[384,512]",
             "--set", "data.gt_size=[384,512]",
             "--set", "train.log_every=2", "--set", "train.eval_every=6",
             "--set", "train.ckpt_every_steps=6",
             "--set", "train.eval_batch_size=4"]
CLI_STEPS, RESUME_STEPS = 12, 4
# a resumed run's logged loss vs the replay of its checkpoint and stream
# outside the loop: cuDNN's weight gradients sum in another order in each
# run, and the photometric loss's gradient amplifies that from update to
# update (6e-6 after 2 steps, 1.4e-4 after 4 on the H100); a batch of
# another stream moves the loss by percents
RESUME_RTOL = 1e-3
FIT_PROFILE_STEPS = 6
# FlyingChairs fixture: pairs, train/val split, and the SyntheticData
# validation split the synthetic runs evaluate on
CHAIRS_PAIRS, CHAIRS_VAL = 12, 4
SYNTHETIC_VAL = 16


def run_cli(argv: list[str], log_path: str) -> dict:
    """`deepof_tpu_torch.cli.main(argv)` with its standard output (one
    line per metrics record) sent to `log_path`; its last line, the JSON
    summary, parsed."""
    from deepof_tpu_torch import cli

    with open(log_path, "w") as f, contextlib.redirect_stdout(f), \
            spanned(os.path.basename(log_path)):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} returned {rc}")
    with open(log_path) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def read_records(log_dir: str) -> list[dict]:
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


#: a ledger row's fields shown beside each executable
LEDGER_FIELDS = ("fingerprint", "hlo_chars", "compile_s", "cache_requests",
                 "cache_hits", "cache_misses", "cache_verdict", "flops",
                 "bytes_accessed", "roofline_s", "argument_bytes",
                 "output_bytes", "temp_bytes", "code_bytes", "num_args")


def ledger_rows(log_dir: str) -> dict[str, dict]:
    """The newest executable-ledger row of each name in `log_dir`'s
    ledger.jsonl (`obs/ledger.py`), each checked to hold exactly the JAX
    ROW_KEYS."""
    from deepof_tpu_torch.obs.ledger import (ROW_KEYS, latest_by_name,
                                             load_ledger)

    rows = latest_by_name(load_ledger(log_dir))
    bad = {n: sorted(set(r) ^ set(ROW_KEYS)) for n, r in rows.items()
           if tuple(r) != ROW_KEYS}
    if bad:
        raise AssertionError(f"{log_dir}: ledger rows off ROW_KEYS: {bad}")
    return rows


def ledger_summary(rows: dict[str, dict]) -> dict:
    """{name: the row's LEDGER_FIELDS}."""
    return {n: {k: r[k] for k in LEDGER_FIELDS} for n, r in rows.items()}


def libraries_found(rows: dict[str, dict], needed: bool = True) -> bool:
    """Every row found its libraries built (all were built at the
    script's start): cache_hits = cache_requests and no miss, and on
    the card (`needed`) at least one library a row."""
    return all((r["cache_requests"] or 0) == (r["cache_hits"] or 0)
               and not r["cache_misses"]
               and (not needed or (r["cache_requests"] or 0) >= 1)
               for r in rows.values())


def first_step_trace_s(log_dir: str) -> float | None:
    """The ledger trace's seconds at the newest fit's first step (its
    "first step" info record)."""
    recs = [r for r in read_records(log_dir) if r.get("kind") == "info"
            and str(r.get("message", "")).startswith("first step")]
    return recs[-1].get("ledger_trace_s") if recs else None


def eval_calls(num_val: int, bs: int) -> int:
    """Batched forwards of one `evaluate_aee` sweep: the full batches, and
    valid / gcd(valid, bs) tiles for a short last one."""
    full, valid = divmod(num_val, bs)
    return full + (valid // math.gcd(valid, bs) if valid else 0)


def warp_counts() -> tuple[int, int]:
    from deepof_tpu_torch.ops.cuda import warp as cw

    return cw.fwd_launches.count, cw.grad_launches.count


def warp_counters() -> list:
    """The launch counters of the warp kernels: the forward's by call
    site (the loss, the augmentation, the occlusion mask, the quality
    scorer), the flow gradient's, and the bf16 instances' (the loss under
    loss.gather_dtype=bfloat16)."""
    from deepof_tpu_torch.ops.cuda import warp as cw

    return [cw.fwd_launches, cw.grad_launches, cw.augment_launches,
            cw.occlusion_launches, cw.quality_launches,
            cw.fwd_bf16_launches, cw.grad_bf16_launches]


def reset_warp_counts() -> None:
    for c in warp_counters():
        c.reset()


def fit_row(summary: dict, batch: int) -> dict:
    """The loop's own numbers of one fit, from its summary: the median
    host-clock step over its timed steps (eval and checkpoint saves
    left out) and pairs/s from it, the main thread's median time in the
    train-step call, the producer's draw and staging time per batch, the
    wait for a staged batch, starved steps, the staging queue's peak, and
    the checkpoint saves' seconds."""
    step_ms = summary["step_ms_median"]
    return {"step_ms_median": step_ms,
            "pairs_per_s": batch / (step_ms / 1e3),
            "pairs_per_s_cumulative": summary["items_per_sec_per_chip"],
            "step_call_ms_median": summary["phase_dispatch_ms_median"],
            "draw_ms": 1e3 * summary["data_assemble_s_mean"],
            "put_ms_median": summary.get("phase_put_ms_median", 0.0),
            "input_wait_ms_median": summary["phase_assemble_ms_median"],
            "input_wait_s_total": summary["phase_assemble_s"],
            "starved_steps": summary.get("starved", 0),
            "max_staged_depth": summary["data_max_staged_depth"],
            "ckpt_saves": summary["ckpt_saves"],
            "ckpt_save_s_total": summary["ckpt_save_s_total"],
            "ckpt_save_s_max": summary["ckpt_save_s_max"]}


def check_run(log_dir: str, train_steps: list[int], eval_steps: list[int],
              ckpt_steps: list[int]) -> list[dict]:
    """The records and checkpoints of a command-line run: train records at
    `train_steps` and eval records at `eval_steps`, all finite, and the
    checkpoints at `ckpt_steps` verified against their manifests."""
    import numpy as np

    from deepof_tpu_torch.resilience.verify import verify_run

    records = read_records(log_dir)
    train = [r for r in records if r["kind"] == "train"]
    evals = [r for r in records if r["kind"] == "eval"]
    got = ([r["step"] for r in train], [r["step"] for r in evals])
    if got != (train_steps, eval_steps):
        raise AssertionError(f"train/eval records at steps {got}; want "
                             f"{(train_steps, eval_steps)}")
    values = ([r["loss"] for r in train] + [r["grad_norm"] for r in train]
              + [r[k] for r in evals for k in ("aee", "aae", "val_loss")])
    if not all(v is not None and np.isfinite(v) for v in values):
        raise AssertionError(f"non-finite losses or eval metrics: {values}")
    report = verify_run(log_dir)
    if not (report["ok"] and set(ckpt_steps) <= set(report["valid_steps"])):
        raise AssertionError(f"checkpoints at {ckpt_steps} do not all "
                             f"verify: {report}")
    return records


def cli_train(work: str) -> dict:
    """`train` on the command line at full width: 12 steps, a train record
    every 2, evals and checkpoints at 6 and 12. Each warp kernel launches
    once per train step, and the forward once more per eval forward."""
    log_dir = os.path.join(work, "cli_train")
    reset_warp_counts()
    summary = run_cli(["train", *CLI_TRAIN, "--steps", str(CLI_STEPS),
                       "--log-dir", log_dir],
                      os.path.join(work, "cli_train.log"))
    launches = warp_counts()
    records = check_run(log_dir, list(range(2, CLI_STEPS + 1, 2)), [6, 12],
                        [6, 12])
    evals = 2 * eval_calls(SYNTHETIC_VAL, 4)
    ledger = ledger_rows(log_dir)
    row = {"steps": CLI_STEPS, **fit_row(summary, 4),
           "ledger": ledger_summary(ledger),
           "ledger_trace_s": first_step_trace_s(log_dir),
           "warp_fwd_launches": launches[0],
           "warp_flow_grad_launches": launches[1], "eval_forwards": evals,
           "losses": [r["loss"] for r in records if r["kind"] == "train"],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"]}
    emit("cli_train", **row)
    if sorted(ledger) != ["eval_step", "train_step"] or not libraries_found(
            ledger):
        raise AssertionError(f"cli train: ledger rows {row['ledger']}")
    if launches != (CLI_STEPS + evals, CLI_STEPS):
        raise AssertionError(f"cli train: warp kernels launched {launches} "
                             f"times in {CLI_STEPS} steps and {evals} eval "
                             f"forwards; want {(CLI_STEPS + evals, CLI_STEPS)}")
    return row


def replay_resume(log_dir: str, steps: int) -> list[float]:
    """The losses of the first `steps` steps a resume of the run in
    `log_dir` should take: its newest checkpoint restored into a trainer
    of the configuration `config` resolves for `CLI_TRAIN`, then
    `train_step` on the batches of the resumed stream (`draw_batches`),
    outside the loop."""
    import io

    from deepof_tpu_torch import cli
    from deepof_tpu_torch.core.config import config_from_dict
    from deepof_tpu_torch.train.checkpoint import CheckpointManager
    from deepof_tpu_torch.train.loop import Trainer

    with tempfile.TemporaryDirectory(dir=work_root()) as scratch:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["config", *CLI_TRAIN, "--log-dir", scratch])
        trainer = Trainer(config_from_dict(json.loads(out.getvalue())),
                          device="cuda")
        if CheckpointManager(os.path.join(log_dir, "ckpt"), create=False
                             ).restore(trainer.state) is None:
            raise AssertionError(f"no checkpoint restores from {log_dir}")
        trainer.model.train()
        return [host_metrics(trainer.train_step(trainer.state, b))["total"]
                for b, _ in draw_batches(trainer, steps)]


def cli_resume(work: str) -> dict:
    """The `cli_train` command again with --steps 4: it resumes from the
    step-12 checkpoint and ends at 16 (an epoch end: a train record and
    an eval). Its logged losses at steps 14 and 16 must be those of the
    step-12 checkpoint stepped on derive_batch_rng(data_stream_seed(0,
    12), i) outside the loop (`replay_resume`), to RESUME_RTOL."""
    import numpy as np

    log_dir = os.path.join(work, "cli_train")
    # cli_train's ledger, aside: the resume appends its own rows
    baseline = os.path.join(work, "cli_train_ledger_baseline.jsonl")
    shutil.copy(os.path.join(log_dir, "ledger.jsonl"), baseline)
    want = replay_resume(log_dir, RESUME_STEPS)
    reset_warp_counts()
    summary = run_cli(["train", *CLI_TRAIN, "--steps", str(RESUME_STEPS),
                       "--log-dir", log_dir],
                      os.path.join(work, "cli_resume.log"))
    launches = warp_counts()
    end = CLI_STEPS + RESUME_STEPS
    # step 16 also ends the first epoch (64 synthetic pairs / batch 4):
    # a train record and an eval there
    records = check_run(log_dir, list(range(2, end + 1, 2)), [6, 12, end],
                        [CLI_STEPS, end])
    resumed = [r for r in records if r["kind"] == "info"
               and r["message"] == f"resumed from step {CLI_STEPS}"]
    logged = {r["step"]: r["loss"] for r in records if r["kind"] == "train"
              and r["step"] > CLI_STEPS}
    replayed = {CLI_STEPS + 1 + i: v for i, v in enumerate(want)
                if CLI_STEPS + 1 + i in logged}
    rel = {s: abs(logged[s] - v) / abs(v) for s, v in replayed.items()}
    # the executable ledger's gate: the resumed run against cli_train's
    # rows, the same fingerprints and no library built
    gate_rc, gate = run_verb(["tail", "--log-dir", log_dir,
                              "--ledger-baseline", baseline],
                             os.path.join(work, "cli_resume_tail.log"))
    diff = gate.get("ledger_diff") or {}
    row = {"resumed_from": CLI_STEPS if resumed else None, "end_step": end,
           **fit_row(summary, 4), "warp_fwd_launches": launches[0],
           "warp_flow_grad_launches": launches[1],
           "logged_losses": logged, "replayed_losses": replayed,
           "replay_loss_rel": rel,
           "ledger": ledger_summary(ledger_rows(log_dir)),
           "ledger_gate": {"rc": gate_rc, **{k: diff.get(k) for k in (
               "compared", "failed", "fingerprint_drift",
               "unexpected_recompiles", "compile_blowups",
               "memory_growth")}}}
    emit("cli_resume", **row)
    if (gate_rc, diff.get("compared"), diff.get("failed")) != (0, 2, False):
        raise AssertionError(f"resume: tail --ledger-baseline gave "
                             f"{row['ledger_gate']}; want rc 0, 2 "
                             "executables compared, no failure")
    if not (resumed and len(rel) == RESUME_STEPS // 2
            and all(np.isfinite(v) and v <= RESUME_RTOL
                    for v in rel.values())):
        raise AssertionError(f"resume: 'resumed from step {CLI_STEPS}' "
                             f"logged {bool(resumed)}; logged losses "
                             f"{logged} vs the replay of the resumed stream "
                             f"{replayed} (limit rel {RESUME_RTOL})")
    want = (RESUME_STEPS + eval_calls(SYNTHETIC_VAL, 4), RESUME_STEPS)
    if launches != want:
        raise AssertionError(f"resume: warp kernels launched {launches} "
                             f"times; want {want}")
    return row


class StepWindow:
    """A train step wrapped so that torch.profiler (device events) and the
    host clock cover the steps after call `start` returns up to the
    return of call `stop`: steps start+1 .. stop of a fit, the loop's own
    work between them included. `row(batch)` gives their step ms, device
    busy (the compute stream's kernels; the prefetcher's host-to-device
    copies run on their own stream and are given apart) and idle share."""

    def __init__(self, step, start: int, stop: int):
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        self.step, self.start, self.stop = step, start, stop
        self.prof = torch_profile(activities=[ProfilerActivity.CUDA],
                                  acc_events=True)
        self.calls = 0

    def __call__(self, state, batch):
        import torch

        metrics = self.step(state, batch)
        self.calls += 1
        if self.calls == self.start:
            torch.cuda.synchronize()
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.calls == self.stop:
            torch.cuda.synchronize()
            self.seconds = time.perf_counter() - self.t0
            self.prof.stop()
        return metrics

    def row(self, batch: int) -> dict:
        n = self.stop - self.start
        rows = list(_device_rows(self.prof))
        h2d = sum(dev for dev, e in rows if "HtoD" in e.key) / 1e3
        busy = sum(dev for dev, e in rows if "HtoD" not in e.key) / 1e3 / n
        step_ms = 1e3 * self.seconds / n
        if busy <= 0:
            raise AssertionError("torch.profiler recorded no device time in "
                                 "the fit's steps")
        return {"steps": n, "step_ms": step_ms,
                "pairs_per_s": batch / (step_ms / 1e3),
                "device_time_visible": busy > 0,
                "device_busy_ms_per_step": busy,
                "idle_share_of_step": 1 - busy / step_ms,
                "h2d_copy_ms_per_step": h2d / n}


def fit_profile(work: str) -> dict:
    """Where a step of `Trainer.fit` goes, prefetcher on (default depth 2):
    FIT_PROFILE_STEPS steps under torch.profiler after 2 warm steps
    (`StepWindow`), against the host clock of the same steps; then
    `train_profile`'s step on a batch already on the card, on the same
    trainer."""
    from deepof_tpu_torch.train.loop import Trainer

    trainer = Trainer(fit_profile_cfg(work), device="cuda")
    step = trainer.train_step
    window = StepWindow(step, 2, 2 + FIT_PROFILE_STEPS)
    trainer.train_step = window
    try:
        summary = trainer.fit(max_steps=window.stop + 1)
    finally:
        trainer.train_step = step
    on_card_ms, card_prof = profile_steps(trainer, 3)
    on_card_busy = sum(t for t, _ in device_kernels(card_prof, 3))
    row = {**window.row(4),
           "prefetch_depth": trainer.cfg.data.prefetch,
           "num_workers": trainer.cfg.data.num_workers,
           "fit": fit_row(summary, 4),
           "on_card_batch": {"step_ms": on_card_ms,
                             "device_busy_ms": on_card_busy,
                             "idle_share_of_step": 1 - on_card_busy
                             / on_card_ms}}
    emit("fit_profile", **row)
    return row


def fit_profile_cfg(work: str):
    """`fit_profile`'s configuration: the full-width training default, no
    eval, no train record before the end."""
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)

    return ExperimentConfig(
        data=DataConfig(dataset="synthetic"),
        train=TrainConfig(log_dir=os.path.join(work, "fit_profile"),
                          log_every=1000, eval_every=0, nan_guard=False))


def fit_variants(steps: int = 2 + FIT_PROFILE_STEPS + 1) -> dict:
    """`fit_profile`'s fit (profiler off) as it is and in three variants,
    each with `fit_row`'s numbers: the interpreter's thread switch
    interval cut from 5 ms to 0.2 ms (if the producer and the main thread
    hand the GIL over between bytecodes, each waits less for it), two
    pipeline worker threads drawing, and PyTorch's CPU ops on one thread
    (the draw's resizes otherwise use every core beside the main thread).
    On demand, on the card:

        python3 -c "import chip_smoke as cs; cs.fit_variants()"
    """
    import torch

    from deepof_tpu_torch.train.loop import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    interval, threads = sys.getswitchinterval(), torch.get_num_threads()
    rows = {}
    with tempfile.TemporaryDirectory(dir=work_root()) as work:
        cfg = fit_profile_cfg(work)
        trainer = Trainer(cfg, device="cuda")
        for name, workers, switch, n_threads in (
                ("default", 0, interval, threads),
                ("switch_interval_0.2ms", 0, 2e-4, threads),
                ("num_workers_2", 2, interval, threads),
                ("torch_threads_1", 0, interval, 1)):
            trainer.cfg = cfg.replace(data=dataclasses.replace(
                cfg.data, num_workers=workers))
            sys.setswitchinterval(switch)
            torch.set_num_threads(n_threads)
            try:
                rows[name] = fit_row(trainer.fit(max_steps=steps), 4)
            finally:
                sys.setswitchinterval(interval)
                torch.set_num_threads(threads)
                trainer.cfg = cfg
    emit("fit_variants", **rows)
    return rows


# the Sintel tree of `cli_sintel`: three clips at Sintel's 436x1024,
# frames per clip; bamboo_2 is long enough (2T frames at T = 10) for
# the second val window that the loader gives it
SINTEL_CLIPS = {"alley_1": 14, "bamboo_2": 20, "market_2": 14}
SINTEL_HW = (436, 1024)


def write_chairs(root: str, seed: int = 0, pairs: int = CHAIRS_PAIRS,
                 val: int = CHAIRS_VAL) -> None:
    """`pairs` FlyingChairs pairs in the dataset's layout: 384x512 binary
    PPM frames (the second a shifted copy of a smooth first) and their
    .flo flows, with a split file marking the last `val` val."""
    import numpy as np

    from deepof_tpu_torch.io.flo import write_flo
    from deepof_tpu_torch.io.ppm import write_ppm_bgr

    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:384, 0:512].astype(np.float32)
    for i in range(1, pairs + 1):
        sid = os.path.join(root, f"{i:05d}")
        fy, fx, ph = rs.rand(3) * [0.05, 0.05, 6.28]
        img = 127 + 100 * np.sin(fy * yy + fx * xx + ph)[..., None] * \
            rs.rand(3)
        u, v = rs.randint(-4, 5, 2)
        write_ppm_bgr(sid + "_img1.ppm", img.astype(np.uint8))
        write_ppm_bgr(sid + "_img2.ppm",
                      np.roll(img, (v, u), (0, 1)).astype(np.uint8))
        write_flo(sid + "_flow.flo", np.broadcast_to(
            np.asarray([u, v], np.float32), (384, 512, 2)))
    with open(os.path.join(root, "FlyingChairs_train_val.txt"), "w") as f:
        f.write("\n".join(["1"] * (pairs - val) + ["2"] * val) + "\n")


def write_sintel(root: str, clips=SINTEL_CLIPS, hw=SINTEL_HW,
                 seed: int = 0) -> dict:
    """An MPI-Sintel tree in the dataset's layout, clips {name: frames}:
    `training/final/<clip>/frame_XXXX.png` (written with `io/png.py`) and
    `training/flow/<clip>/frame_XXXX.flo` at `hw`. Each clip is a smooth random texture moving
    by a whole (u, v) pixels a frame, so every flow is the uniform
    (-u, -v): frame t+1 at p + flow is frame t at p. Returns {clip:
    (u, v)}."""
    import numpy as np

    from deepof_tpu_torch.io.flo import write_flo
    from deepof_tpu_torch.io.png import write_png

    rs = np.random.RandomState(seed)
    h, w = hw
    pad = 3 * max(clips.values())
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad].astype(np.float32)
    shifts = {}
    for clip, frames in clips.items():
        img_dir = os.path.join(root, "training", "final", clip)
        flo_dir = os.path.join(root, "training", "flow", clip)
        os.makedirs(img_dir)
        os.makedirs(flo_dir)
        canvas = np.full(yy.shape + (3,), 127.0, np.float32)
        for _ in range(3):
            fy, fx, ph = rs.rand(3) * [0.08, 0.08, 6.28]
            canvas += 40 * np.sin(fy * yy + fx * xx + ph)[..., None] * \
                rs.rand(3)
        canvas = np.clip(canvas, 0, 255).astype(np.uint8)
        u, v = (int(x) for x in rs.randint(-3, 4, 2))
        shifts[clip] = (u, v)
        flow = np.broadcast_to(np.asarray([-u, -v], np.float32), (h, w, 2))
        for t in range(frames):
            y0, x0 = pad + t * v, pad + t * u
            write_png(os.path.join(img_dir, f"frame_{t + 1:04d}.png"),
                      canvas[y0:y0 + h, x0:x0 + w])
            if t + 1 < frames:
                write_flo(os.path.join(flo_dir, f"frame_{t + 1:04d}.flo"),
                          flow)
    return shifts


# the first classes of UCF-101's list, in its order (sorted, as the
# loader sorts them)
UCF101_CLASSES = ("ApplyEyeMakeup", "ApplyLipstick", "Archery",
                  "BabyCrawling", "BalanceBeam", "BandMarching",
                  "BaseballPitch", "Basketball")


def write_ucf101(root: str, classes: int = len(UCF101_CLASSES),
                 frames: int = 3, hw=(240, 320), fmt: str = "ppm",
                 seed: int = 0, train_clips: int = 1) -> dict:
    """A UCF-101 tree in the dataset's layout: `frames/<class>/<clip>/
    frame_XXXX.<fmt>` ("ppm" or "png", written by `io/`), each class
    `train_clips` train clips `v_<class>_gNN_c01` (groups 8, 9, ...) and
    one val clip `v_<class>_g01_c01` (group 1) of `frames` frames at
    `hw` (UCF-101's own 240x320 by default). A clip is a texture of its class's colours
    moving by a whole (u, v) pixels a frame. Returns {clip dir: (u, v)}."""
    import numpy as np

    from deepof_tpu_torch.io.png import write_png
    from deepof_tpu_torch.io.ppm import write_ppm_bgr

    write = {"ppm": write_ppm_bgr, "png": write_png}[fmt]
    names = [UCF101_CLASSES[i] if i < len(UCF101_CLASSES) else f"Class{i:03d}"
             for i in range(classes)]
    rs = np.random.RandomState(seed)
    h, w = hw
    pad = 3 * frames
    yy, xx = np.mgrid[0:h + 2 * pad, 0:w + 2 * pad].astype(np.float32)
    shifts = {}
    for ci, name in enumerate(names):
        tint = rs.rand(3)
        for group in (*range(8, 8 + train_clips), 1):
            clip = os.path.join(root, "frames", name,
                                f"v_{name}_g{group:02d}_c01")
            os.makedirs(clip)
            canvas = np.full(yy.shape + (3,), 60.0 + 120.0 * tint,
                             np.float32)
            for _ in range(3):
                fy, fx, ph = rs.rand(3) * [0.08, 0.08, 6.28]
                canvas += 40 * np.sin(fy * yy + fx * xx + ph)[..., None] \
                    * rs.rand(3)
            canvas = np.clip(canvas, 0, 255).astype(np.uint8)
            u, v = (int(x) for x in rs.randint(-3, 4, 2))
            shifts[clip] = (u, v)
            for t in range(frames):
                y0, x0 = pad + t * v, pad + t * u
                write(os.path.join(clip, f"frame_{t + 1:04d}.{fmt}"),
                      canvas[y0:y0 + h, x0:x0 + w])
    return shifts


def cli_flyingchairs(work: str) -> dict:
    """`train --preset flyingchairs` on a FlyingChairs tree, 4 steps at
    384x512: two epochs of 2 steps, so a train and an eval record at
    each epoch end, and the warp kernels once per step (the forward once
    more per eval forward)."""
    data_dir = os.path.join(work, "chairs")
    log_dir = os.path.join(work, "cli_flyingchairs")
    write_chairs(data_dir)
    reset_warp_counts()
    summary = run_cli(["train", "--preset", "flyingchairs", "--model",
                       "flownet_s", "--data-path", data_dir,
                       "--set", "data.image_size=[384,512]",
                       "--steps", "4", "--set", "train.eval_every=4",
                       "--log-dir", log_dir],
                      os.path.join(work, "cli_flyingchairs.log"))
    launches = warp_counts()
    records = check_run(log_dir, [2, 4], [2, 4], [4])
    evals = 2 * eval_calls(CHAIRS_VAL, 8)
    row = {"pairs": CHAIRS_PAIRS, "val": CHAIRS_VAL,
           **fit_row(summary, 4), "warp_fwd_launches": launches[0],
           "warp_flow_grad_launches": launches[1],
           "decode_cache_misses": [r["decode_cache_misses"] for r in records
                                   if r["kind"] == "train"][-1],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"]}
    emit("cli_flyingchairs", **row)
    if launches != (4 + evals, 4):
        raise AssertionError(f"flyingchairs: warp kernels launched "
                             f"{launches} times; want {(4 + evals, 4)}")
    return row


# `train --preset sintel --model flownet_s` on the Sintel tree: 4 steps
# (one epoch) at the preset's full geometry (T = 10,
# 224x480 crops of 256x512 frames, batch 4; 436x1024 ground truth),
# visuals at the eval; the profiled steps of the fit (StepWindow) are
# steps 2-4, before the eval at the epoch's end
SINTEL_STEPS = 4
SINTEL_WINDOW = (1, 4)


def sintel_argv(data_dir: str, log_dir: str, streaming: bool) -> list:
    return (["--preset", "sintel", "--model", "flownet_s", "--data-path",
             data_dir, "--log-dir", log_dir]
            + (["--set", "data.cache_decoded=false"] if streaming else []))


def sintel_draw_breakdown(ds, batch: int) -> dict:
    """Where a cached-route Sintel draw's host time goes, on this
    machine: the decode of every frame at its own size into the cache
    (ms a frame), then, with the cache warm, one `sample_train` of
    `batch` windows (ms) and its parts done alone: the frames' resizes
    to the network size and the `.flo` reads (ms a batch)."""
    import numpy as np

    from deepof_tpu_torch.data.datasets import _resize
    from deepof_tpu_torch.io.flo import read_flo

    frames = sorted({p for w in ds.windows for p in w})
    t0 = time.perf_counter()
    for p in frames:
        ds._cache(p)
    decode = time.perf_counter() - t0
    rs = np.random.RandomState(0)
    idxs = [ds.train_idx[i] for i in rs.randint(0, ds.num_train, batch)]
    t0 = time.perf_counter()
    ds.sample_train(batch, rng=rs)
    draw = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in idxs:
        for p in ds.windows[i]:
            _resize(ds._cache(p), ds.cfg.image_size)
    resize = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in idxs:
        for p in ds.flow_windows[i]:
            read_flo(p)
    flo = time.perf_counter() - t0
    return {"decode_ms_per_frame": 1e3 * decode / len(frames),
            "frames": len(frames), "warm_draw_ms": 1e3 * draw,
            "resize_ms_per_batch": 1e3 * resize,
            "flo_read_ms_per_batch": 1e3 * flo,
            "flo_bytes_per_batch": sum(os.path.getsize(p) for i in idxs
                                       for p in ds.flow_windows[i])}


def cli_sintel(work: str, fixture_s: float | None = None) -> dict:
    """This slice's main path: `train --preset sintel --model flownet_s
    --data-path <tree> --max-steps 4 --set train.dump_visuals=true` on a
    Sintel tree written here (`write_sintel`; `main` writes it beside
    the kernels' build, `fixture_s` its seconds), with the frames decoded in
    the cached route and, when the native decoder has a PNG codec, again
    in the streaming route (`data.cache_decoded=false`); then `eval
    --dump-visuals` on the cached run. Each route: the step in `fit`,
    pairs/s, the idle share of the profiled steps, the draw's ms per
    batch, finite losses and AEE at 436x1024, the warp kernels once per
    step (and the forward once per eval forward: one a sweep of the 4
    val windows), and PNG visuals that decode back; and where the cached
    route's draw goes (`sintel_draw_breakdown`)."""
    import numpy as np

    from deepof_tpu_torch import native
    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.data.datasets import SintelData
    from deepof_tpu_torch.io.png import read_png_bgr
    from deepof_tpu_torch.train import loop

    data_dir = os.path.join(work, "sintel")
    if not os.path.isdir(data_dir):
        t0 = time.monotonic()
        write_sintel(data_dir)
        fixture_s = time.monotonic() - t0
    codecs = sorted(native.codecs())
    preset = get_config("sintel")
    batch, gt_hw = preset.data.batch_size, preset.data.gt_size
    routes = ["cached"] + (["streaming"] if "png" in codecs else [])
    row = {"fixture": {"clips": SINTEL_CLIPS, "hw": list(SINTEL_HW),
                       "seconds": fixture_s},
           "codecs": codecs, "native_library": native.library_path(),
           "routes": {}}
    if "png" not in codecs:
        row["streaming_not_run"] = (
            "the native decoder built without a PNG codec (no libpng on "
            "this machine), so data.cache_decoded=false has no batch "
            "decoder for PNG frames: it reads them one by one with "
            "io/png.py, the cached route's reader, and is not run")
    make_step = loop.make_train_step
    for route in routes:
        streaming = route == "streaming"
        log_dir = os.path.join(work, f"cli_sintel_{route}")
        argv = sintel_argv(data_dir, log_dir, streaming)
        cfg = dataclasses.replace(preset.data, data_path=data_dir,
                                  cache_decoded=not streaming)
        ds = SintelData(cfg)
        windows = []

        def windowed(*a, **kw):
            windows.append(StepWindow(make_step(*a, **kw), *SINTEL_WINDOW))
            return windows[-1]

        loop.make_train_step = windowed
        reset_warp_counts()
        try:
            summary = run_cli(["train", *argv, "--max-steps",
                               str(SINTEL_STEPS), "--set",
                               "train.dump_visuals=true"],
                              os.path.join(work, f"cli_sintel_{route}.log"))
        finally:
            loop.make_train_step = make_step
        launches = warp_counts()
        spe = ds.num_train // batch  # steps per epoch: an eval at each end
        ends = list(range(spe, SINTEL_STEPS + 1, spe))
        records = check_run(log_dir, ends, ends, [SINTEL_STEPS])
        evals = len(ends) * eval_calls(ds.num_val,
                                       preset.train.eval_batch_size)
        visuals = sorted(os.listdir(os.path.join(log_dir, "visuals")))
        row["routes"][route] = {
            "decode_route": ds.decode_route, "windows": len(ds.windows),
            "num_train": ds.num_train, "num_val": ds.num_val,
            "val_idx": ds.val_idx, "steps": SINTEL_STEPS,
            **fit_row(summary, batch),
            "profiled": windows[0].row(batch),
            "warp_fwd_launches": launches[0],
            "warp_flow_grad_launches": launches[1], "eval_forwards": evals,
            "losses": [r["loss"] for r in records if r["kind"] == "train"],
            "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                      for r in records if r["kind"] == "eval"],
            "visuals": visuals}
        if not streaming:
            row["routes"][route]["draw_breakdown"] = sintel_draw_breakdown(
                ds, batch)
        if launches != (SINTEL_STEPS + evals, SINTEL_STEPS):
            raise AssertionError(f"cli_sintel {route}: warp kernels launched "
                                 f"{launches} times in {SINTEL_STEPS} steps "
                                 f"and {evals} eval forwards; want "
                                 f"{(SINTEL_STEPS + evals, SINTEL_STEPS)}")
        want = {f"val0_s{i}_{k}.png" for i in range(min(ds.num_val, 8))
                for k in ("flow", "gt", "recon")}
        if set(visuals) != want:
            raise AssertionError(f"cli_sintel {route}: visuals {visuals}")
    # eval --dump-visuals on the cached run's checkpoint
    log_dir = os.path.join(work, "cli_sintel_cached")
    vis = os.path.join(log_dir, "visuals")
    shutil.rmtree(vis)
    reset_warp_counts()
    ev = run_cli(["eval", *sintel_argv(data_dir, log_dir, False),
                  "--dump-visuals"], os.path.join(work, "cli_sintel_eval.log"))
    eval_launches = warp_counts()
    shapes = {n: list(read_png_bgr(os.path.join(vis, n)).shape)
              for n in sorted(os.listdir(vis))}
    row["eval"] = {**{k: ev[k] for k in ("aee", "aae", "val_loss",
                                         "gt_abs_mean", "pred_abs_mean")},
                   "warp_fwd_launches": eval_launches[0],
                   "visual_shapes": shapes}
    emit("cli_sintel", **row)
    h, w = preset.data.image_size
    # flows at the ground truth's size; the reconstruction at the finest
    # flow's, half the network input
    want_shapes = {"flow": [*gt_hw, 3], "gt": [*gt_hw, 3],
                   "recon": [-(-h // 2), -(-w // 2), 3]}
    if not (np.isfinite([ev[k] for k in ("aee", "aae", "val_loss")]).all()
            and eval_launches == (eval_calls(ds.num_val,
                                             preset.train.eval_batch_size), 0)
            and shapes and all(s == want_shapes[n.rsplit("_", 1)[1][:-4]]
                               for n, s in shapes.items())):
        raise AssertionError(f"cli_sintel eval: {row['eval']}")
    return row


def cli_eval_predict(work: str) -> dict:
    """`eval` on the `cli_train` run (its newest checkpoint, step 16):
    finite aee, aae and val_loss, the warp forward once per eval forward;
    then `predict` on a .npy pair and a PNG pair at 384x512: 2 .flo files
    of that size, each with its flow-colour PNG."""
    import numpy as np

    from deepof_tpu_torch.io.flo import read_flo
    from deepof_tpu_torch.io.png import read_png_bgr, write_png
    from deepof_tpu_torch.utils.flowviz import flow_to_color

    log_dir = os.path.join(work, "cli_train")
    reset_warp_counts()
    ev = run_cli(["eval", *CLI_TRAIN, "--log-dir", log_dir],
                 os.path.join(work, "cli_eval.log"))
    launches = warp_counts()
    rs = np.random.RandomState(1)
    pairs = []
    for i, ext in enumerate(("npy", "png")):
        paths = [os.path.join(work, f"pair{i}_{k}.{ext}") for k in "ab"]
        for p in paths:
            img = rs.randint(0, 256, (384, 512, 3), np.uint8)
            if ext == "npy":
                np.save(p, img)
            else:
                write_png(p, img)
        pairs.append(":".join(paths))
    out = run_cli(["predict", *CLI_TRAIN, "--log-dir", log_dir, "--out",
                   os.path.join(work, "flows"), "--pairs", *pairs],
                  os.path.join(work, "cli_predict.log"))
    flo_paths = [p for p in out["written"] if p.endswith(".flo")]
    flows = [read_flo(p) for p in flo_paths]
    colours_ok = [np.array_equal(read_png_bgr(p[:-4] + ".png"),
                                 flow_to_color(f))
                  for p, f in zip(flo_paths, flows)]
    row = {"eval": {k: ev[k] for k in ("aee", "aae", "val_loss")},
           "eval_warp_fwd_launches": launches[0],
           "written": [os.path.basename(p) for p in out["written"]],
           "predicted": [list(f.shape) for f in flows],
           "predicted_abs_max": [float(np.abs(f).max()) for f in flows],
           "flow_png_equals_colours": colours_ok}
    emit("cli_eval_predict", **row)
    if len(out["written"]) != 4 or not all(colours_ok):
        raise AssertionError(f"predict wrote {out['written']}; flow PNGs "
                             f"equal to their flows' colours: {colours_ok}")
    if not all(np.isfinite(ev[k]) for k in ("aee", "aae", "val_loss")):
        raise AssertionError(f"eval: non-finite metrics {ev}")
    if launches[0] != eval_calls(SYNTHETIC_VAL, 4):
        raise AssertionError(f"eval: warp forward launched {launches[0]} "
                             "times")
    if [f.shape for f in flows] != [(384, 512, 2)] * 2 or not all(
            np.isfinite(f).all() for f in flows):
        raise AssertionError(f"predict wrote {[f.shape for f in flows]}")
    return row


# Inception-v3, the flyingchairs and sintel presets' model, at full width
# (44.55 M parameters): the warp's six levels of the flyingchairs
# preset's 320x448, batch 4 (finest at H/2; Mixed_5d and MaxPool_5a
# share H/8), and of the bench's batch 16
INCEPTION_LEVELS = [(4, 3, 160 >> k, 224 >> k) for k in (0, 1, 2, 2, 3, 4)]
BENCH_LEVELS = [(16, 3, h, w) for _, _, h, w in INCEPTION_LEVELS]
# `train --preset flyingchairs --synthetic` at the preset's geometry
# (320x448, batch 4): a train record every 2 steps, an eval (the 16
# synthetic val pairs, 4 a forward) and a checkpoint at the last step;
# the steps of the fit under torch.profiler (StepWindow) are 3-5
INCEPTION_STEPS = 6
INCEPTION_WINDOW = (2, 5)
CLI_INCEPTION = ["--preset", "flyingchairs", "--synthetic",
                 "--set", "data.image_size=[320,448]",
                 "--set", "data.gt_size=[320,448]",
                 "--set", "data.batch_size=4",
                 "--set", "train.eval_batch_size=4",
                 "--set", "train.log_every=2",
                 "--set", f"train.eval_every={INCEPTION_STEPS}",
                 "--set", f"train.ckpt_every_steps={INCEPTION_STEPS}"]
# F17: an InferenceEngine in a process of its own that leaves PyTorch's
# TF32 switches as it starts them, on the flyingchairs run's checkpoint;
# then the same request with cuDNN's TF32 switched back on, the error
# the rule keeps out: argv = config JSON, prev .npy, next .npy, output
# .npy (the two flows stacked)
ENGINE_SUBPROCESS = (
    "import json, sys, numpy as np, torch\n"
    "before = [torch.backends.cudnn.allow_tf32,\n"
    "          torch.backends.cuda.matmul.allow_tf32]\n"
    "from deepof_tpu_torch.core.config import config_from_dict\n"
    "from deepof_tpu_torch.predict import restore_params\n"
    "from deepof_tpu_torch.serve.engine import InferenceEngine\n"
    "with open(sys.argv[1]) as f:\n"
    "    cfg = config_from_dict(json.load(f))\n"
    "with InferenceEngine(cfg, model=restore_params(cfg)) as eng:\n"
    "    after = [torch.backends.cudnn.allow_tf32,\n"
    "             torch.backends.cuda.matmul.allow_tf32]\n"
    "    flow = eng.submit(sys.argv[2], sys.argv[3]).result()['flow']\n"
    "    torch.backends.cudnn.allow_tf32 = True\n"
    "    tf32 = eng.submit(sys.argv[2], sys.argv[3]).result()['flow']\n"
    "np.save(sys.argv[4], np.stack([flow, tf32]))\n"
    "print(json.dumps({'before': before, 'after': after}))\n")
# the engine's flow against predict's, of the largest entry: cuDNN may
# choose another float32 algorithm in another process (1.2e-6 of a
# 4.8 px flow on the H100), and TF32 moves it by orders more
F17_RTOL = 1e-5


def run_windowed(argv: list, log_path: str, window: tuple[int, int]):
    """`run_cli(argv)` with the fit's train step wrapped in a StepWindow
    over `window`: (summary, the window)."""
    from deepof_tpu_torch.train import loop

    make_step = loop.make_train_step
    windows = []

    def windowed(*a, **kw):
        windows.append(StepWindow(make_step(*a, **kw), *window))
        return windows[-1]

    loop.make_train_step = windowed
    try:
        summary = run_cli(argv, log_path)
    finally:
        loop.make_train_step = make_step
    return summary, windows[0]


def inception_trainer(work: str, compute_dtype: str):
    """A full-width Inception-v3 Trainer on the card with the
    flyingchairs preset's loss and geometry (320x448, batch 4) on
    synthetic data, in `compute_dtype`."""
    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.train.loop import Trainer

    preset = get_config("flyingchairs")
    cfg = preset.replace(
        data=dataclasses.replace(preset.data, dataset="synthetic",
                                 gt_size=preset.data.image_size),
        train=dataclasses.replace(
            preset.train, compute_dtype=compute_dtype,
            log_dir=os.path.join(work, f"inception{DTYPES[compute_dtype]}")))
    return Trainer(cfg, device="cuda")


def plain_warp_comparison(trainer, batch, **kw) -> dict:
    """One forward and backward of `trainer`'s model on `batch` in its
    compute dtype, cuDNN deterministic, with the warp kernels (`kernel`:
    each launched once), twice with the kernels' plain versions (`plain`,
    `plain_again`: `backward_warp_reference` and
    `warp_flow_grad_reference`, no kernel launched) and once with
    autograd of the plain forward as the flow gradient
    (`plain_autograd`, the `train` phase's plain step): the loss's
    relative difference and the largest difference of one parameter's
    gradient over that tensor's largest entry, kernel vs plain, plain vs
    plain (the step's own spread) and autograd vs plain. `kw` (an action
    model's `dropout` masks, `smooth_border_mask`) goes to each run."""
    import torch

    from deepof_tpu_torch.train.step import compute_dtype

    args = (trainer.model, batch, trainer.dataset.mean, trainer.cfg.loss,
            compute_dtype(trainer.cfg))
    names = [n for n, _ in trainer.model.named_parameters()]
    runs, launched = {}, {}

    def plain(*a, **k):
        return plain_warp_loss_and_grads(*a, flow_grad="reference", **k)

    torch.backends.cudnn.deterministic = True
    try:
        for name, fn in (("kernel", loss_and_grads), ("plain", plain),
                         ("plain_again", plain),
                         ("plain_autograd", plain_warp_loss_and_grads)):
            before = warp_counts()
            runs[name] = fn(*args, **kw)
            launched[name] = [a - b for a, b in zip(warp_counts(), before)]
    finally:
        torch.backends.cudnn.deterministic = False
    if launched != {"kernel": [1, 1], "plain": [0, 0],
                    "plain_again": [0, 0], "plain_autograd": [0, 0]}:
        raise AssertionError(f"warp kernel launches {launched} in the "
                             "kernel and plain-warp steps")

    def compare(a, b):
        (la, ga), (lb, gb) = runs[a], runs[b]
        rel = [((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
               .item() for x, y in zip(ga, gb)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        return {"loss_rel": abs(la - lb) / abs(lb),
                "grad_max_rel": rel[worst], "grad_max_rel_at": names[worst]}

    return {"loss": runs["kernel"][0],
            "kernel_vs_plain_warp": compare("kernel", "plain"),
            "plain_repeat": compare("plain_again", "plain"),
            "autograd_flow_grad_vs_plain": compare("plain_autograd",
                                                   "plain")}


def inception_vs_plain(work: str) -> dict:
    """`inception_step_vs_plain` in float32 and in bf16 compute, a phase
    of its own (nothing in it is timed: main runs it while
    serve_autoscale's first replica boots)."""
    row = {d: inception_step_vs_plain(work, d) for d in DTYPES}
    emit("inception_vs_plain", **row)
    return row


def inception_step_vs_plain(work: str, compute_dtype: str) -> dict:
    """A full-width Inception-v3 training step (`inception_trainer`) with
    the warp kernels against the same step with the kernels' plain
    versions, after one warm-up step: loss equal, each gradient within
    TRAIN_GRAD_RTOL of its largest entry (`plain_warp_comparison`). The
    step with autograd of the plain forward as the flow gradient is
    reported beside it; in float32 it is held to the same limit, as the
    `train` phase holds it. In bf16 compute it is not: its flow gradient
    differs from the reference's in the last float32 bit, and the bf16
    backward rounds that to whole bf16 steps (a CPU run of a thin model
    measured 7e-3 of a tensor's largest entry)."""
    from deepof_tpu_torch.train.step import batch_to_device

    trainer = inception_trainer(work, compute_dtype)
    first = steps_in_sequence(trainer, 1)[0]
    batch = batch_to_device(next(draw_batches(trainer, 1))[0],
                            trainer.device)
    row = {"compute_dtype": compute_dtype,
           "params": sum(p.numel() for p in trainer.model.parameters()),
           "first_step_loss": first["total"],
           **plain_warp_comparison(trainer, batch)}
    pairs = ["kernel_vs_plain_warp", "plain_repeat"]
    if compute_dtype == "float32":
        pairs.append("autograd_flow_grad_vs_plain")
    for pair in pairs:
        gap = row[pair]
        if not (gap["loss_rel"] == 0
                and gap["grad_max_rel"] <= TRAIN_GRAD_RTOL):
            raise AssertionError(
                f"inception {compute_dtype} train step, {pair}: {gap} "
                f"(limits: loss equal, each gradient {TRAIN_GRAD_RTOL} of "
                "its largest entry)")
    return row


def engine_in_fresh_process(work: str, log_dir: str, pair: list):
    """F17: a fresh process with PyTorch's TF32 defaults builds an
    InferenceEngine on the run's checkpoint (`ENGINE_SUBPROCESS`) and
    serves `pair`; its flow against `want`, `predict`'s on the same pair
    from the command line: within F17_RTOL of its largest entry, and at
    least 10x closer than the same request served with cuDNN's TF32 on
    (the rule's gate sees what it keeps out). Returns a function of
    `want` that waits for the process and gives the row (the caller runs
    untimed work meanwhile)."""
    import io

    import numpy as np

    from deepof_tpu_torch import cli

    cfg_path = os.path.join(work, "f17_config.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(["config", *CLI_INCEPTION, "--log-dir", log_dir]) != 0:
            raise AssertionError("cli config failed")
    with open(cfg_path, "w") as f:
        f.write(buf.getvalue())
    out = os.path.join(work, "f17_flow.npy")
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c", ENGINE_SUBPROCESS, cfg_path, *pair, out],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def result(want) -> dict:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        TIMELINE.append(["f17 engine process", round(t0 - START, 2),
                         round(time.monotonic() - t0, 2)])
        if proc.returncode != 0:
            raise AssertionError(f"F17 engine process failed: {stderr}")
        return f17_row(json.loads(stdout.strip().splitlines()[-1]), out,
                       want)

    return result


def f17_engine(work: str, inception: dict):
    """F17 on cli_train_inception's run (`inception`, its row): starts
    `engine_in_fresh_process` on the run's checkpoint and its first
    predicted pair and returns a function that waits for it, holds its
    flow against `predict`'s, emits its row and returns it (main starts
    it while serve_fleet's replicas boot and runs other untimed checks
    meanwhile)."""
    from deepof_tpu_torch.io.flo import read_flo

    want = read_flo(inception["predicted_flo"][0])
    result = engine_in_fresh_process(work, inception["log_dir"],
                                     inception["pairs"][0])

    def finish() -> dict:
        row = result(want)
        emit("f17_engine", **row)
        return row

    return finish


def f17_row(switches: dict, out: str, want) -> dict:
    import numpy as np

    got, tf32 = np.load(out)
    row = {**switches, "shape": list(got.shape),
           "bitwise_equal_to_predict": bool(np.array_equal(got, want)),
           "max_abs_diff": float(np.abs(got - want).max()),
           "tf32_max_abs_diff": float(np.abs(tf32 - want).max()),
           "predict_abs_max": float(np.abs(want).max())}
    if (switches["after"] != [False, False]
            or row["max_abs_diff"] > F17_RTOL * row["predict_abs_max"]
            or row["tf32_max_abs_diff"] <= 10 * row["max_abs_diff"]):
        raise AssertionError(f"F17: an engine built outside the command "
                             f"line: {row}")
    return row


def cli_train_inception(work: str) -> dict:
    """The paper's flagship model from the command line at full width:
    `train --preset flyingchairs --synthetic` for INCEPTION_STEPS steps at
    the preset's 320x448, batch 4 (Inception-v3, 44.55 M parameters;
    the fit's steps 3-5 under torch.profiler: step, device busy, idle
    share), then `eval` and `predict` on two .npy pairs from its
    checkpoint. Each path's warp launches
    are counted from 0: in `train` each kernel once per step and the
    forward once per eval forward, in `eval` the forward once per eval
    forward, in `predict` none. Then both warp kernels at the six
    Inception levels bit for bit against the plain versions, with their
    time, bound and grid_sample's (`check_warp_levels`). The row's
    `log_dir`, `pairs` and `predicted_flo` are what `f17_engine` checks
    F17 on."""
    import numpy as np

    from deepof_tpu_torch.io.flo import read_flo

    t0 = time.monotonic()
    log_dir = os.path.join(work, "cli_train_inception")
    reset_kernel_counts()
    summary, window = run_windowed(
        ["train", *CLI_INCEPTION, "--steps", str(INCEPTION_STEPS),
         "--log-dir", log_dir], os.path.join(work, "cli_train_inception.log"),
        INCEPTION_WINDOW)
    train = kernel_counts()
    records = check_run(log_dir, list(range(2, INCEPTION_STEPS + 1, 2)),
                        [INCEPTION_STEPS], [INCEPTION_STEPS])
    evals = eval_calls(SYNTHETIC_VAL, 4)
    rs = np.random.RandomState(4)
    pairs = []
    for i in range(2):
        paths = [os.path.join(work, f"inc_pair{i}_{k}.npy") for k in "ab"]
        for p in paths:
            np.save(p, rs.randint(0, 256, (320, 448, 3), np.uint8))
        pairs.append(paths)
    reset_kernel_counts()
    ev = run_cli(["eval", *CLI_INCEPTION, "--log-dir", log_dir],
                 os.path.join(work, "cli_eval_inception.log"))
    evaluate = kernel_counts()
    reset_kernel_counts()
    out = run_cli(["predict", *CLI_INCEPTION, "--log-dir", log_dir, "--out",
                   os.path.join(work, "flows_inception"), "--pairs",
                   *(":".join(p) for p in pairs)],
                  os.path.join(work, "cli_predict_inception.log"))
    predict = kernel_counts()
    predicted_flo = [p for p in out["written"] if p.endswith(".flo")]
    flows = [read_flo(p) for p in predicted_flo]
    levels = check_warp_levels(seed=40, levels=INCEPTION_LEVELS,
                               kernel="warp_levels_inception")
    row = {"model": "inception_v3", "steps": INCEPTION_STEPS,
           "image_size": [320, 448], "batch": 4,
           **fit_row(summary, 4), "profiled": window.row(4),
           "flops_per_step": [r.get("flops_per_step") for r in records
                              if r["kind"] == "info"
                              and "flops_per_step" in r],
           "launches": {"train": train, "eval": evaluate,
                        "predict": predict},
           "eval_forwards": evals,
           "losses": [r["loss"] for r in records if r["kind"] == "train"],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"],
           "eval_cli": {k: ev[k] for k in ("aee", "aae", "val_loss")},
           "predicted": [list(f.shape) for f in flows],
           "log_dir": log_dir, "pairs": pairs,
           "predicted_flo": predicted_flo,
           "warp_levels": {k: {q: levels[k][q] for q in (
               "bitwise_equal", "max_abs_err", "ms", "ms_runs", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "call_ms")}
               for k in ("fwd", "flow_grad")},
           "seconds": time.monotonic() - t0}
    emit("cli_train_inception", **row)
    want_train = want_counts(warp_fwd=INCEPTION_STEPS + evals,
                             warp_flow_grad=INCEPTION_STEPS)
    if train != want_train:
        raise AssertionError(f"cli train inception: launches {train}; want "
                             f"{want_train}")
    if evaluate != want_counts(warp_fwd=evals) or predict != want_counts():
        raise AssertionError(f"cli eval/predict inception: launches "
                             f"{evaluate} / {predict}")
    if not all(np.isfinite(ev[k]) for k in ("aee", "aae", "val_loss")):
        raise AssertionError(f"eval inception: non-finite metrics {ev}")
    if [f.shape for f in flows] != [(320, 448, 2)] * 2 or not all(
            np.isfinite(f).all() for f in flows):
        raise AssertionError(f"predict inception wrote "
                             f"{[f.shape for f in flows]}")
    return row


def cli_sintel_inception(work: str) -> dict:
    """`train --preset sintel` (Inception-v3 at full width, T = 10,
    224x480 crops of 256x512 frames, batch 4) for SINTEL_STEPS steps on
    the Sintel tree of `cli_sintel` (written here if absent), the fit's
    steps 2-4 under torch.profiler: the step, busy time and idle share,
    finite losses and AEE at 436x1024, each warp kernel once a step (the
    forward once more per eval forward); then both warp kernels at this
    volume's shapes bit for bit against the plain versions
    (`check_warp_volume` on Inception's flows)."""
    import numpy as np

    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.data.datasets import SintelData

    t0 = time.monotonic()
    data_dir = os.path.join(work, "sintel")
    if not os.path.isdir(data_dir):
        write_sintel(data_dir)
    preset = get_config("sintel")
    batch = preset.data.batch_size
    log_dir = os.path.join(work, "cli_sintel_inception")
    ds = SintelData(dataclasses.replace(preset.data, data_path=data_dir))
    reset_kernel_counts()
    summary, window = run_windowed(
        ["train", "--preset", "sintel", "--data-path", data_dir,
         "--log-dir", log_dir, "--max-steps", str(SINTEL_STEPS)],
        os.path.join(work, "cli_sintel_inception.log"), SINTEL_WINDOW)
    launches = kernel_counts()
    spe = ds.num_train // batch
    ends = list(range(spe, SINTEL_STEPS + 1, spe))
    records = check_run(log_dir, ends, ends, [SINTEL_STEPS])
    evals = len(ends) * eval_calls(ds.num_val, preset.train.eval_batch_size)
    volume = check_warp_volume(seed=42, model_name="inception_v3")
    row = {"model": preset.model, "time_step": preset.data.time_step,
           "crop": list(preset.data.crop_size), "batch": batch,
           "steps": SINTEL_STEPS, **fit_row(summary, batch),
           "profiled": window.row(batch),
           "warp_fwd_launches": launches["warp_fwd"],
           "warp_flow_grad_launches": launches["warp_flow_grad"],
           "eval_forwards": evals,
           "losses": [r["loss"] for r in records if r["kind"] == "train"],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"],
           "warp_volume": {
               "shape": [r["shape"] for r in volume["levels"]],
               **{k: {q: volume[k][q] for q in (
                   "bitwise_equal", "max_abs_err", "ms", "ms_runs",
                   "plain_ms", "library_ms", "bound_ms", "bound_by",
                   "call_ms")} for k in ("fwd", "flow_grad")}},
           "seconds": time.monotonic() - t0}
    emit("cli_sintel_inception", **row)
    if launches != want_counts(warp_fwd=SINTEL_STEPS + evals,
                               warp_flow_grad=SINTEL_STEPS):
        raise AssertionError(f"cli_sintel_inception: launches {launches} in "
                             f"{SINTEL_STEPS} steps and {evals} eval "
                             "forwards")
    if not np.isfinite(row["losses"] + [e["aee"] for e in row["evals"]]).all():
        raise AssertionError(f"cli_sintel_inception: {row['losses']} "
                             f"{row['evals']}")
    return row


def cli_bench(work: str) -> dict:
    """`python -m deepof_tpu_torch bench` at its defaults (the JAX
    headline: Inception-v3 at 320x448, batch 16, bf16 compute, 4 steps a
    call) through `cli.main`: its one JSON line, each warp kernel once a
    step it ran; then both warp kernels at the bench's six levels bit
    for bit against the plain versions (`check_warp_levels`)."""
    import numpy as np

    t0 = time.monotonic()
    reset_kernel_counts()
    line = run_cli(["bench"], os.path.join(work, "cli_bench.log"))
    launches = kernel_counts()
    levels = check_warp_levels(seed=43, levels=BENCH_LEVELS,
                               kernel="warp_levels_bench")
    row = {"line": line, "launches": launches,
           "warp_levels": {k: {q: levels[k][q] for q in (
               "bitwise_equal", "max_abs_err", "ms", "ms_runs", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "call_ms")}
               for k in ("fwd", "flow_grad")},
           "seconds": time.monotonic() - t0}
    emit("cli_bench", **row)
    keys = ("pairs_per_sec", "pairs_per_sec_per_chip", "n_chips", "batch",
            "steps_per_sec", "steps_per_call", "warp_impl", "matmul_tflops",
            "dev_mem_bytes_in_use", "dev_mem_peak_bytes", "flops_per_step",
            "model_tflops", "mfu_nominal")
    missing = [k for k in keys if k not in line]
    if missing or not np.isfinite(line["pairs_per_sec"]):
        raise AssertionError(f"bench line lacks {missing}: {line}")
    n = launches["warp_fwd"]
    if (n == 0 or n % line["steps_per_call"]
            or launches != want_counts(warp_fwd=n, warp_flow_grad=n)):
        raise AssertionError(f"bench: launches {launches}")
    return row


# (B, C, H, W) of the five loss levels of VGG16Flow at the
# flyingchairs_vgg preset's 320x448, batch 8: finest at H/2
VGG_LEVELS = [(8, 3, 160 >> k, 224 >> k) for k in range(5)]
# the augmentation's resample: source and target frames (2 levels of
# batch 8, raw 0-255, NHWC memory) under one flow, one launch
AUGMENT_SHAPE = (8, 3, 320, 448)
# `train --preset flyingchairs_vgg` on a FlyingChairs tree of VGG_PAIRS
# pairs (VGG_VAL val): 7 steps an epoch at batch 8, so VGG_STEPS steps
# stay in the first epoch; a train record every 2 steps, an eval (the
# VGG_VAL val pairs, one forward) and a checkpoint at the last step; the
# steps of the fit under torch.profiler (StepWindow) are 3-5
VGG_PAIRS, VGG_VAL = 60, 4
VGG_STEPS = 6
VGG_WINDOW = (2, 5)
VGG_OCC_STEPS = 2
CLI_VGG = ["--preset", "flyingchairs_vgg",
           "--set", "train.log_every=2",
           "--set", f"train.eval_every={VGG_STEPS}",
           "--set", f"train.ckpt_every_steps={VGG_STEPS}"]


def write_vgg16_npz(path: str, seed: int = 0) -> dict:
    """A random npz with the public `vgg16_weights.npz`'s names and
    shapes: conv{b}_{i}_W (3, 3, in, out) and _b for the 13 convs, and
    the fc layers (fc6_W (25088, 4096), fc7_W, fc8_W, their biases;
    zeros), which the loader skips. Returns the convs' arrays."""
    import numpy as np

    rs = np.random.RandomState(seed)
    arrays, cin = {}, 3
    for b, (feat, n) in enumerate(((64, 2), (128, 2), (256, 3), (512, 3),
                                   (512, 3)), start=1):
        for i in range(1, n + 1):
            arrays[f"conv{b}_{i}_W"] = (rs.randn(3, 3, cin, feat)
                                        * np.sqrt(2.0 / (9 * cin))
                                        ).astype(np.float32)
            arrays[f"conv{b}_{i}_b"] = (rs.randn(feat) * 0.01).astype(
                np.float32)
            cin = feat
    fc = {"fc6_W": (25088, 4096), "fc6_b": (4096,), "fc7_W": (4096, 4096),
          "fc7_b": (4096,), "fc8_W": (4096, 1000), "fc8_b": (1000,)}
    np.savez(path, **arrays,
             **{k: np.zeros(v, np.float32) for k, v in fc.items()})
    return arrays


def warp_fwd_row(kernel, images, flows, bound, lib_images=None):
    """A forward-only set of levels (NCHW views) through one launch of the
    forward kernel (`site`-free: the caller's counters are reset around
    the path, not here): each level bit for bit its plain version; the
    launch's device time (WARP_ROUNDS readings of WARP_ITERS calls), in
    turns with one grid_sample call a level; the plain version's time;
    one call on the host clock; and `bound` = (ms, "bytes" or
    "operations")."""
    import torch
    import torch.nn.functional as F

    from deepof_tpu_torch.ops.cuda.warp import warp_fwd_levels_cuda
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    outs = warp_fwd_levels_cuda(images, flows)
    levels = []
    for img, fl, out in zip(images, flows, outs):
        want = backward_warp_reference(img, fl)
        levels.append({"shape": list(img.shape),
                       "bitwise_equal": bool(torch.equal(out, want)),
                       "max_abs_err": (out - want).abs().max().item(),
                       "flow_abs_max": fl.abs().max().item()})
    grids = [grid_sample_grid(fl)[0].detach() for fl in flows]

    def fwd():
        return warp_fwd_levels_cuda(images, flows)

    def plain():
        return [backward_warp_reference(i, f) for i, f in zip(images, flows)]

    def library():
        return [F.grid_sample(i, gr, mode="bilinear", padding_mode="border",
                              align_corners=True)
                for i, gr in zip(images, grids)]

    runs = {"fwd": [], "library": []}
    for _ in range(WARP_ROUNDS):
        runs["fwd"].append(device_ms(fwd, WARP_ITERS))
        runs["library"].append(device_ms(library, WARP_ITERS))
    row = {"levels": levels,
           "bitwise_equal": all(r["bitwise_equal"] for r in levels),
           "max_abs_err": max(r["max_abs_err"] for r in levels),
           "ms": statistics.median(runs["fwd"]), "ms_runs": runs["fwd"],
           "library_ms": statistics.median(runs["library"]),
           "library_ms_runs": runs["library"],
           "plain_ms": device_ms(plain), "call_ms": time_ms(fwd),
           "bound_ms": bound[0], "bound_by": bound[1],
           "library": f"{len(images)} F.grid_sample(bilinear, border, "
                      "align_corners=True) calls",
           "plain": "backward_warp_reference level by level"}
    emit("kernels", kernel=kernel, **row)
    if not row["bitwise_equal"]:
        raise AssertionError(f"{kernel}: the forward warp launch disagrees "
                             f"with the plain version: {levels}")
    return row


def check_warp_augment(seed=50):
    """The augmentation's resample at the flyingchairs_vgg preset's shape:
    source and target (AUGMENT_SHAPE, raw 0-255 NHWC memory as the
    prefetcher stages them) as two levels of one launch under the flow of
    parameters drawn by `sample_geo_params` on the card, with sample 0's
    scale set to the range's 2.0, sample 1 flipped and sample 2 at the
    full 17 degrees: flows of hundreds of pixels, much of them clipped at
    the border. Bit for bit the plain version (`warp_fwd_row`); the bound
    counts the shared flow once. Also `apply_geo` itself, once, against
    the plain version."""
    import math as _math

    import torch

    from deepof_tpu_torch.data import augmentation as aug
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    b, c, h, w = AUGMENT_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = [torch.rand((b, h, w, c), device="cuda", generator=g) * 255
              for _ in range(2)]
    params = aug.sample_geo_params(aug.generator(seed, 0, "cuda"), b)
    params["scale"][0] = aug.SCALE_RANGE[1]
    params["flip"][1] = True
    params["angle"][2] = _math.radians(aug.ROTATION_DEG)
    flow = aug.geo_flow(params, h, w).permute(0, 3, 1, 2)
    px = b * h * w
    nbytes = 4.0 * px * (2 * 2 * c + 2)  # 2 images + 2 outputs, 1 flow
    flops = 2.0 * px * (6 + 11 * c)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    bound = (1e3 * max(t_ops, t_bytes),
             "operations" if t_ops >= t_bytes else "bytes")
    row = warp_fwd_row("warp_augment", [f.permute(0, 3, 1, 2)
                                        for f in frames], [flow, flow],
                       bound)
    got = aug.apply_geo(frames, params)
    same = all(torch.equal(o.permute(0, 3, 1, 2), backward_warp_reference(
        f.permute(0, 3, 1, 2), flow)) for o, f in zip(got, frames))
    row.update(params={k: v.tolist() for k, v in params.items()},
               apply_geo_bitwise_equal=same,
               clipped_share=float(
                   ((flow[:, 0] + torch.arange(w, device="cuda") < 0)
                    | (flow[:, 0] + torch.arange(w, device="cuda") > w - 1)
                    | (flow[:, 1] + torch.arange(h, device="cuda")[:, None]
                       < 0)
                    | (flow[:, 1] + torch.arange(h, device="cuda")[:, None]
                       > h - 1)).float().mean()))
    if not same:
        raise AssertionError("apply_geo on the card disagrees with the "
                             "plain warp")
    return row


def check_warp_occlusion(mag=5.0, seed=51):
    """The occlusion mask's warp at VGG's five levels (VGG_LEVELS, batch
    8): the backward flows (C = 2, the generic `kC = 0` instance of
    `csrc/warp.cu`) warped by the forward flows, both NHWC memory as the
    loss holds them, one launch; bit for bit the plain version
    (`warp_fwd_row`)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    images, flows, shapes = [], [], []
    for b, _, h, w in VGG_LEVELS:
        images.append((torch.randn((b, h, w, 2), device="cuda", generator=g)
                       * mag).permute(0, 3, 1, 2))
        flows.append((torch.randn((b, h, w, 2), device="cuda", generator=g)
                      * mag).permute(0, 3, 1, 2))
        shapes.append((b, 2, h, w))
    return warp_fwd_row("warp_occlusion", images, flows,
                        warp_bound_ms(shapes, grad=False))


def vgg_trainer(work: str):
    """A full-width VGG16Flow Trainer on the card with the
    flyingchairs_vgg preset's loss and geometry (320x448, batch 8) on
    synthetic data."""
    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.train.loop import Trainer

    preset = get_config("flyingchairs_vgg")
    cfg = preset.replace(
        data=dataclasses.replace(preset.data, dataset="synthetic",
                                 gt_size=preset.data.image_size),
        train=dataclasses.replace(preset.train,
                                  log_dir=os.path.join(work, "vgg_step")))
    return Trainer(cfg, device="cuda")


def vgg_step_vs_plain(work: str) -> dict:
    """A full-width VGG16Flow training step on an augmented batch (the
    port's augmentation on the card, from the loop's seed draw) with the
    warp kernels against the same step with the kernels' plain versions,
    after one warm-up step: loss equal, each gradient within
    TRAIN_GRAD_RTOL of its largest entry (`plain_warp_comparison`). A
    phase of its own, nothing in it timed: main runs it while
    serve_fleet's replicas boot."""
    import numpy as np

    from deepof_tpu_torch.data.augmentation import augment_batch
    from deepof_tpu_torch.train.step import batch_to_device

    trainer = vgg_trainer(work)
    first = steps_in_sequence(trainer, 1)[0]
    host = next(draw_batches(trainer, 1))[0]
    batch = augment_batch(batch_to_device(host, trainer.device),
                          np.random.RandomState(0).randint(0, 2 ** 31))
    row = {"params": sum(p.numel() for p in trainer.model.parameters()),
           "first_step_loss": first["total"],
           "batch_keys": sorted(batch),
           **plain_warp_comparison(trainer, batch)}
    emit("vgg_step_vs_plain", **row)
    for pair in ("kernel_vs_plain_warp", "plain_repeat",
                 "autograd_flow_grad_vs_plain"):
        gap = row[pair]
        if not (gap["loss_rel"] == 0
                and gap["grad_max_rel"] <= TRAIN_GRAD_RTOL):
            raise AssertionError(
                f"vgg16 train step, {pair}: {gap} (limits: loss equal, "
                f"each gradient {TRAIN_GRAD_RTOL} of its largest entry)")
    return row


def cli_train_vgg(work: str) -> dict:
    """The paper's VGG16 flow model from the command line at full width:
    `train --preset flyingchairs_vgg` on a FlyingChairs tree of VGG_PAIRS
    pairs (320x448, batch 8, f32; geometric and photometric augmentation
    on the card; depthwise smoothness; the trunk from a random npz of the
    public file's names and shapes) for VGG_STEPS steps, the fit's steps
    3-5 under torch.profiler; then `eval` and `predict` of that run, and
    a VGG_OCC_STEPS-step run with `loss.occlusion=true`. Checked: the
    trunk in the step-0 checkpoint equals the npz (conv1_1 tiled twice),
    each path's launches counted from 0 (in `train` the loss forward once
    a step and once an eval forward, the flow gradient once a step, the
    augmentation once a staged batch: one a step, and at most
    data.prefetch + 1 staged ahead; `eval` the forward once an eval
    forward; `predict` none; the occlusion run's occlusion warp once a
    step), finite losses and AEE. Then the augmentation's warp, the
    warps at VGG's five levels and the occlusion warp bit for bit against
    the plain versions (one step with the kernels against the plain
    warps is the `vgg_step_vs_plain` phase)."""
    import numpy as np
    import torch

    from deepof_tpu_torch.io.flo import read_flo
    from deepof_tpu_torch.train.checkpoint import CheckpointManager

    t0 = time.monotonic()
    data_dir = os.path.join(work, "chairs_vgg")
    write_chairs(data_dir, seed=7, pairs=VGG_PAIRS, val=VGG_VAL)
    npz = os.path.join(work, "vgg16_weights.npz")
    trunk = write_vgg16_npz(npz)
    log_dir = os.path.join(work, "cli_train_vgg")
    argv = [*CLI_VGG, "--data-path", data_dir]
    setup_s = time.monotonic() - t0
    reset_kernel_counts()
    summary, window = run_windowed(
        ["train", *argv, "--set", f"train.vgg16_npz={npz}",
         "--steps", str(VGG_STEPS), "--log-dir", log_dir],
        os.path.join(work, "cli_train_vgg.log"), VGG_WINDOW)
    train = kernel_counts()
    records = check_run(log_dir, list(range(2, VGG_STEPS + 1, 2)),
                        [VGG_STEPS], [VGG_STEPS])
    init = CheckpointManager(os.path.join(log_dir, "ckpt"),
                             create=False)._load(0, "cpu")["model"]
    trunk_equal = {}
    for k in trunk:
        if not k.endswith("_W"):
            continue
        name = k[:-2]
        w = torch.from_numpy(trunk[k].transpose(3, 2, 0, 1))
        if name == "conv1_1":
            w = torch.cat([w, w], dim=1)
        trunk_equal[name] = bool(
            torch.equal(init[f"encoder.{name}.conv.weight"], w)
            and torch.equal(init[f"encoder.{name}.conv.bias"],
                            torch.from_numpy(trunk[name + "_b"])))
    init_logged = any("VGG16 trunk init from" in r.get("message", "")
                      for r in records if r["kind"] == "info")
    evals = eval_calls(VGG_VAL, 8)
    reset_kernel_counts()
    ev = run_cli(["eval", *argv, "--log-dir", log_dir],
                 os.path.join(work, "cli_eval_vgg.log"))
    evaluate = kernel_counts()
    rs = np.random.RandomState(5)
    pairs = []
    for i in range(2):
        paths = [os.path.join(work, f"vgg_pair{i}_{k}.npy") for k in "ab"]
        for p in paths:
            np.save(p, rs.randint(0, 256, (384, 512, 3), np.uint8))
        pairs.append(paths)
    reset_kernel_counts()
    out = run_cli(["predict", *argv, "--log-dir", log_dir, "--out",
                   os.path.join(work, "flows_vgg"), "--pairs",
                   *(":".join(p) for p in pairs)],
                  os.path.join(work, "cli_predict_vgg.log"))
    predict = kernel_counts()
    flows = [read_flo(p) for p in out["written"] if p.endswith(".flo")]
    occ_dir = os.path.join(work, "cli_train_vgg_occlusion")
    reset_kernel_counts()
    occ_summary = run_cli(["train", *argv, "--set", "loss.occlusion=true",
                           "--steps", str(VGG_OCC_STEPS), "--log-dir",
                           occ_dir],
                          os.path.join(work, "cli_train_vgg_occ.log"))
    occlusion = kernel_counts()
    occ_records = read_records(occ_dir)
    augment = check_warp_augment()
    levels = check_warp_levels(seed=52, levels=VGG_LEVELS,
                               kernel="warp_levels_vgg")
    occ = check_warp_occlusion()
    train_records = [r for r in records if r["kind"] == "train"]
    row = {"model": "vgg16", "steps": VGG_STEPS, "image_size": [320, 448],
           "batch": 8, "pairs": VGG_PAIRS, "setup_s": setup_s,
           **fit_row(summary, 8), "profiled": window.row(8),
           "augment_ms_median": summary.get("phase_augment_ms_median"),
           "flops_per_step": [r.get("flops_per_step") for r in records
                              if r["kind"] == "info"
                              and "flops_per_step" in r],
           "model_tflops": [r.get("model_tflops") for r in train_records],
           "dev_mem_peak_bytes": max(r.get("dev_mem_peak_bytes") or 0
                                     for r in train_records),
           "trunk_init_equal": trunk_equal, "trunk_init_logged": init_logged,
           "launches": {"train": train, "eval": evaluate,
                        "predict": predict, "train_occlusion": occlusion},
           "eval_forwards": evals,
           "losses": [r["loss"] for r in train_records],
           "evals": [{k: r[k] for k in ("step", "aee", "aae", "val_loss")}
                     for r in records if r["kind"] == "eval"],
           "eval_cli": {k: ev[k] for k in ("aee", "aae", "val_loss")},
           "predicted": [list(f.shape) for f in flows],
           "occlusion_losses": [r["loss"] for r in occ_records
                                if r["kind"] == "train"],
           "occlusion_step_ms_median": occ_summary["step_ms_median"],
           "warp_augment": {q: augment[q] for q in (
               "bitwise_equal", "max_abs_err", "ms", "ms_runs", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "call_ms",
               "apply_geo_bitwise_equal", "clipped_share")},
           "warp_levels": {k: {q: levels[k][q] for q in (
               "bitwise_equal", "max_abs_err", "ms", "ms_runs", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "call_ms")}
               for k in ("fwd", "flow_grad")},
           "warp_occlusion": {q: occ[q] for q in (
               "bitwise_equal", "max_abs_err", "ms", "ms_runs", "plain_ms",
               "library_ms", "bound_ms", "bound_by", "call_ms")},
           "seconds": time.monotonic() - t0}
    emit("cli_train_vgg", **row)
    n_aug = train["warp_fwd_augment"]
    prefetch = 2  # the preset's data.prefetch
    want = want_counts(warp_fwd=VGG_STEPS + evals,
                       warp_flow_grad=VGG_STEPS, warp_fwd_augment=n_aug)
    if train != want or not VGG_STEPS <= n_aug <= VGG_STEPS + prefetch + 1:
        raise AssertionError(f"cli train vgg: launches {train}; want {want} "
                             f"with {VGG_STEPS}-{VGG_STEPS + prefetch + 1} "
                             "augmentation launches")
    if evaluate != want_counts(warp_fwd=evals) or predict != want_counts():
        raise AssertionError(f"cli eval/predict vgg: launches {evaluate} / "
                             f"{predict}")
    n_occ_aug = occlusion["warp_fwd_augment"]
    if occlusion != want_counts(
            warp_fwd=VGG_OCC_STEPS, warp_flow_grad=VGG_OCC_STEPS,
            warp_fwd_occlusion=VGG_OCC_STEPS, warp_fwd_augment=n_occ_aug):
        raise AssertionError(f"cli train vgg occlusion: launches "
                             f"{occlusion}")
    if not (all(trunk_equal.values()) and len(trunk_equal) == 13
            and init_logged):
        raise AssertionError(f"vgg16_npz init: {trunk_equal}, logged "
                             f"{init_logged}")
    if not all(np.isfinite(ev[k]) for k in ("aee", "aae", "val_loss")):
        raise AssertionError(f"eval vgg: non-finite metrics {ev}")
    if not np.isfinite(row["occlusion_losses"]).all() or len(
            row["occlusion_losses"]) != 1:
        raise AssertionError(f"occlusion run: {row['occlusion_losses']}")
    if [f.shape for f in flows] != [(384, 512, 2)] * 2 or not all(
            np.isfinite(f).all() for f in flows):
        raise AssertionError(f"predict vgg wrote "
                             f"{[f.shape for f in flows]}")
    return row


# (B, C, H, W) of the loss levels at the ucf101 preset's 320x384, batch
# 8: st_single's five VGG levels and st_baseline's six FlowNet-S levels,
# finest at H/2
UCF_LEVELS = [(8, 3, 160 >> k, 192 >> k) for k in range(5)]
UCF_BASELINE_LEVELS = [(8, 3, 160 >> k, 192 >> k) for k in range(6)]
# `train --preset ucf101` on a UCF-101 tree of UCF_CLASSES classes, each
# UCF_TRAIN_CLIPS train clips and one val clip of 3 frames at 240x320: 7
# steps an epoch at batch 8, so UCF_STEPS steps stay in the first epoch;
# a train record every 2 steps, an eval (a batch a class) at the last
# step; one checkpoint, the final one (nan_guard off: no step-0 save);
# the fit's steps 3-5 under torch.profiler
UCF_CLASSES, UCF_TRAIN_CLIPS = 8, 7
UCF_STEPS = 6
UCF_WINDOW = (2, 5)
CLI_UCF = ["--preset", "ucf101",
           "--set", "train.log_every=2",
           "--set", f"train.eval_every={UCF_STEPS}",
           "--set", "train.ckpt_every_steps=0",
           "--set", "train.nan_guard=false"]


def ucf101_trainer(work: str, model: str = "st_single"):
    """A full-width action-model Trainer on the card with the ucf101
    preset's loss and geometry (320x384, batch 8) on synthetic data (its
    labels are classes too)."""
    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.train.loop import Trainer

    preset = get_config("ucf101")
    cfg = preset.replace(
        model=model,
        data=dataclasses.replace(preset.data, dataset="synthetic"),
        train=dataclasses.replace(preset.train,
                                  log_dir=os.path.join(work, "ucf_step")))
    return Trainer(cfg, device="cuda")


def ucf101_step_vs_plain(work: str) -> dict:
    """A full-width st_single training step (the loop's dropout masks of
    step 1 drawn on the card, the smoothness border mask on) with the warp
    kernels against the same step with the kernels' plain versions, after
    one warm-up step: the loss equal and each gradient no further from
    the plain step's than the plain step is from its own repeat
    (`plain_warp_comparison`, cuDNN deterministic; the kernels give the
    plain versions' bits). Also the masks: drawn twice from (seed, step)
    on the card, the same bits; and not the CPU generator's (F19). A
    phase of its own, nothing in it timed: main runs it while cli_serve's
    server boots."""
    import torch

    from deepof_tpu_torch.models.two_stream import dropout_masks
    from deepof_tpu_torch.train.step import batch_to_device

    trainer = ucf101_trainer(work)
    first = steps_in_sequence(trainer, 1)[0]
    host = next(draw_batches(trainer, 1))[0]
    batch = batch_to_device(host, trainer.device)
    seed, b = trainer.cfg.train.seed, trainer.cfg.data.batch_size
    masks = dropout_masks(b, seed, 1, trainer.device)
    again = dropout_masks(b, seed, 1, trainer.device)
    cpu = dropout_masks(b, seed, 1, "cpu")
    row = {"params": sum(p.numel() for p in trainer.model.parameters()),
           "first_step_loss": first["total"],
           "first_step_action_loss": first["action_loss"],
           "batch_keys": sorted(batch),
           "masks_repeat_equal": all(torch.equal(x, y)
                                     for x, y in zip(masks, again)),
           "masks_equal_cpu_generator": all(
               torch.equal(x.cpu(), y) for x, y in zip(masks, cpu)),
           "keep_share": torch.stack(masks).float().mean().item(),
           **plain_warp_comparison(trainer, batch, dropout=masks,
                                   smooth_border_mask=True)}
    emit("ucf101_step_vs_plain", **row)
    gap, spread = row["kernel_vs_plain_warp"], row["plain_repeat"]
    if not (gap["loss_rel"] == 0 and spread["loss_rel"] == 0
            and gap["grad_max_rel"] <= spread["grad_max_rel"]
            <= TRAIN_GRAD_RTOL):
        raise AssertionError(
            f"st_single train step: kernel vs plain {gap}, plain repeat "
            f"{spread} (limits: losses equal, the kernel step no further "
            "from the plain one than the plain step's own repeat)")
    if not row["masks_repeat_equal"]:
        raise AssertionError("dropout masks drawn twice from one (seed, "
                             "step) on the card differ")
    return row


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def cli_train_ucf101(work: str) -> dict:
    """The UCF-101 two-stream action models from the command line at full
    width (320x384, batch 8, 101 classes, f32): `train --preset ucf101`
    (st_single, the trunk from a random npz of the public file's names
    and shapes) on a PPM tree with UCF-101's layout for UCF_STEPS steps,
    the fit's steps 3-5 under torch.profiler, one checkpoint (its bytes,
    its save's and its verification's seconds); `eval` (the accuracy,
    one batch a class) and `predict --action` of that run; one step each
    of `--model st_baseline` and `--model ucf101_spatial`; and `bench
    --data-only --dataset ucf101` on the tree. Checked: each path's warp
    launches counted from 0 (train: the loss forward once a step and
    once an eval forward, the flow gradient once a step; eval the
    forward once an eval forward; predict none; st_baseline one of each
    for its six levels; ucf101_spatial none), finite losses, action
    losses and accuracies, actions.json's rows. Then the warps at the
    five and six levels of the two-stream models bit for bit against the
    plain versions (one st_single step with the kernels against the
    plain warps is the `ucf101_step_vs_plain` phase)."""
    import json as _json

    import numpy as np

    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.resilience.verify import verify_run

    t0 = time.monotonic()
    data_dir = os.path.join(work, "ucf101")
    write_ucf101(data_dir, classes=UCF_CLASSES, seed=11,
                 train_clips=UCF_TRAIN_CLIPS)
    npz = os.path.join(work, "vgg16_weights.npz")
    if not os.path.exists(npz):
        write_vgg16_npz(npz)
    log_dir = os.path.join(work, "cli_train_ucf101")
    argv = [*CLI_UCF, "--data-path", data_dir]
    setup_s = time.monotonic() - t0
    reset_kernel_counts()
    summary, window = run_windowed(
        ["train", *argv, "--set", f"train.vgg16_npz={npz}",
         "--steps", str(UCF_STEPS), "--log-dir", log_dir],
        os.path.join(work, "cli_train_ucf101.log"), UCF_WINDOW)
    train = kernel_counts()
    records = read_records(log_dir)
    train_records = [r for r in records if r["kind"] == "train"]
    eval_records = [r for r in records if r["kind"] == "eval"]
    t1 = time.monotonic()
    report = verify_run(log_dir)
    verify_s = time.monotonic() - t1
    ckpt_bytes = dir_bytes(os.path.join(log_dir, "ckpt"))
    evals = min(UCF_CLASSES, 101)  # a batch a class
    reset_kernel_counts()
    ev = run_cli(["eval", *argv, "--log-dir", log_dir],
                 os.path.join(work, "cli_eval_ucf101.log"))
    evaluate = kernel_counts()
    names = os.path.join(work, "ucf101_classes.txt")
    with open(names, "w") as f:
        f.write("\n".join(sorted(UCF101_CLASSES[:UCF_CLASSES])) + "\n")
    pairs = []
    for cls in sorted(UCF101_CLASSES[:UCF_CLASSES])[:2]:
        clip = os.path.join(data_dir, "frames", cls, f"v_{cls}_g01_c01")
        pairs.append(f"{clip}/frame_0001.ppm:{clip}/frame_0002.ppm")
    out_dir = os.path.join(work, "actions_ucf101")
    reset_kernel_counts()
    t1 = time.monotonic()
    pred = run_cli(["predict", *argv, "--log-dir", log_dir, "--action",
                    "--labels", names, "--out", out_dir, "--pairs", *pairs],
                   os.path.join(work, "cli_predict_ucf101.log"))
    predict_s = time.monotonic() - t1
    predict = kernel_counts()
    with open(os.path.join(out_dir, "actions.json")) as f:
        actions = _json.load(f)
    others, other_launches = {}, {}
    for model in ("st_baseline", "ucf101_spatial"):
        run = os.path.join(work, f"cli_train_{model}")
        reset_kernel_counts()
        t1 = time.monotonic()
        sm = run_cli(["train", *argv, "--model", model, "--steps", "1",
                      "--set", "train.log_every=1", "--set",
                      "train.eval_every=0", "--log-dir", run],
                     os.path.join(work, f"cli_train_{model}.log"))
        other_launches[model] = kernel_counts()
        (rec,) = [r for r in read_records(run) if r["kind"] == "train"]
        others[model] = {
            "seconds": time.monotonic() - t1,
            "first_step_s": [float(r["message"].split()[-1][:-1])
                             for r in read_records(run)
                             if r.get("message", "").startswith(
                                 "first step")],
            "loss": rec["loss"], "action_loss": rec["action_loss"],
            "accuracy": rec.get("accuracy"),
            "dev_mem_peak_bytes": rec.get("dev_mem_peak_bytes"),
            "ckpt_save_s_total": sm["ckpt_save_s_total"],
            "ckpt_bytes": dir_bytes(os.path.join(run, "ckpt"))}
        shutil.rmtree(run, ignore_errors=True)
    reset_kernel_counts()
    bench_line = run_cli(["bench", "--data-only", "--dataset", "ucf101",
                          "--data-path", data_dir, "--batch", "8",
                          "--batches", "16", "--image-size", "320x384",
                          "--workers", "2"],
                         os.path.join(work, "cli_bench_ucf101.log"))
    bench_launches = kernel_counts()
    levels = check_warp_levels(seed=53, levels=UCF_LEVELS,
                               kernel="warp_levels_ucf101")
    base_levels = check_warp_levels(seed=54, levels=UCF_BASELINE_LEVELS,
                                    kernel="warp_levels_ucf101_baseline")
    preset = get_config("ucf101")

    def warp_q(r):
        return {k: {q: r[k][q] for q in (
            "bitwise_equal", "max_abs_err", "ms", "ms_runs", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "call_ms")}
            for k in ("fwd", "flow_grad")}

    row = {"model": "st_single", "steps": UCF_STEPS,
           "image_size": list(preset.data.image_size),
           "batch": preset.data.batch_size, "classes": UCF_CLASSES,
           "train_clips": UCF_CLASSES * UCF_TRAIN_CLIPS,
           "setup_s": setup_s, **fit_row(summary, 8),
           "profiled": window.row(8),
           "flops_per_step": [r.get("flops_per_step") for r in records
                              if r["kind"] == "info"
                              and "flops_per_step" in r],
           "model_tflops": [r.get("model_tflops") for r in train_records],
           "dev_mem_peak_bytes": max(r.get("dev_mem_peak_bytes") or 0
                                     for r in train_records),
           "trunk_init_logged": any(
               "VGG16 trunk init from" in r.get("message", "")
               for r in records if r["kind"] == "info"),
           "ckpt_bytes": ckpt_bytes, "ckpt_verify_s": verify_s,
           "ckpt_valid_steps": report["valid_steps"],
           "launches": {"train": train, "eval": evaluate,
                        "predict": predict, **{f"train_{m}": n for m, n in
                                               other_launches.items()},
                        "bench": bench_launches},
           "eval_forwards": evals,
           "losses": [r["loss"] for r in train_records],
           "action_losses": [r["action_loss"] for r in train_records],
           "accuracies": [r["accuracy"] for r in train_records],
           "evals": [{k: r[k] for k in ("step", "accuracy", "val_loss")}
                     for r in eval_records],
           "eval_cli": ev, "predict_s": predict_s,
           "actions": [{k: a[k] for k in ("class", "label", "prob")
                        if k in a} for a in actions],
           "other_models": others,
           "bench_data": {k: bench_line[k] for k in (
               "value", "unit", "mb_per_sec", "bytes_per_batch",
               "worker_util", "decode_cache_hits", "decode_cache_misses")},
           "warp_levels": warp_q(levels),
           "warp_levels_baseline": warp_q(base_levels),
           "seconds": time.monotonic() - t0}
    emit("cli_train_ucf101", **row)
    want = want_counts(warp_fwd=UCF_STEPS + evals, warp_flow_grad=UCF_STEPS)
    if train != want:
        raise AssertionError(f"cli train ucf101: launches {train}; want "
                             f"{want}")
    if evaluate != want_counts(warp_fwd=evals) or predict != want_counts():
        raise AssertionError(f"cli eval/predict ucf101: launches {evaluate}"
                             f" / {predict}")
    if (other_launches["st_baseline"] != want_counts(warp_fwd=1,
                                                     warp_flow_grad=1)
            or other_launches["ucf101_spatial"] != want_counts()
            or bench_launches != want_counts()):
        raise AssertionError(f"st_baseline / ucf101_spatial / bench "
                             f"launches {other_launches} {bench_launches}")
    if [r["step"] for r in train_records] != list(range(2, UCF_STEPS + 1, 2)) \
            or [r["step"] for r in eval_records] != [UCF_STEPS]:
        raise AssertionError(f"records at {[r['step'] for r in records]}")
    values = (row["losses"] + row["action_losses"] + row["accuracies"]
              + [ev["accuracy"], ev["val_loss"]]
              + [o[k] for o in others.values()
                 for k in ("loss", "action_loss")])
    if not all(v is not None and np.isfinite(v) for v in values):
        raise AssertionError(f"non-finite ucf101 metrics: {values}")
    if not (report["ok"] and report["valid_steps"] == [UCF_STEPS]
            and row["ckpt_saves"] == 1 and row["trunk_init_logged"]):
        raise AssertionError(f"ucf101 checkpoint / init: {report}, saves "
                             f"{row['ckpt_saves']}")
    if len(actions) != 2 or not all(
            len(a["top"]) == 5 and a["class"] == a["top"][0]["class"]
            and ("label" in a) == (a["class"] < UCF_CLASSES)
            for a in actions):
        raise AssertionError(f"predict --action wrote {actions}")
    if bench_line["dataset"] != "ucf101" or not bench_line["value"] > 0:
        raise AssertionError(f"bench --data-only ucf101: {bench_line}")
    return row


# `train --recipe` (train/recipe.py) at full width: the paper's three
# trainers as the stages of one run on the fixture trees, from the
# flyingchairs preset (Inception-v3, 320x448, batch 4). Stage "chairs"
# mixes the FlyingChairs tree (0.75) with T = 2 windows of a Sintel tree
# at the Chairs size (0.25: synthetic pairs, the first choice, disagree
# with Chairs pairs in structure, which the build reports); stage
# "sintel" is the sintel preset's geometry (T = 10, 224x480 crops of
# 256x512, AEE at 436x1024) on the Sintel tree, advancing on the plateau
# of its evals with a step backstop; stage "ucf101" is st_single at
# 320x384, batch 8, on the UCF-101 tree. An eval every step (the plateau
# reads them), checkpoints only at a fit's end (nan_guard off: no step-0
# save of the 3.45 GB st_single state), the span trace (the step in
# `fit` is read off it: `fit_step_ms`).
RECIPE_STEPS = {"chairs": 4, "sintel": 4, "ucf101": 3}
RECIPE_CUT = 1  # the first run's --max-steps: it stops inside "chairs"
RECIPE_SINTEL_PAIRS = {"alley_1": 4, "bamboo_2": 8, "market_2": 4}
CLI_RECIPE = ["--preset", "flyingchairs", "--set", "train.log_every=1",
              "--set", "train.eval_every=1",
              "--set", "train.ckpt_every_steps=0",
              "--set", "train.nan_guard=false", "--trace"]


def recipe_stages(chairs_sintel: str, sintel: str, ucf101: str) -> dict:
    """The recipe JSON of `cli_recipe` (a RecipeConfig dict)."""
    return {"stages": [
        {"name": "chairs", "advance": "steps",
         "steps": RECIPE_STEPS["chairs"],
         "mixture": [{"dataset": "flyingchairs", "weight": 0.75},
                     {"dataset": "sintel", "weight": 0.25,
                      "data_path": chairs_sintel, "time_step": 2}]},
        {"name": "sintel", "advance": "plateau",
         "steps": RECIPE_STEPS["sintel"], "plateau_window": 3,
         "min_evals": 3, "time_step": 10, "image_size": [256, 512],
         "crop_size": [224, 480], "gt_size": [436, 1024],
         "loss_weights": [16, 8, 4, 4, 2, 1],
         "mixture": [{"dataset": "sintel", "weight": 1.0,
                      "data_path": sintel}]},
        {"name": "ucf101", "advance": "steps",
         "steps": RECIPE_STEPS["ucf101"], "model": "st_single",
         "image_size": [320, 384], "gt_size": [320, 384], "batch_size": 8,
         "loss_weights": [16, 8, 4, 2, 1], "learning_rate": 1.6e-4,
         "mixture": [{"dataset": "ucf101", "weight": 1.0,
                      "data_path": ucf101}]}]}


def run_verb(argv: list, log_path: str) -> tuple[int, dict]:
    """`cli.main(argv)` of a verb that reads a run (`tail`, `analyze`)
    with its standard output sent to `log_path`: (exit code, its JSON:
    `analyze`'s whole document, `tail`'s last line)."""
    from deepof_tpu_torch import cli

    with open(log_path, "w") as f, contextlib.redirect_stdout(f), \
            spanned(os.path.basename(log_path)):
        rc = cli.main(argv)
    with open(log_path) as f:
        text = f.read().strip()
    try:
        return rc, json.loads(text)
    except ValueError:
        return rc, json.loads(text.splitlines()[-1])


def fit_step_ms(log_dir: str) -> list[float]:
    """The host milliseconds from one train-step call to the next in the
    newest fit's span trace (`--trace`), less the eval and checkpoint
    spans between them; the first call's interval (it syncs, and
    PyTorch and cuDNN set up there) left out. It is the step in `fit`
    where every step evals: `StepTimer` leaves eval time out by pausing
    its clock, so it then times no step."""
    with open(os.path.join(log_dir, "trace.json")) as f:
        spans = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    calls = sorted((e for e in spans if e["name"] == "dispatch"),
                   key=lambda e: e["ts"])
    out = []
    for a, b in zip(calls[1:], calls[2:]):
        paused = sum(e["dur"] for e in spans if e["name"] in ("eval", "ckpt")
                     and a["ts"] <= e["ts"] < b["ts"])
        out.append((b["ts"] - a["ts"] - paused) / 1e3)
    return out


def eval_forwards(trainer) -> int:
    """The eval forwards of one `Trainer.evaluate` sweep: the AEE
    protocol's batches (`eval_calls`), or the accuracy protocol's
    (`evaluate_ucf101`: a batch a class of a dataset with classes, else
    its val split once)."""
    from deepof_tpu_torch.core.config import ACTION_MODELS

    ds, bs = trainer.dataset, trainer.cfg.train.eval_batch_size
    if trainer.cfg.model not in ACTION_MODELS:
        return eval_calls(ds.num_val, bs)
    if hasattr(ds, "val_clips"):
        return min(101, max(len(ds.val_clips), 1))
    return -(-max(ds.num_val, 1) // bs)


def cli_recipe(work: str, before_tail=None) -> dict:
    """`train --recipe` at full width (CLI_RECIPE, `recipe_stages`): a
    first run cut by `--max-steps RECIPE_CUT` inside stage "chairs", then
    the same command with a larger --max-steps, which lands in the stage
    the newest manifest names and goes on from its stage_start_step
    through "sintel" and "ucf101". Each stage's `fit` is wrapped to count
    the kernels' launches from 0 over it: the warp forward once a step
    and once an eval forward, its flow gradient once a step, nothing
    else. Per stage: start and end step, the advance cause, the grafted
    and re-initialised tensors, the step in `fit`, the checkpoint
    seconds. The prebuild (every stage's dataset, every library built
    and loaded before step 1) and 0 libraries built after it; `bench
    --data-only --recipe` on the first stage's mixture; `predict --action
    --ckpt-dir <log-dir>/ckpt-stage2` on one pair; `analyze` of the run
    (its recipe block, the eval curve across the stages) and `tail` rc
    0. The build-time refusal of a mixture whose members disagree
    (FlyingChairs with synthetic pairs) is recorded first. `before_tail()` runs before
    the untimed `predict` and verbs (main starts ddp_phases' first group
    there)."""
    import numpy as np

    from deepof_tpu_torch.core.config import (DataConfig, MixtureMemberConfig,
                                              StageConfig, get_config,
                                              recipe_from_dict)
    from deepof_tpu_torch.data.mixture import build_mixture
    from deepof_tpu_torch.ops.cuda import build
    from deepof_tpu_torch.train import loop, recipe

    t0 = time.monotonic()
    chairs = os.path.join(work, "chairs")
    if not os.path.isdir(chairs):
        write_chairs(chairs)
    sintel = os.path.join(work, "sintel")
    if not os.path.isdir(sintel):
        write_sintel(sintel)
    ucf = os.path.join(work, "ucf101")
    if not os.path.isdir(ucf):
        write_ucf101(ucf, classes=UCF_CLASSES, seed=11,
                     train_clips=UCF_TRAIN_CLIPS)
    chairs_sintel = os.path.join(work, "sintel_chairs_size")
    write_sintel(chairs_sintel, RECIPE_SINTEL_PAIRS, (384, 512), seed=12)
    preset = get_config("flyingchairs")
    try:
        build_mixture(dataclasses.replace(preset.data, data_path=chairs),
                      StageConfig(name="chairs", mixture=(
                          MixtureMemberConfig("flyingchairs", 0.75),
                          MixtureMemberConfig("synthetic", 0.25))))
        refused = None
    except ValueError as e:
        refused = str(e)
    path = os.path.join(work, "recipe.json")
    with open(path, "w") as f:
        json.dump(recipe_stages(chairs_sintel, sintel, ucf), f)
    log_dir = os.path.join(work, "cli_recipe")
    argv = ["train", *CLI_RECIPE, "--data-path", chairs, "--recipe", path,
            "--log-dir", log_dir]
    fits: list = []
    fit = loop.Trainer.fit

    def counted(self, *a, **kw):
        start = self.state.step
        n_records = len(read_records(self.cfg.train.log_dir)) if \
            os.path.exists(os.path.join(self.cfg.train.log_dir,
                                        "metrics.jsonl")) else 0
        reset_kernel_counts()
        out = fit(self, *a, **kw)
        launches = kernel_counts()
        recs = read_records(self.cfg.train.log_dir)[n_records:]
        fits.append({"stage": self.ckpt.read_manifest_extra()[
            "recipe_stage"], "start": start, "end": self.state.step,
            "model": self.cfg.model, "summary": out, "launches": launches,
            "evals": [r for r in recs if r["kind"] == "eval"],
            "forwards_per_eval": eval_forwards(self),
            "step_ms": fit_step_ms(self.cfg.train.log_dir)})
        return out

    built_before = build.built_count()
    loop.Trainer.fit = counted
    try:
        cut = run_cli([*argv, "--max-steps", str(RECIPE_CUT)],
                      os.path.join(work, "cli_recipe_cut.log"))
        cfg = dataclasses.replace(preset, recipe=recipe_from_dict(
            recipe_stages(chairs_sintel, sintel, ucf)), train=dataclasses
            .replace(preset.train, log_dir=log_dir))
        resume_at = recipe.find_resume_stage(cfg)
        done = run_cli([*argv, "--max-steps", "100"],
                       os.path.join(work, "cli_recipe.log"))
    finally:
        loop.Trainer.fit = fit
    built_after = build.built_count() - built_before
    bench_line = run_cli(["bench", "--data-only", "--recipe", path,
                          "--data-path", chairs, "--batch", "4",
                          "--batches", "4", "--image-size", "320x448"],
                         os.path.join(work, "cli_bench_recipe.log"))
    if before_tail is not None:
        before_tail()  # nothing below is timed
    pair_dir = os.path.join(ucf, "frames", UCF101_CLASSES[0],
                            f"v_{UCF101_CLASSES[0]}_g01_c01")
    reset_kernel_counts()
    pred = run_cli(["predict", "--preset", "ucf101", "--action",
                    "--data-path", ucf,
                    "--ckpt-dir", os.path.join(log_dir, "ckpt-stage2"),
                    "--out", os.path.join(work, "actions_recipe"),
                    "--pairs", f"{pair_dir}/frame_0001.ppm:"
                               f"{pair_dir}/frame_0002.ppm"],
                   os.path.join(work, "cli_predict_recipe.log"))
    predict = kernel_counts()
    an_rc, an = run_verb(["analyze", "--log-dir", log_dir, "--no-plot"],
                         os.path.join(work, "cli_analyze_recipe.log"))
    tail_rc, tail = run_verb(["tail", "--log-dir", log_dir],
                             os.path.join(work, "cli_tail_recipe.log"))
    names = [s["name"] for s in recipe_stages("", "", "")["stages"]]
    evals = [{"step": r["step"], "stage": names[f["stage"]],
              **{k: r[k] for k in ("aee", "accuracy") if k in r}}
             for f in fits[1:] for r in f["evals"]]
    stages = []
    for f, ps in zip(fits[1:], done["per_stage"]):
        graft = next((g for g in done["grafts"]
                      if g["stage"] == f["stage"]), None)
        stages.append({
            "stage": names[f["stage"]], "model": f["model"],
            "start_step": ps["start_step"], "fit_from": f["start"],
            "end_step": ps["end_step"], "advance": ps["advance"],
            "grafted": graft and graft["copied"],
            "reinitialized": graft and graft["reinitialized"],
            "steps": f["end"] - f["start"], "evals": len(f["evals"]),
            "eval_forwards": len(f["evals"]) * f["forwards_per_eval"],
            "launches": {k: v for k, v in f["launches"].items() if v},
            "step_ms": f["step_ms"],
            "step_ms_median": (float(np.median(f["step_ms"]))
                               if f["step_ms"] else None),
            **{k: f["summary"].get(k) for k in (
                "phase_dispatch_ms_median", "ckpt_saves",
                "ckpt_save_s_total", "dev_mem_peak_bytes")}})
    row = {"stages": stages,
           "cut": {"per_stage": cut["per_stage"],
                   "launches": {k: v for k, v in fits[0]["launches"].items()
                                if v}},
           "resume": {"stage": resume_at[0], "extra": resume_at[1],
                      "fit_from": fits[1]["start"]},
           "final_stage": done["final_stage"],
           "global_step": done["global_step"], "advances": done["advances"],
           "last_trigger": done["last_trigger"],
           "prebuild": done["prebuild"],
           "libraries_built_after_prebuild":
               done["libraries_built_after_prebuild"],
           "libraries_built_in_phase": built_after,
           "mixture_refused": refused and refused[:240],
           "bench_data": {k: bench_line.get(k) for k in (
               "value", "unit", "dataset", "image_size", "draws_by_dataset",
               "decode_cache_hits", "decode_cache_misses")},
           "predict": {"launches": {k: v for k, v in predict.items() if v},
                       "actions": [{k: a[k] for k in ("class", "prob")}
                                   for a in pred["actions"]]},
           "analyze": {"rc": an_rc, "recipe": an.get("recipe"),
                       "eval": an.get("eval"),
                       "accuracy": an.get("accuracy"),
                       "train_steps": (an.get("train") or {}).get("steps")},
           "eval_curve": evals,
           "plateau_fired": done["per_stage"][1]["advance"] == "plateau",
           "tail": {"rc": tail_rc, "step": tail.get("step"),
                    "heartbeat_step": (tail.get("heartbeat") or {})
                    .get("step"), "recipe": tail.get("recipe")},
           "seconds": time.monotonic() - t0}
    emit("cli_recipe", **row)
    checks = {
        "refused": refused is not None and "disagree" in refused,
        "cut": cut["per_stage"] == [{"stage": 0, "name": "chairs",
                                     "start_step": 0, "end_step": RECIPE_CUT,
                                     "advance": "budget"}],
        "resume": resume_at[0] == 0 and resume_at[1].get(
            "stage_start_step") == 0 and fits[1]["start"] == RECIPE_CUT
        and done["per_stage"][0]["start_step"] == 0,
        "stages": [s["name"] for s in done["per_stage"]] == names
        and [s["advance"] for s in done["per_stage"]][::2]
        == ["steps", "steps"]
        and done["per_stage"][1]["advance"] in ("steps", "plateau")
        and done["per_stage"][0]["end_step"] == RECIPE_STEPS["chairs"]
        and done["per_stage"][2]["end_step"]
        - done["per_stage"][2]["start_step"] == RECIPE_STEPS["ucf101"]
        and done["final_stage"] == 2 and done["advances"] == 2,
        "grafts": [g["stage"] for g in done["grafts"]] == [1, 2],
        "prebuild": [s["stage"] for s in done["prebuild"]["stages"]]
        == [0, 1, 2] and set(done["prebuild"]["libraries"])
        == set(build.SOURCES)
        and done["libraries_built_after_prebuild"] == 0
        and cut["libraries_built_after_prebuild"] == 0 and built_after == 0,
        "step_ms": all(s["step_ms"] for s in stages),
        "launches": all(
            f["launches"] == want_counts(
                warp_fwd=f["end"] - f["start"]
                + len(f["evals"]) * f["forwards_per_eval"],
                warp_flow_grad=f["end"] - f["start"])
            and f["end"] > f["start"] and f["evals"] for f in fits),
        "finite": all(np.isfinite(e.get("aee", e.get("accuracy")))
                      for e in evals),
        "bench": bench_line["dataset"] == "flyingchairs+sintel"
        and bench_line["value"] > 0,
        "predict": predict == want_counts() and len(pred["actions"]) == 1,
        "analyze": an_rc == 0 and an["recipe"]["stage"] == 2
        and an["recipe"]["stages"] == 3,
        "tail": tail_rc == 0 and tail["step"] == done["global_step"]}
    if not all(checks.values()):
        raise AssertionError(f"cli_recipe: {checks}")
    return row


# --- data parallelism over ranks and the elastic pool on the card ---

#: the data-parallel check: FlowNet-C at full width, 384x512, global
#: batch 8, four rows a rank (the main path's (4,256,48,64) at the
#: correlation), under test_torch_train.py's L1-like loss (alpha 0.5),
#: whose gradient does not amplify rounding (F6), in float32 (TF32 off
#: in every process). Against the one-process step of all 8 rows each
#: gradient tensor within DDP_TOL of its largest entry and the loss
#: within DDP_LOSS_RTOL (the batch's sum in another order: cuDNN may
#: pick other algorithms for 4 rows than for 8; the limit of
#: test_torch_train.py's L1-like step). Against the mean of the
#: one-process steps of the two halves (the ranks' own computations,
#: averaged as the all-reduce does) within DDP_HALVES_TOL: only the
#: all-reduce lies between them.
DDP_BATCH = 8
DDP_TOL = 1e-4
DDP_LOSS_RTOL = 1e-5
DDP_HALVES_TOL = 1e-6
DDP_TIMED = 3  # steps and all-reduces timed a rank after the check
DDP_STEPS = 3  # `train --multihost` under torchrun
DDP_RUN = ["--model", "flownet_c", "--synthetic",
           "--set", "data.image_size=[384,512]",
           "--set", "data.gt_size=[384,512]",
           "--set", "train.log_every=1", "--set", "train.eval_every=0",
           "--set", "train.ckpt_every_epochs=1000000"]
#: the elastic drill on the card: 3 hosts of full-width FlowNet-C
#: (384x512, batch 4), host 1 SIGKILLed at step 4, target 10
DRILL_ARGS = ["--device", "cuda", "--hosts", "3", "--target", "10",
              "--kill-host", "1", "--kill-step", "4", "--ckpt-every", "3",
              "--timeout", "600", "--set", "model=flownet_c",
              "--set", "width_mult=1.0",
              "--set", "data.image_size=[384,512]",
              "--set", "data.gt_size=[384,512]"]


#: spatial and temporal context parallelism inside ddp_rank's two ranks
#: (no new boot): full-width FlowNet-C at 384x512 over mesh.spatial=2
#: (global batch 4, every row on both ranks, each rank its rows of every
#: level; 384 -> ... -> 6 rows at the deepest level, 3 a shard), and
#: the sintel preset's full-width FlowNet-S volume step (T = 10 frames,
#: 224x480 crops, batch 4: 36 folded pairs, 18 a rank) over
#: mesh.time=2; each against its one-process step with the DDP check's
#: tolerances (DDP_TOL of each gradient's largest entry, the loss
#: DDP_LOSS_RTOL)
CONTEXT = {"spatial_hw": [384, 512], "spatial_batch": 4,
           "volume_hw": [224, 480], "volume_t": 10, "volume_batch": 4,
           "model": {}}
#: every other family over mesh.spatial=2 (ROADMAP item 10.1) in the
#: same two ranks, full width at its preset's geometry: the sintel
#: preset's Inception-v3 volume (224x480 crops, T = 10: 30 channels in,
#: 18 flow channels out), VGG16Flow at flyingchairs_vgg's 320x448,
#: FlowNet-CS at 384x512, and the three UCF-101 models at the ucf101
#: preset's 320x384 (the synthetic draw's labels). Each is held in
#: float64 (`checked_steps`) and its float32 step against FLOAT32_SPREAD.
CONTEXT["families"] = {
    "inception_volume": {"model": "inception_v3", "hw": [224, 480],
                         "batch": 4, "frames": 10},
    "vgg16": {"model": "vgg16", "hw": [320, 448], "batch": 8, "frames": 2},
    "flownet_cs": {"model": "flownet_cs", "hw": [384, 512], "batch": 4,
                   "frames": 2},
    "st_single": {"model": "st_single", "hw": [320, 384], "batch": 8,
                  "frames": 2},
    "st_baseline": {"model": "st_baseline", "hw": [320, 384], "batch": 8,
                    "frames": 2},
    "ucf101_spatial": {"model": "ucf101_spatial", "hw": [320, 384],
                       "batch": 8, "frames": 2}}
#: a family's float32 step (the main path) from its float64 step, each
#: tensor's largest difference over its largest entry: the spatial
#: ranks' at most FLOAT32_SPREAD times the one-process float32 step's,
#: on the worst tensor and on the median one. Both are float32's
#: rounding of one computation summed in two orders (on the H100 the
#: worst tensor's read 0.9-2.5x; PERF.md); a cast or a lower-precision
#: stage on the split path shows above it.
FLOAT32_SPREAD = 4.0
#: every context kind's step in bf16 compute (`train.compute_dtype=
#: bfloat16`, ROADMAP item 10.2) from the same weights and batch: its
#: distance from the float64 step (each tensor's largest difference
#: over its largest entry) at most BF16_SPREAD times the one-process
#: bf16 step's on the worst and the median tensor, and its loss within
#: BF16_LOSS_RTOL of the one-process bf16 loss (tests/
#: _torch_spatial_families.py holds the CPU's at the same two). Bit
#: equality is not expected: the row-sharded convolutions sum their bf16
#: products in another order. FLOAT32_SPREAD's 4. The same factor bounds
#: it from below (at least 1/BF16_SPREAD of the one-process bf16 step's
#: distance), and every exchange carries exactly half the float32
#: step's bytes: a step that computes or exchanges in float32 sits far
#: closer to float64, or moves twice the bytes.
BF16_SPREAD = 4.0
BF16_LOSS_RTOL = 5e-3
#: timed steps of each family, a rank and in the reference (the
#: script's time limit), and of each kind's bf16 step
FAMILY_TIMED = 1
BF16_TIMED = 1
#: `train --multihost --set mesh.spatial=2` beside ddp_cli
SPATIAL_CLI_STEPS = 3
SPATIAL_CLI_BATCH = 4

#: the check's geometry (a CPU rehearsal passes a smaller one); the
#: parent writes it to work/ddp_check.json for the ranks
DDP_CHECK = {"device": "cuda", "hw": [384, 512], "model": {},
             "context": CONTEXT}


def ddp_check_parts(check: dict, device, world, batch: dict | None = None):
    """The check's model (seed 0; `check["model"]`'s overrides, none at
    full width), train step over `world`, and global batch (`batch`, or
    a fixed draw of the synthetic dataset)."""
    import numpy as np

    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              LossConfig)
    from deepof_tpu_torch.core.device import disable_tf32
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.data.pipeline import derive_batch_rng
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.schedule import step_decay_schedule
    from deepof_tpu_torch.train.state import create_train_state
    from deepof_tpu_torch.train.step import make_train_step

    disable_tf32()  # float32 convolutions, as a float32 Trainer's
    hw = tuple(check["hw"])
    cfg = ExperimentConfig(
        model="flownet_c", loss=LossConfig(alpha_c=0.5, alpha_s=0.5),
        data=DataConfig(dataset="synthetic", image_size=hw, gt_size=hw,
                        batch_size=DDP_BATCH), **check["model"])
    ds = SyntheticData(cfg.data)
    model = build_model("flownet_c", device=device, seed=0, image_size=hw,
                        width_mult=cfg.width_mult,
                        corr_max_disp=cfg.corr_max_disp,
                        corr_stride=cfg.corr_stride)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    step = make_train_step(model, cfg, ds.mean, world=world)
    if batch is None:
        batch = ds.sample_train(DDP_BATCH, rng=derive_batch_rng(
            np.array([7, 0], np.uint32), 0))
    return model, state, step, batch


def ddp_rank(work: str) -> int:
    """One rank of `ddp_flownet_c`'s check (run under torchrun): joins the
    world on the card, steps on its rows of the global batch, and writes
    to work/ddp_rank<r>.json its kernel launches in that step, its
    largest gradient difference from each one-process reference in
    work/ddp_ref.pt ("whole": the step of all rows; "halves": the mean
    of the two halves' steps; each tensor's, over its largest entry)
    and whether it equals the halves' bit for bit, a CRC of its averaged
    gradients, then DDP_TIMED more steps' and all-reduces' milliseconds
    (host clock to a synchronize)."""
    import zlib

    import torch
    import torch.distributed as dist

    from deepof_tpu_torch.parallel.mesh import (init_distributed,
                                                local_batch_rows,
                                                shutdown_distributed)

    with open(os.path.join(work, "ddp_check.json")) as f:
        check = json.load(f)
    torch.backends.cudnn.deterministic = True  # this rank's own process
    world = init_distributed(check["device"])
    # booted while the parent computed the references: nothing here runs
    # until they are all written
    ready = os.path.join(work, "refs_ready")
    deadline = time.monotonic() + 1800
    while not os.path.exists(ready):
        if time.monotonic() > deadline:
            raise AssertionError("ddp_rank: no references within 1800 s")
        time.sleep(0.1)
    import numpy as np

    with np.load(os.path.join(work, "ddp_batch.npz")) as z:
        batch = {k: z[k] for k in ("source", "target")}
    model, state, step, batch = ddp_check_parts(check, world.device, world,
                                                batch)
    rows = local_batch_rows(world, DDP_BATCH)[1]
    local = {k: batch[k][rows] for k in ("source", "target")}
    reset_kernel_counts()
    m = step(state, local)
    counts = kernel_counts()
    ref = torch.load(os.path.join(work, "ddp_ref.pt"))
    errs = {k: {} for k in ref}
    crc, equal = 0, float(m["total"]) == float(ref["halves"]["total"])
    for name, p in model.named_parameters():
        g = p.grad.detach().cpu()
        for k, r in ref.items():
            want = r["grads"][name]
            errs[k][name] = float((g - want).abs().max()
                                  / max(float(want.abs().max()), 1e-30))
        equal = equal and torch.equal(g, ref["halves"]["grads"][name])
        crc = zlib.crc32(g.numpy().tobytes(), crc)
    worst = {k: max(e, key=e.get) for k, e in errs.items()}
    total = float(m["total"])
    step_ms = timed_steps(lambda: step(state, local), DDP_TIMED,
                          world.device)
    n_params = sum(p.numel() for p in model.parameters())
    buf = torch.zeros(n_params, device=world.device)
    reduce_ms = timed_steps(lambda: dist.all_reduce(buf), DDP_TIMED,
                            world.device)
    del model, state, step, buf
    if world.device.type == "cuda":
        torch.cuda.empty_cache()
    with open(os.path.join(work, f"context_rank{world.rank}.json"),
              "w") as f:
        json.dump(context_rank(work, check, world.rank), f)
    row = {"rank": world.rank, "backend": world.backend, "size": world.size,
           "device": str(world.device), "launches": counts,
           "total": total,
           **{f"total_{k}": float(r["total"]) for k, r in ref.items()},
           **{f"max_rel_err_{k}": errs[k][w] for k, w in worst.items()},
           **{f"worst_tensor_{k}": w for k, w in worst.items()},
           "bitwise_equal_halves": equal,
           "grad_crc32": crc, "step_ms": step_ms,
           "all_reduce_ms": reduce_ms, "all_reduce_bytes": 4 * n_params}
    with open(os.path.join(work, f"ddp_rank{world.rank}.json"), "w") as f:
        json.dump(row, f)
    shutdown_distributed()
    return 0


def context_kinds(check: dict) -> list[str]:
    """The context checks in their order: "spatial", "volume", then the
    families of ctx["families"]."""
    return ["spatial", "volume", *check["context"].get("families", {})]


def family_launches(model: str, steps: int = 1,
                    dtype: str = "float32") -> dict:
    """A model's kernel launches in `steps` train steps computing in
    `dtype`: the two float32 warps once a step (the loss, on the flows
    cast to float32), FlowNet-CS's twice (its refinement input too);
    FlowNet-C's correlation forward and backward kernels, and FlowNet-CS
    base stage's, once a step in `dtype`'s instance; the classifier
    none."""
    if model == "ucf101_spatial":
        return want_counts()
    sfx = DTYPES[dtype]
    corr = steps if model in ("flownet_c", "flownet_cs") else 0
    warps = 2 * steps if model == "flownet_cs" else steps
    return want_counts(**{f"{k}{sfx}": corr for k in CORR_KERNELS},
                       warp_fwd=warps, warp_flow_grad=warps)


def context_model(check: dict, kind: str) -> str:
    """The model a context check of `kind` trains."""
    if kind in ("spatial", "volume"):
        return "flownet_c" if kind == "spatial" else "flownet_s"
    return check["context"]["families"][kind]["model"]


def context_cfg(check: dict, kind: str, world, compute: str = "float32"):
    """The context check's config: "spatial", full-width FlowNet-C at
    ctx["spatial_hw"] under mesh.spatial = world's; "volume", FlowNet-S
    over ctx["volume_t"]-frame volumes (the sintel preset's geometry)
    under mesh.time = world's; or a family of ctx["families"] (its model,
    size, batch and frames) under mesh.spatial = world's; computing in
    `compute` (`train.compute_dtype`)."""
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              LossConfig, MeshConfig)
    from deepof_tpu_torch.models.registry import MODELS

    ctx = check["context"]
    if kind in ("spatial", "volume"):
        spatial = kind == "spatial"
        name = "flownet_c" if spatial else "flownet_s"
        hw = tuple(ctx["spatial_hw" if spatial else "volume_hw"])
        t = 2 if spatial else ctx["volume_t"]
        batch = ctx["spatial_batch" if spatial else "volume_batch"]
    else:
        fam = ctx["families"][kind]
        name, hw, batch, t = (fam["model"], tuple(fam["hw"]), fam["batch"],
                              fam["frames"])
    # ctx["model"]: a CPU rehearsal's knobs, the width only where the
    # model has one
    knobs = {k: v for k, v in ctx["model"].items() if k != "width_mult"
             or "width_mult" in inspect.signature(MODELS[name]).parameters}
    shape = world.shape
    cfg = ExperimentConfig(
        model=name, loss=LossConfig(alpha_c=0.5, alpha_s=0.5),
        mesh=MeshConfig(data=shape["data"], spatial=shape["spatial"],
                        time=shape["time"]),
        data=DataConfig(dataset="synthetic", image_size=hw, gt_size=hw,
                        batch_size=batch, time_step=t), **knobs)
    return cfg.replace(train=dataclasses.replace(cfg.train,
                                                 compute_dtype=compute))


def context_parts(check: dict, kind: str, device, world, dtype=None):
    """The context check of `kind` (`context_cfg`, float32): its model
    (seed 0), train step over `world` and global batch (a fixed
    synthetic draw). `dtype`: the model's compute dtype (float64: the
    exact reference of `context_reference`), default float32."""
    import numpy as np

    from deepof_tpu_torch.core.device import disable_tf32
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.data.pipeline import derive_batch_rng
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.schedule import step_decay_schedule
    from deepof_tpu_torch.train.state import create_train_state
    from deepof_tpu_torch.train.step import make_train_step

    disable_tf32()
    cfg = context_cfg(check, kind, world)
    name, hw, t = (cfg.model, tuple(cfg.data.image_size),
                   cfg.data.time_step)
    batch = cfg.data.batch_size
    kw = ({"corr_max_disp": cfg.corr_max_disp,
           "corr_stride": cfg.corr_stride}
          if name in ("flownet_c", "flownet_cs") else {})
    if dtype is not None:
        kw["dtype"] = dtype
    model = build_model(name, flow_channels=2 * (t - 1), device=device,
                        seed=0, image_size=hw, width_mult=cfg.width_mult,
                        **kw)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    step = make_train_step(model, cfg, (0.0, 0.0, 0.0), world=world)
    draw = SyntheticData(cfg.data).sample_train(batch, rng=derive_batch_rng(
        np.array([9, 0], np.uint32), 0))
    keys = (("volume",) if t > 2 else ("source", "target", "label")
            if name in ("st_single", "st_baseline", "ucf101_spatial")
            else ("source", "target"))
    return model, state, step, {k: draw[k] for k in keys}


def context_bf16_step(check: dict, kind: str, model, world):
    """The train step of the context check's config in bf16 compute
    (`train.compute_dtype=bfloat16`: the step casts the network's input
    to bf16, the flows back to float32; `checked_steps` sets the layers'
    compute dtype) over the same model: its sharding passes
    `check_context_parallel` on the world's mesh."""
    from deepof_tpu_torch.train.step import make_train_step

    return make_train_step(model, context_cfg(check, kind, world,
                                              "bfloat16"),
                           (0.0, 0.0, 0.0), world=world)


def max_rel_errs(got: dict, want: dict) -> dict:
    """{name: max |got - want| / max |want|} over two gradient dicts, on
    `got`'s device."""
    out = {}
    for n, w in want.items():
        g = got[n]
        w = w.to(g.device)
        out[n] = float((g.double() - w.double()).abs().max()
                       / max(float(w.abs().max()), 1e-30))
    return out


def set_compute_dtype(model, dtype) -> None:
    """Every layer's compute dtype: the `dtype` each conv, deconv and
    dense layer casts its input, weight and bias to (`models/common.py`,
    `models/two_stream.py`); the parameters stay float32 and their
    gradients come back float32 through the cast. The losses read the
    flows cast to float32 whatever it is."""
    import torch

    for m in model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = dtype


@contextlib.contextmanager
def float32_correlation():
    """FlowNet-C's correlation with its operands cast to float32 and its
    volume cast back: the kernel takes float32 or bf16, so a float64 step
    of FlowNet-CS is float64 but for it (and for the upsample and warp of
    its refinement input, float32 in the model)."""
    from deepof_tpu_torch.models import flownet_c

    corr = flownet_c.correlation_nchw

    def cast(f1, f2, *args, **kw):
        return corr(f1.float(), f2.float(), *args, **kw).to(f1.dtype)

    flownet_c.correlation_nchw = cast
    try:
        yield
    finally:
        flownet_c.correlation_nchw = corr


def checked_steps(model, state, step, batch, exact: bool,
                  bf16_step=None, before=None):
    """The context check's steps at the seed's weights, each yielded as
    (tag, loss, gradients on the device): "float32", the float32 step
    (the main path); where `exact`, "float64", the same step with every
    layer in float64 from the same weights and at the same global step
    (an action model's dropout masks; the correlation in float32,
    `float32_correlation`); with `bf16_step` (`context_bf16_step`),
    "bfloat16", that step from the same weights with every layer in
    bf16. `before(tag)` runs before each step: a caller resets the
    launch counters and the exchanges' stats there, and reads them at
    the step's yield."""
    import torch

    from deepof_tpu_torch.train.step import STEP_KEY

    batch = {**batch, STEP_KEY: 0}
    plan = [("float32", torch.float32, step)]
    if exact:
        plan.append(("float64", torch.float64, step))
    if bf16_step is not None:
        plan.append(("bfloat16", torch.bfloat16, bf16_step))
    weights = ({k: v.clone() for k, v in model.state_dict().items()}
               if len(plan) > 1 else None)
    for i, (tag, dtype, fn) in enumerate(plan):
        if i:
            model.load_state_dict(weights)
        set_compute_dtype(model, dtype)
        if before is not None:
            before(tag)
        try:
            with (float32_correlation() if dtype == torch.float64
                  else contextlib.nullcontext()):
                m = fn(state, batch)
        finally:
            set_compute_dtype(model, torch.float32)
        yield tag, m["total"].detach(), {
            n: p.grad.detach().clone() for n, p in model.named_parameters()}


def timed_steps(fn, n: int, device) -> list[float]:
    """`n` calls of `fn()`, each one's milliseconds (host clock to a
    synchronize)."""
    import torch

    device = torch.device(device)
    out = []
    for _ in range(n):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def bf16_timed(model, state, step, batch, device) -> list[float]:
    """BF16_TIMED more bf16 steps' milliseconds (`timed_steps`), every
    layer in bf16 for them."""
    import torch

    set_compute_dtype(model, torch.bfloat16)
    try:
        return timed_steps(lambda: step(state, batch), BF16_TIMED, device)
    finally:
        set_compute_dtype(model, torch.float32)


def context_reference(work: str, check: dict, between) -> dict:
    """The one-process steps of the context checks at the seed's
    weights, in two passes over the kinds. First each kind's timed
    steps: its float32 step DDP_TIMED times (FAMILY_TIMED for a family)
    and its bf16 step BF16_TIMED times (ms, host clock to a
    synchronize), every kind's model, state and seed weights kept. Then
    `between()` (ddp_phases starts the check's ranks there: they boot
    while nothing timed runs here, and wait for work/refs_ready), then
    each kind's checked steps from its seed weights into
    work/context_ref_<kind>.pt (the loss and every gradient of the
    float32 and the float64 step, each one's distance from float64, and
    the bf16 step's loss and distance; a file a kind, so a rank loads
    one kind's at a time: the UCF-101 models' fc6 gradient alone is
    251.7 M floats), the kind freed after it; then work/refs_ready.
    Returns {"float32": {kind: ms}, "bfloat16": {kind: ms}}."""
    import numpy as np
    import torch

    from deepof_tpu_torch.parallel.mesh import World

    device = torch.device(check["device"])
    one = World(np.zeros((1, 1, 1)))
    ms = {"float32": {}, "bfloat16": {}}
    kept = {}
    with cudnn_deterministic():
        for kind in context_kinds(check):
            model, state, step, batch = context_parts(check, kind, device,
                                                      one)
            bf16 = context_bf16_step(check, kind, model, one)
            weights = {k: v.clone() for k, v in model.state_dict().items()}
            timed = (DDP_TIMED if kind in ("spatial", "volume")
                     else FAMILY_TIMED)
            ms["float32"][kind] = timed_steps(lambda: step(state, batch),
                                              timed, device)
            ms["bfloat16"][kind] = bf16_timed(model, state, bf16, batch,
                                              device)
            model.load_state_dict(weights)
            del weights
            kept[kind] = (model, state, step, bf16, batch)
        between()
        for kind in context_kinds(check):
            model, state, step, bf16, batch = kept.pop(kind)
            steps = {tag: (total, grads) for tag, total, grads in
                     checked_steps(model, state, step, batch, True, bf16)}
            exact = steps["float64"][1]
            ref = {key: {"total": steps[key][0].cpu(),
                         "grads": {n: g.cpu()
                                   for n, g in steps[key][1].items()}}
                   for key in ("float32", "float64")}
            ref["float32_vs_float64"] = max_rel_errs(steps["float32"][1],
                                                     exact)
            ref["bfloat16"] = {
                "total": steps["bfloat16"][0].cpu(),
                "vs_float64": max_rel_errs(steps["bfloat16"][1], exact)}
            del steps, exact
            torch.save(ref, os.path.join(work, f"context_ref_{kind}.pt"))
            del ref, model, state, step, bf16
            if device.type == "cuda":
                torch.cuda.empty_cache()
    open(os.path.join(work, "refs_ready"), "w").close()
    return ms


def context_rank(work: str, check: dict, rank: int) -> dict:
    """ddp_rank's context checks in its two ranks, on the world they
    joined (the axes' groups made here, no new boot): each kind's
    float32 step on the whole global batch (the ranks of one data shard
    hold the same rows), its kernel launches and the bytes, messages and
    milliseconds of its exchanges (host clock to a synchronize around
    each); then the same step in float64 from the same weights, and in
    bf16 compute (`context_bf16_step`). Each dtype's row: its largest
    gradient difference from the one-process step of its dtype (each
    tensor's, over its largest entry, on the rank's device; the bf16
    step's from the float64 one, beside the one-process bf16 step's,
    which BF16_SPREAD bounds), its loss and a CRC of its gradients. The
    checked row is a family's float64 step (its float32 step beside it,
    with its distance from the float64 step on the worst and the median
    tensor beside the one-process float32 step's, which FLOAT32_SPREAD
    bounds), and "spatial"'s and "volume"'s float32 step (their float64
    step beside it); every kind's "bfloat16" row carries its own
    launches and exchanges. Then DDP_TIMED (a family: FAMILY_TIMED) more
    float32 steps' milliseconds and BF16_TIMED bf16 steps', the
    exchanges untimed."""
    import zlib

    import torch

    from deepof_tpu_torch.core.config import MeshConfig
    from deepof_tpu_torch.parallel import spatial
    from deepof_tpu_torch.parallel.mesh import build_mesh

    def held(total, grads, want):
        errs = max_rel_errs(grads, want["grads"])
        worst = max(errs, key=errs.get)
        crc = 0
        for name in sorted(grads):
            crc = zlib.crc32(grads[name].cpu().numpy().tobytes(), crc)
        return {"max_rel_err": errs[worst], "worst_tensor": worst,
                "total": float(total),
                "total_one_process": float(want["total"]),
                "grad_crc32": crc}

    def spread(grads, exact, one):
        d = max_rel_errs(grads, exact)
        return {"vs_float64": max(d.values()),
                "one_process_vs_float64": max(one.values()),
                "vs_float64_median": statistics.median(d.values()),
                "one_process_vs_float64_median": statistics.median(
                    one.values())}

    def before(tag):
        reset_kernel_counts()
        spatial.reset_stats()
        spatial.STATS["timed"] = tag != "float64"

    out = {}
    families = check["context"].get("families", {})
    for kind in context_kinds(check):
        mesh = MeshConfig(time=2) if kind == "volume" else MeshConfig(
            spatial=2)
        ref = torch.load(os.path.join(work, f"context_ref_{kind}.pt"))
        world = build_mesh(mesh)
        model, state, step, batch = context_parts(check, kind, world.device,
                                                  world)
        bf16 = context_bf16_step(check, kind, model, world)
        exact = {n: g.to(world.device)
                 for n, g in ref["float64"]["grads"].items()}
        rows, counts, stats = {}, {}, {}
        for tag, total, grads in checked_steps(model, state, step, batch,
                                               True, bf16, before):
            spatial.STATS["timed"] = False
            counts[tag] = kernel_counts()
            stats[tag] = {k: v for k, v in spatial.STATS.items()
                          if k != "timed"}
            if tag == "bfloat16":
                one = ref["bfloat16"]
                crc = 0
                for name in sorted(grads):
                    crc = zlib.crc32(grads[name].cpu().numpy().tobytes(),
                                     crc)
                rows[tag] = {
                    "total": float(total),
                    "total_one_process": float(one["total"]),
                    "grad_crc32": crc,
                    **spread(grads, exact, one["vs_float64"])}
            else:
                rows[tag] = held(total, grads, ref[tag])
                if tag == "float32":
                    rows[tag].update(spread(grads, exact,
                                            ref["float32_vs_float64"]))
            del grads
        del exact
        if kind in families:
            row = {**rows["float64"], "checked_dtype": "float64",
                   "float32": rows["float32"]}
        else:
            row = {**rows["float32"], "checked_dtype": "float32",
                   "float64": rows["float64"]}
        timed = DDP_TIMED if kind in ("spatial", "volume") else FAMILY_TIMED
        step_ms = timed_steps(lambda: step(state, batch), timed,
                              world.device)
        row["bfloat16"] = {
            **rows["bfloat16"], "launches": counts["bfloat16"],
            "exchange": stats["bfloat16"],
            "step_ms": bf16_timed(model, state, bf16, batch, world.device)}
        out[kind] = {
            "rank": rank, "mesh": world.shape, "coords": world.coords,
            "launches": counts["float32"], **row, "step_ms": step_ms,
            "exchange": stats["float32"]}
        del model, state, step, bf16, ref
        if world.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def gloo_cuda_probe() -> int:
    """Which `torch.distributed` collectives gloo takes for CUDA tensors,
    in a gloo world of one (no peer to wait on): each op called once on
    a card tensor, "ok" or the error it raised, as one JSON line. Point
    to point is not called (gloo's send reads the tensor's pointer as
    host memory); the exchange stages it (`parallel/spatial.py`)."""
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    x = torch.ones(4, device="cuda")
    ops = {
        "broadcast": lambda: dist.broadcast(x, 0),
        "all_reduce": lambda: dist.all_reduce(x),
        "reduce": lambda: dist.reduce(x, 0),
        "all_gather": lambda: dist.all_gather([torch.empty_like(x)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty_like(x), x),
        "gather": lambda: dist.gather(x, [torch.empty_like(x)], 0),
        "scatter": lambda: dist.scatter(x, [torch.ones_like(x)], 0),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty_like(x), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x)}
    found = {}
    for name, op in ops.items():
        try:
            op()
            torch.cuda.synchronize()
            found[name] = "ok"
        except Exception as e:  # the finding: what gloo refuses
            found[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    dist.destroy_process_group()
    print(json.dumps(found), flush=True)
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_logs(logs: str, nproc: int) -> dict:
    """{rank: stdout text, "err<rank>": stderr text} of the ranks' log
    files under `logs` (torchrun's `--redirects 3` layout:
    `<run>/attempt_<k>/<rank>/stdout.log`)."""
    out = {}
    for dirpath, _, files in os.walk(logs):
        if "stdout.log" in files and os.path.basename(dirpath).isdigit():
            rank = int(os.path.basename(dirpath))
            for stream, key in (("stdout", rank), ("stderr", f"err{rank}")):
                with open(os.path.join(dirpath, f"{stream}.log")) as f:
                    out[key] = f.read()
    return out


def _ranks_done(procs: list, logs: str, nproc: int, name: str,
                timeout_s: float) -> list[str]:
    """Wait for `procs`; each rank's stdout in rank order; fails on a
    nonzero exit (naming the ranks' stderr tails)."""
    deadline = time.monotonic() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            raise AssertionError(f"{name}: ranks still running after "
                                 f"{timeout_s} s")
    out = _rank_logs(logs, nproc)
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        agent = os.path.join(logs, "agent.log")
        tail = ""
        if os.path.exists(agent):
            with open(agent) as f:
                tail = f.read()[-2000:]
        raise AssertionError(
            f"{name}: rc {bad}: {tail} "
            + " ".join(out.get(f"err{r}", "")[-2000:] for r in range(nproc)))
    return [out[r] for r in range(nproc)]


def _rank_env() -> dict:
    root = os.path.dirname(os.path.abspath(__file__))
    return dict(os.environ, PYTHONPATH=root + os.pathsep
                + os.environ.get("PYTHONPATH", ""))


def start_torchrun(nproc: int, argv: list, work: str, name: str,
                   threads: int | None = None) -> tuple:
    """Start `python -m torch.distributed.run --nproc_per_node nproc
    argv` from the checkout, each rank's output in its own files
    (`--redirects 3`); `(procs, logs, nproc, name)` for `finish`.
    `threads`: each rank's OMP_NUM_THREADS (torchrun's default is 1)."""
    logs = os.path.join(work, f"{name}_ranks")
    os.makedirs(logs)
    env = _rank_env()
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    with open(os.path.join(logs, "agent.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
             "--master_port", str(free_port()), "--redirects", "3",
             "--log-dir", logs, *argv], stdout=out,
            stderr=subprocess.STDOUT, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    proc.started_at, proc.ended = time.monotonic(), threading.Event()

    def watch():
        proc.wait()
        proc.ended_at = time.monotonic()
        proc.ended.set()

    threading.Thread(target=watch, daemon=True).start()
    return [proc], logs, nproc, name


def finish(started: tuple, done_at: dict | None = None,
           timeout_s: float = 600) -> list[str]:
    """Wait for a `start_torchrun` run; each rank's stdout. `done_at`:
    the run's seconds from its start to its exit (its watcher's clock,
    so a run that ended before this call reads its own end) go there
    under its name."""
    procs, logs, nproc, name = started
    out = _ranks_done(procs, logs, nproc, name, timeout_s)
    if done_at is not None:
        (proc,) = procs
        proc.ended.wait(10)
        done_at[name] = proc.ended_at - proc.started_at
    return out


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def train_launches(steps: int) -> dict:
    """A FlowNet-C training run's launches with no eval: each of the five
    float32 kernels once a step."""
    return want_counts(corr=steps, corr_bwd_f1=steps, corr_bwd_f2=steps,
                       warp_fwd=steps, warp_flow_grad=steps)


def ddp_reference(work: str, check: dict) -> list[float]:
    """The check's one-process references in work/ddp_ref.pt, at the
    seed's weights: the step of all DDP_BATCH rows ("whole") and the mean
    of the two halves' steps ("halves"), each the loss and every
    gradient; returns the whole batch's step, timed DDP_TIMED times (ms,
    host clock to a synchronize)."""
    import numpy as np
    import torch

    from deepof_tpu_torch.parallel.mesh import World

    device = torch.device(check["device"])
    refs, one_ms, halves = {}, [], []
    with cudnn_deterministic():
        model, state, step, batch = ddp_check_parts(
            check, device, World(np.zeros((1, 1, 1))))
        np.savez(os.path.join(work, "ddp_batch.npz"),  # the ranks' rows
                 **{k: batch[k] for k in ("source", "target")})
        weights = {k: v.clone() for k, v in model.state_dict().items()}
        for lo, hi in ((0, DDP_BATCH), (0, DDP_BATCH // 2),
                       (DDP_BATCH // 2, DDP_BATCH)):
            # each gradient at the seed's weights (a step updates them;
            # the Adam state moves no gradient)
            model.load_state_dict(weights)
            rows = {k: batch[k][lo:hi] for k in ("source", "target")}
            m = step(state, rows)
            got = {"total": m["total"].cpu(),
                   "grads": {n: p.grad.detach().cpu()
                             for n, p in model.named_parameters()}}
            if hi - lo < DDP_BATCH:
                halves.append(got)
                continue
            refs["whole"] = got
            one_ms = timed_steps(lambda: step(state, rows), DDP_TIMED,
                                 device)
        a, b = halves
        # the all-reduce's arithmetic: the sum of two, halved
        refs["halves"] = {"total": (a["total"] + b["total"]) / 2,
                          "grads": {n: (a["grads"][n] + b["grads"][n]) / 2
                                    for n in a["grads"]}}
        torch.save(refs, os.path.join(work, "ddp_ref.pt"))
    del model, state, step, m
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return one_ms


#: the run directories and rank logs of `start_ddp_group`'s processes
#: (the earlier runs' removal leaves them)
DDP_GROUP_DIRS = ("ddp_cli", "ddp_cli_ranks", "spatial_cli",
                  "spatial_cli_ranks", "nccl_world1", "nccl_ranks")


def start_ddp_group(work: str, check: dict = DDP_CHECK,
                    extra: tuple = ()) -> dict:
    """ddp_phases' first group of processes, started and not waited for:
    `train --multihost` over two ranks (ddp_cli), the same with
    mesh.spatial=2 (spatial_cli), one NCCL rank (nccl) and, on the card,
    the gloo probe. Returns {"t0", "cli", "spatial_cli", "probe",
    "nccl"}."""
    t0 = time.monotonic()
    cli = start_torchrun(2, [
        "-m", "deepof_tpu_torch", "train", "--multihost", *DDP_RUN,
        "--set", f"data.batch_size={DDP_BATCH}",
        "--set", f"train.eval_batch_size={DDP_BATCH}",
        "--steps", str(DDP_STEPS), "--log-dir",
        os.path.join(work, "ddp_cli"), *extra], work, "ddp_cli")
    spatial_cli = start_torchrun(2, [
        "-m", "deepof_tpu_torch", "train", "--multihost", *DDP_RUN,
        "--set", "mesh.spatial=2",
        "--set", f"data.batch_size={SPATIAL_CLI_BATCH}",
        "--set", f"train.eval_batch_size={SPATIAL_CLI_BATCH}",
        "--steps", str(SPATIAL_CLI_STEPS), "--log-dir",
        os.path.join(work, "spatial_cli"), *extra], work, "spatial_cli")
    probe = (subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "gloo_probe"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_rank_env(), cwd=os.path.dirname(os.path.abspath(__file__)))
        if check["device"] == "cuda" else None)
    args = [*DDP_RUN, "--set", "data.batch_size=4", "--set",
            "train.eval_batch_size=4", "--steps", str(DDP_STEPS), *extra]
    nccl = start_torchrun(1, [os.path.abspath(__file__), "deterministic_cli",
                              "train", "--multihost", *args, "--log-dir",
                              os.path.join(work, "nccl_world1")],
                          work, "nccl")
    return {"t0": t0, "cli": cli, "spatial_cli": spatial_cli,
            "probe": probe, "nccl": nccl}


def ddp_phases(work: str, check: dict = DDP_CHECK, extra: tuple = (),
               clearing: threading.Thread | None = None,
               group: dict | None = None) -> tuple[dict, dict, dict]:
    """Data parallelism and spatial and temporal context parallelism on
    the card: the phases `ddp_flownet_c`, `ddp_nccl_world1`,
    `spatial_flownet_c`, `time_volume`, `spatial_<family>` for each
    family of CONTEXT["families"], `spatial_cli` and
    `gloo_cuda_collectives`.

    First, at once, beside each other on the card and beside `clearing`
    (the earlier runs' removal; their step times read so): `torchrun
    --nproc_per_node 2 -m deepof_tpu_torch train --multihost` for
    DDP_STEPS steps at global batch 8 (each rank's launches from its
    summary's `kernel_launches`, its step, `dist_backend`, finite
    losses in rank 0's records); `torchrun --nproc_per_node 1 ...
    --multihost` over NCCL (its step's all_reduce runs, an identity at
    world one); and the plain `train` in this process at the NCCL
    rank's settings and seed. The NCCL rank and the plain run use
    cuDNN's deterministic algorithms (`deterministic_cli`), so every
    loss must be the same bits: a reduction that moved the gradient (a
    wrong divisor, a zeroed or shifted buffer) shows from step 2 on.

    Then, with nothing else running (`clearing` joined), the check: the
    one-process references (`ddp_reference`), then `ddp_rank` in two
    ranks under torchrun on the one card, so over gloo (NCCL refuses two
    ranks on one device), each on its 4 rows: the averaged gradient
    within DDP_TOL of each tensor's largest entry of the whole batch's
    and the loss within DDP_LOSS_RTOL, within DDP_HALVES_TOL of the mean
    of the two halves' steps, both ranks' gradients the same bits, each
    kernel launched once in each rank's step; each rank's step and
    all-reduce milliseconds.

    Beside the first group also runs `train --multihost --set
    mesh.spatial=2` (`spatial_cli`: SPATIAL_CLI_STEPS steps of full-width
    FlowNet-C at 384x512, global batch SPATIAL_CLI_BATCH on both ranks;
    each rank's launches, finite losses, rank 0's records, no "spatial
    CP inactive" warning) and the gloo probe (`gloo_cuda_probe`). After
    the DDP check the same two ranks run the context checks
    (`context_rank`, against `context_reference`): `spatial_flownet_c`
    (mesh.spatial=2) and `time_volume` (mesh.time=2), each rank's
    gradients within DDP_TOL of the one-process step's and the loss
    within DDP_LOSS_RTOL, both ranks the same bits, the correlation
    forward, both backward kernels and both warps once in each spatial
    rank's step (on full-height operands), both warps once in each time
    rank's (on its half of the pairs); then each family of
    CONTEXT["families"] over mesh.spatial=2 (`spatial_<family>`): its
    float32 step (the main path: launches, `family_launches`, rows
    exchanged, the loss within DDP_LOSS_RTOL, one CRC, its gradients'
    distance from the float64 step within FLOAT32_SPREAD times the
    one-process float32 step's), then the same step with every layer in
    float64 but the correlation (in float32 these gradients' own rounding
    at full size exceeds DDP_TOL), held as `spatial_flownet_c` is.

    `check` and `extra` (the command line's flags) set a CPU
    rehearsal's size and device. `group`: the first group's processes
    as `start_ddp_group` started them earlier (main starts them before
    cli_recipe's untimed tail: they boot beside it), else started
    here."""
    import numpy as np

    group = group or start_ddp_group(work, check, extra)
    t0, cli, spatial_cli, probe, nccl = (group[k] for k in (
        "t0", "cli", "spatial_cli", "probe", "nccl"))
    log_dir = os.path.join(work, "ddp_cli")
    spatial_dir = os.path.join(work, "spatial_cli")
    done_at: dict = {}  # seconds from t0 to each run's end
    args = [*DDP_RUN, "--set", "data.batch_size=4", "--set",
            "train.eval_batch_size=4", "--steps", str(DDP_STEPS), *extra]
    rank_dir = os.path.join(work, "nccl_world1")
    plain_dir = os.path.join(work, "nccl_plain")
    t_plain = time.monotonic()
    with cudnn_deterministic():
        plain = run_cli(["train", *args, "--log-dir", plain_dir],
                        os.path.join(work, "nccl_plain.log"))
    done_at["nccl_plain"] = time.monotonic() - t_plain
    # each run's end, as this process sees it: torchrun's exit
    summaries = [last_json(o) for o in finish(cli, done_at)]
    (nccl_out,) = finish(nccl, done_at)
    spatial_summaries = [last_json(o) for o in finish(spatial_cli,
                                                      done_at)]
    done_at["group"] = time.monotonic() - t0
    gloo = None
    if probe is not None:
        out, err = probe.communicate(timeout=300)
        if probe.returncode != 0:
            raise AssertionError(f"gloo_probe: rc {probe.returncode} "
                                 f"{err[-2000:]}")
        gloo = json.loads(out.strip().splitlines()[-1])

    t_wait = time.monotonic()
    if clearing is not None:
        clearing.join()  # the check's timings run alone
    clearing_wait_s = time.monotonic() - t_wait
    t_check = time.monotonic()
    with open(os.path.join(work, "ddp_check.json"), "w") as f:
        json.dump(check, f)
    one_ms = ddp_reference(work, check)
    import torch

    # the ranks boot between the references' timed steps and their
    # checked steps (`context_reference`); the ranks' CPU threads as
    # this process's: a CPU rehearsal's convolutions then sum as the
    # references did
    started: list = []
    try:
        context_ms = context_reference(
            work, check, between=lambda: started.append(start_torchrun(
                2, [os.path.abspath(__file__), "ddp_rank", work], work,
                "ddp_check", threads=torch.get_num_threads())))
    except BaseException:
        for procs, *_ in started:  # they wait for references never written
            for proc in procs:
                proc.terminate()  # torchrun passes it to its ranks
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        raise
    t_ranks = time.monotonic()
    finish(started[0])
    check_s = time.monotonic() - t_ranks
    check_from_spawn_s = time.monotonic() - started[0][0][0].started_at
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"ddp_rank{r}.json")) as f:
            ranks.append(json.load(f))
    os.remove(os.path.join(work, "ddp_ref.pt"))
    contexts = []
    for r in range(2):
        with open(os.path.join(work, f"context_rank{r}.json")) as f:
            contexts.append(json.load(f))
    for kind in context_kinds(check):
        os.remove(os.path.join(work, f"context_ref_{kind}.pt"))

    records = read_records(log_dir)
    first = records[0]
    losses = [r["loss"] for r in records if r["kind"] == "train"]
    # the check's seconds; each command-line run's are its own
    ddp_row = {"seconds": time.monotonic() - t_check,
               "runs_seconds": done_at,
               "check_ranks_s": check_s,
               "check_ranks_from_spawn_s": check_from_spawn_s,
               "check_ranks_boot_beside": "the references' checked steps "
                                          "(context_reference)",
               "clearing_wait_s": clearing_wait_s,
               "check": {"ranks": ranks, "tol": DDP_TOL,
                         "loss_rtol": DDP_LOSS_RTOL,
                         "halves_tol": DDP_HALVES_TOL,
                         "beside": "nothing",
                         "one_process_step_ms": one_ms},
               "cli": {"steps": DDP_STEPS, "global_batch": DDP_BATCH,
                       "seconds": done_at["ddp_cli"],
                       "beside": "ddp_nccl_world1 and the earlier runs' "
                                 "removal",
                       "boot_beside": "cli_recipe's untimed predict and "
                                      "verbs",
                       "losses": losses,
                       "first_record": {k: first.get(k) for k in (
                           "message", "dist_backend", "world_size")},
                       "ranks": [{k: s.get(k) for k in (
                           "dist_backend", "world_size", "step_ms_median",
                           "phase_dispatch_ms_median",
                           "items_per_sec_per_chip", "pipeline_depth",
                           "kernel_launches")} for s in summaries]}}
    emit("ddp_flownet_c", **ddp_row)
    summary = last_json(nccl_out)
    # each step's loss and gradient norm (Adam's update hardly moves
    # under a gradient off by a constant factor; the norm does)
    got, want = ([(r["loss"], r["grad_norm"]) for r in read_records(d)
                  if r["kind"] == "train"] for d in (rank_dir, plain_dir))
    differ = [i + 1 for i, (a, b) in enumerate(zip(got, want)) if a != b]
    nccl_row = {
        "seconds": done_at["nccl"], "plain_seconds": done_at["nccl_plain"],
        "beside": "ddp_flownet_c's command line and the earlier runs' "
                  "removal",
        "cudnn_deterministic": True,
        "dist_backend": summary.get("dist_backend"),
        "world_size": summary.get("world_size"),
        "losses": [a for a, _ in got], "plain_losses": [a for a, _ in want],
        "grad_norms": [g for _, g in got],
        "plain_grad_norms": [g for _, g in want],
        "bitwise_equal": not differ and len(got) == len(want),
        "first_differing_step": differ[0] if differ else None,
        "max_rel_diff": max((abs(a - b) / abs(b) for x, y in zip(got, want)
                             for a, b in zip(x, y)), default=None),
        "step_ms_median": summary["step_ms_median"],
        "plain_step_ms_median": plain["step_ms_median"],
        "kernel_launches": summary["kernel_launches"]}
    emit("ddp_nccl_world1", **nccl_row)
    checks = {
        "backend": all((r["backend"], r["size"], r["device"])
                       == ("gloo", 2, "cuda:0") for r in ranks),
        "launches": all(r["launches"] == train_launches(1) for r in ranks),
        "grads": all(r["max_rel_err_whole"] <= DDP_TOL
                     and r["max_rel_err_halves"] <= DDP_HALVES_TOL
                     for r in ranks),
        "loss": all(abs(r["total"] - r["total_whole"])
                    <= DDP_LOSS_RTOL * abs(r["total_whole"])
                    and abs(r["total"] - r["total_halves"])
                    <= DDP_HALVES_TOL * abs(r["total_halves"])
                    for r in ranks),
        "same_bits": ranks[0]["grad_crc32"] == ranks[1]["grad_crc32"]
        and ranks[0]["total"] == ranks[1]["total"],
        "cli_backend": all((s["dist_backend"], s["world_size"])
                           == ("gloo", 2) for s in summaries)
        and (first["dist_backend"], first["world_size"]) == ("gloo", 2),
        "cli_launches": all(s["kernel_launches"] == train_launches(DDP_STEPS)
                            for s in summaries),
        "cli_losses": len(losses) == DDP_STEPS
        and all(np.isfinite(losses)),
        "nccl_backend": (nccl_row["dist_backend"], nccl_row["world_size"])
        == ("nccl", 1),
        "nccl_launches": summary["kernel_launches"]
        == train_launches(DDP_STEPS) == plain["kernel_launches"],
        # every step's loss and gradient norm the same bits as the
        # plain run's
        "nccl_losses": len(got) == DDP_STEPS and nccl_row["bitwise_equal"]
        and bool(np.isfinite(np.asarray(got, float)).all())}
    ctx = check["context"]
    families = ctx.get("families", {})
    rows = {}
    phases = {"spatial": "spatial_flownet_c", "volume": "time_volume",
              **{k: f"spatial_{k}" for k in families}}
    for kind, phase in phases.items():
        ranks = [c[kind] for c in contexts]
        rows[phase] = {
            "geometry": (families[kind] if kind in families else
                         {k: v for k, v in ctx.items()
                          if k.startswith(kind)}),
            "ranks": ranks, "tol": DDP_TOL, "loss_rtol": DDP_LOSS_RTOL,
            **({"float32_spread": FLOAT32_SPREAD} if kind in families
               else {}),
            "bf16_spread": BF16_SPREAD, "bf16_loss_rtol": BF16_LOSS_RTOL,
            "one_process_step_ms": context_ms["float32"][kind],
            "one_process_bf16_step_ms": context_ms["bfloat16"][kind],
            "beside": "nothing (after ddp_flownet_c's check, in its ranks)",
            "backend": ddp_row["check"]["ranks"][0]["backend"]}
        emit(phase, **rows[phase])
    spatial_records = read_records(spatial_dir)
    spatial_losses = [r["loss"] for r in spatial_records
                      if r["kind"] == "train"]
    rows["spatial_cli"] = {
        "steps": SPATIAL_CLI_STEPS, "global_batch": SPATIAL_CLI_BATCH,
        "seconds": done_at["spatial_cli"], "beside": "ddp_flownet_c's and "
        "ddp_nccl_world1's runs and the earlier runs' removal",
        "losses": spatial_losses,
        "warnings": [r["message"] for r in spatial_records
                     if r["kind"] == "warn"],
        "ranks": [{k: s.get(k) for k in (
            "dist_backend", "world_size", "step_ms_median",
            "kernel_launches")} for s in spatial_summaries]}
    emit("spatial_cli", **rows["spatial_cli"])
    rows["gloo_cuda_collectives"] = gloo
    if gloo is not None:
        emit("gloo_cuda_collectives", ops=gloo)

    def held(r):
        return (r["max_rel_err"] <= DDP_TOL
                and abs(r["total"] - r["total_one_process"])
                <= DDP_LOSS_RTOL * abs(r["total_one_process"]))

    sp = rows["spatial_flownet_c"]["ranks"]
    vol = rows["time_volume"]["ranks"]
    checks.update({
        "spatial_grads": all(held(r) for r in sp),
        "spatial_launches": all(r["launches"] == train_launches(1)
                                for r in sp),
        "spatial_same_bits": sp[0]["grad_crc32"] == sp[1]["grad_crc32"]
        and sp[0]["total"] == sp[1]["total"],
        "spatial_exchanged": all(r["exchange"]["halo_bytes"] > 0
                                 and r["exchange"]["gather_bytes"] > 0
                                 for r in sp),
        "volume_grads": all(held(r) for r in vol),
        "volume_launches": all(r["launches"] == want_counts(
            warp_fwd=1, warp_flow_grad=1) for r in vol),
        "volume_same_bits": vol[0]["grad_crc32"] == vol[1]["grad_crc32"],
        "spatial_cli_losses": len(spatial_losses) == SPATIAL_CLI_STEPS
        and all(np.isfinite(spatial_losses)),
        "spatial_cli_launches": all(
            s["kernel_launches"] == train_launches(SPATIAL_CLI_STEPS)
            for s in spatial_summaries),
        "spatial_cli_active": not any("spatial CP inactive" in m for m in
                                      rows["spatial_cli"]["warnings"])})

    def spread(r, factor=FLOAT32_SPREAD):
        return (r["vs_float64"]
                <= factor * r["one_process_vs_float64"]
                and r["vs_float64_median"]
                <= factor * r["one_process_vs_float64_median"])

    for kind, phase in phases.items():
        # every kind's bf16 step (ROADMAP item 10.2): its distance from
        # the float64 step, its loss, its launches (the bf16 correlation
        # kernels on FlowNet-C's and FlowNet-CS's gathered rows, the
        # float32 warps), both ranks' bits, its rows exchanged; and the
        # float64 step of "spatial" and "volume", held as a family's
        rk = rows[phase]["ranks"]
        bf = [r["bfloat16"] for r in rk]
        model = context_model(check, kind)
        checks.update({
            f"{kind}_bf16_grads": all(spread(r, BF16_SPREAD) for r in bf),
            f"{kind}_bf16_rounded": all(
                BF16_SPREAD * r["vs_float64"] >= r["one_process_vs_float64"]
                and BF16_SPREAD * r["vs_float64_median"]
                >= r["one_process_vs_float64_median"] for r in bf),
            f"{kind}_bf16_loss": all(
                abs(r["total"] - r["total_one_process"])
                <= BF16_LOSS_RTOL * abs(r["total_one_process"])
                for r in bf),
            f"{kind}_bf16_launches": all(
                r["launches"] == family_launches(model, dtype="bfloat16")
                for r in bf),
            f"{kind}_bf16_same_bits": bf[0]["grad_crc32"]
            == bf[1]["grad_crc32"] and bf[0]["total"] == bf[1]["total"],
            f"{kind}_bf16_exchanged": all(
                2 * r["bfloat16"]["exchange"][f"{k}_bytes"]
                == r["exchange"][f"{k}_bytes"]
                and r["bfloat16"]["exchange"][f"{k}_messages"]
                == r["exchange"][f"{k}_messages"]
                for r in rk for k in ("halo", "gather"))
            and (kind == "volume" or all(
                r["bfloat16"]["exchange"]["halo_bytes"] > 0
                and r["bfloat16"]["exchange"]["gather_bytes"] > 0
                for r in rk))})
        if kind not in families:
            checks[f"{kind}_float64_grads"] = all(
                held(r["float64"]) for r in rk)

    for kind, fam in families.items():
        # the float64 step held as spatial_flownet_c is; the float32
        # step, the main path, its loss, its distance from float64 and
        # one CRC
        fr = rows[f"spatial_{kind}"]["ranks"]
        f32 = [r["float32"] for r in fr]
        checks.update({
            f"{kind}_grads": all(held(r) for r in fr),
            f"{kind}_float32_grads": all(spread(r) for r in f32),
            f"{kind}_float32_loss": all(
                abs(r["total"] - r["total_one_process"])
                <= DDP_LOSS_RTOL * abs(r["total_one_process"]) for r in f32),
            f"{kind}_launches": all(
                r["launches"] == family_launches(fam["model"]) for r in fr),
            f"{kind}_same_bits": fr[0]["grad_crc32"] == fr[1]["grad_crc32"]
            and fr[0]["total"] == fr[1]["total"]
            and f32[0]["grad_crc32"] == f32[1]["grad_crc32"],
            f"{kind}_exchanged": all(r["exchange"]["halo_bytes"] > 0
                                     and r["exchange"]["gather_bytes"] > 0
                                     for r in fr)})
    if not all(checks.values()):
        raise AssertionError(f"ddp_flownet_c / ddp_nccl_world1 / "
                             f"spatial_flownet_c / time_volume / "
                             f"spatial_cli / the spatial families: "
                             f"{checks}")
    return ddp_row, nccl_row, rows


def elastic_drill_card(work: str, args: list = DRILL_ARGS) -> dict:
    """`python -m deepof_tpu_torch.tools.elastic_drill` on the card
    (DRILL_ARGS): its JSON verdict must read completed, one re-form, one
    lost host, the final checkpoint verified and `tail` rc 5. Each
    host's launches are the sum of its incarnations' summaries
    (host-<i>/stdout.log; the SIGKILLed one writes none): the five
    float32 kernels once a step, nothing else."""
    t0 = time.monotonic()
    log_dir = os.path.join(work, "elastic")
    res = subprocess.run(
        [sys.executable, "-m", "deepof_tpu_torch.tools.elastic_drill",
         *args, "--log-dir", log_dir], capture_output=True,
        text=True, timeout=660,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    verdict = json.loads(res.stdout) if res.stdout.strip() else {}
    hosts = {}
    for i in range(3):
        path = os.path.join(log_dir, f"host-{i}", "stdout.log")
        runs = []
        if os.path.exists(path):
            with open(path) as f:
                for ln in f:
                    if ln.startswith("{\"") and "kernel_launches" in ln:
                        runs.append(json.loads(ln)["kernel_launches"])
        hosts[f"host-{i}"] = {
            "incarnations": len(runs),
            "launches": {k: sum(r[k] for r in runs) for k in
                         (runs[0] if runs else {})}}
    keys = ("completed", "rc", "generation", "reforms", "lost_hosts",
            "steps_lost", "resumed_step", "max_step", "recovery_wall_s",
            "wall_s", "ckpt_ok", "tail_rc")
    row = {"seconds": time.monotonic() - t0,
           "verdict": {k: verdict.get(k) for k in keys},
           "hosts": hosts}
    emit("elastic_drill", **row)
    survivors = [hosts["host-0"], hosts["host-2"]]
    checks = {
        "verdict": res.returncode == 0 and verdict.get("completed") is True
        and verdict.get("reforms") == 1 and verdict.get("lost_hosts") == 1
        and verdict.get("max_step") == 10 and verdict.get("ckpt_ok") is True
        and verdict.get("tail_rc") == 5,
        "launches": all(
            h["incarnations"] == 2 and h["launches"]
            == train_launches(h["launches"]["corr"])
            and h["launches"]["corr"] > 0 for h in survivors)}
    if not all(checks.values()):
        raise AssertionError(f"elastic_drill: {checks} "
                             f"{res.stderr[-2000:]}")
    return row


class Prewrite:
    """Write the Sintel tree (`write_sintel`) on a thread while the main
    thread waits on the kernels' nvcc build, into a directory under
    `build/`; `move_into(work)` hands it to the run's directory for
    `cli_sintel` (and the later Sintel phases), `cleanup` removes what is
    left. Joined before any timing starts."""

    def __init__(self):
        self.dir = tempfile.mkdtemp(prefix="chip_smoke_fixtures-",
                                    dir=work_root())
        self.seconds = None
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        t0 = time.monotonic()
        try:
            write_sintel(os.path.join(self.dir, "sintel"))
        except BaseException as e:  # re-raised on the main thread
            self.error = e
        self.seconds = time.monotonic() - t0

    def join(self):
        self._thread.join()
        if self.error is not None:
            raise self.error

    def move_into(self, work: str) -> None:
        os.rename(os.path.join(self.dir, "sintel"),
                  os.path.join(work, "sintel"))

    def cleanup(self):
        self._thread.join()
        shutil.rmtree(self.dir, ignore_errors=True)


def untimed(fn, *args):
    """`fn(*args)`, an untimed check that main runs while a process
    boots, spanned in the timeline; then what it held on the card is
    freed for the booting process."""
    import gc

    import torch

    with spanned(f"untimed {fn.__name__}"):
        row = fn(*args)
    gc.collect()
    torch.cuda.empty_cache()
    return row


def clear_in_background(work: str, keep: tuple = ()) -> threading.Thread:
    """Remove what `work` holds now (the earlier phases' runs: GBs of
    checkpoints) but the names in `keep` on a thread, while the
    subprocess phases that follow run; the final cleanup then has only
    their own directories left."""
    names = [os.path.join(work, n) for n in os.listdir(work)
             if n not in keep]

    def run():
        for path in names:
            if os.path.isdir(path) and not os.path.islink(path):
                shutil.rmtree(path, ignore_errors=True)
            else:
                try:
                    os.remove(path)
                except OSError:
                    pass

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return thread


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig)
    from deepof_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    emit("device", name=card, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.monotonic()
    prewrite = Prewrite()  # the Sintel tree, beside the nvcc build
    try:
        info = build.build_all()
        prewrite.join()  # before any timing
    except BaseException:
        prewrite.cleanup()
        raise
    emit("build", seconds=time.monotonic() - t0,
         sintel_fixture_s=prewrite.seconds,
         seconds_by_source={k: v["seconds"] for k, v in info.items()},
         libraries={k: v["path"] for k, v in info.items()},
         ptxas={k: [ln.strip() for ln in v["log"].splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill"))]
                for k, v in info.items()})

    cfg = ExperimentConfig(model="flownet_c")  # full width, paper geometry
    b, (h, w) = cfg.serve.max_batch, cfg.data.image_size
    full = check_corr((b, 256, h // 8, w // 8), cfg.corr_max_disp,
                      cfg.corr_stride, seed=0, bitwise=True)
    # the smaller bucket that brownout L2 folds requests into
    # (serve_autoscale)
    half = check_corr((b, 256, h // 16, w // 16), cfg.corr_max_disp,
                      cfg.corr_stride, seed=23, bitwise=True)
    check_corr((3, 40, 13, 17), 4, 1, seed=1)  # ragged
    # the forward and backward at the training shape (batch 4); the
    # backward also ragged, at stride 4 and at max_disp 0
    train_fwd = check_corr((cfg.data.batch_size, 256, h // 8, w // 8),
                           cfg.corr_max_disp, cfg.corr_stride, seed=10,
                           bitwise=True)
    bwd = check_corr_bwd((cfg.data.batch_size, 256, h // 8, w // 8),
                         cfg.corr_max_disp, cfg.corr_stride, seed=11,
                         bitwise=True)
    check_corr_bwd((3, 40, 13, 17), 4, 1, seed=12, timed=False)
    check_corr_bwd((2, 24, 9, 36), 8, 4, seed=13, timed=False)
    check_corr_bwd((2, 3, 10, 20), 0, 1, seed=14, timed=False)
    # their bf16 paths (train.compute_dtype=bfloat16) at the training
    # shape and the same small cases
    train_shape = (cfg.data.batch_size, 256, h // 8, w // 8)
    fwd_bf16 = check_corr(train_shape, cfg.corr_max_disp, cfg.corr_stride,
                          seed=15, bitwise=True, dtype="bfloat16")
    check_corr((3, 40, 13, 17), 4, 1, seed=16, dtype="bfloat16")
    bwd_bf16 = check_corr_bwd(train_shape, cfg.corr_max_disp,
                              cfg.corr_stride, seed=17, bitwise=True,
                              dtype="bfloat16")
    for i, (shape, disp, stride) in enumerate((
            ((3, 40, 13, 17), 4, 1), ((2, 24, 9, 36), 8, 4),
            ((2, 3, 10, 20), 0, 1))):
        check_corr_bwd(shape, disp, stride, seed=18 + i, timed=False,
                       dtype="bfloat16")

    # one reading each: the six levels' time is read off their one
    # launch (check_warp_levels); these rows give the per-level split
    warp_rows = [check_warp(shape, 5.0, seed=2 + i, rounds=1)
                 for i, shape in enumerate(WARP_LEVELS)]
    check_warp((3, 5, 13, 70), 3.0, seed=8, rounds=1)  # ragged
    # saturates at the border
    check_warp((4, 3, 48, 64), 200.0, seed=9, rounds=1)
    check_warp_nonfinite()
    fused = check_warp_levels()
    # the six levels of the Sintel volume loss: 36 folded pairs
    volume = check_warp_volume()
    # the bf16-image instances (loss.gather_dtype=bfloat16) on every route
    # at FlowNet-S's six loss levels and at the Sintel volume's
    warp_bf16 = check_warp_levels_bf16()
    warp_bf16_volume = check_warp_levels_bf16(
        VOLUME_LEVELS, seed=61, kernel="warp_volume_bf16", timed=("auto",))

    serve_row, corr_launches = serve(cfg)
    # the warm start's warp: one level at input resolution, batch 8, on
    # flows like the warm path's and on huge ones
    serve_warp = check_warp((b, 3, h, w), 4.0, seed=30, bitwise=True,
                            smooth=True)
    check_warp((b, 3, h, w), 200.0, seed=31, rounds=1, bitwise=True)
    # the quality scorer's warp: frame 2 by one served flow on FlowNet-C's
    # head grid (h/4, w/4)
    quality_warp = check_warp((1, 3, h // 4, w // 4), 4.0, seed=32,
                              rounds=1, bitwise=True)
    tiers_row = serve_tiers(cfg)
    stream_row = serve_stream(cfg)
    serve_bench_row = serve_bench_phase()
    http_row = serve_http(cfg)
    work = tempfile.mkdtemp(prefix="chip_smoke-", dir=work_root())
    prewrite.move_into(work)
    warmup = None
    clearing = None
    later: list = []  # serving processes started ahead of their phase
    try:
        train_row = train(ExperimentConfig(
            data=DataConfig(dataset="synthetic"),
            train=TrainConfig(log_dir=os.path.join(work, "train"))))
        cli_row = cli_train(work)
        resume_row = cli_resume(work)
        fit_profile(work)
        chairs_row = cli_flyingchairs(work)
        eval_row = cli_eval_predict(work)
        corr_train = {m: train_corr_model(m, work)
                      for m in ("flownet_c", "flownet_cs")}
        cli_c_row = cli_train_flownet_c(work)
        ledger_row = ledger_gate(work, http_row)
        bf16_train = train_corr_model("flownet_c", work, "bfloat16")
        cli_bf16_row = cli_train_flownet_c_bf16(work)
        gather_row = cli_train_gather_bf16(work)
        sintel_row = cli_sintel(work, prewrite.seconds)
        job_row = cli_train_job(work)
        preempt_row = cli_preempt_faults(work)
        # Inception-v3 ahead of the serving phases: its F17 check runs
        # while serve_fleet's replicas boot
        inception_row = cli_train_inception(work)
        # the artifact store's single writer runs beside cli_serve, and
        # st_single's kernel against plain step while it boots
        warmup = start_warmup_serve(work)
        serve_cli_row = cli_serve(
            work, os.path.join(work, "cli_train_job_k2"),
            while_booting=lambda: untimed(ucf101_step_vs_plain, work))
        artifacts_row = publish_artifacts(work, warmup=warmup)
        # F17's fresh process, the store's corrupted-copy checks and
        # VGG16Flow's kernel against plain step run while serve_fleet's
        # replicas boot
        served = os.path.join(work, "cli_train_job_k2")

        def fleet_booting():
            f17 = f17_engine(work, inception_row)
            untimed(artifacts_corrupt, work, artifacts_row)
            untimed(vgg_step_vs_plain, work)
            f17()

        # serve_autoscale's fleet starts once serve_fleet's has drained:
        # its first replica boots beside serve_fleet's reference, verbs
        # and checks, Inception-v3's kernel against plain steps and
        # FlowNet-CS's repeats
        fleet_row = serve_fleet(work, served,
                                artifacts=artifacts_row["store"],
                                while_booting=fleet_booting,
                                after_drain=lambda: later.append(
                                    spawn_autoscale(work, served)))
        untimed(inception_vs_plain, work)
        untimed(repeat_flownet_cs, work)
        autoscale_row = serve_autoscale(work, served, later[0])
        sintel_inc_row = cli_sintel_inception(work)
        bench_row = cli_bench(work)
        vgg_row = cli_train_vgg(work)
        ucf_row = cli_train_ucf101(work)
        # ddp_phases' first group boots beside cli_recipe's untimed
        # predict and verbs; the earlier runs are removed meanwhile
        group: dict = {}
        recipe_row = cli_recipe(work, before_tail=lambda: group.update(
            start_ddp_group(work)))
        later += [p for k in ("cli", "spatial_cli", "nccl")
                  for p in group[k][0]]
        later += [group["probe"]] if group["probe"] is not None else []
        torch.cuda.empty_cache()  # the subprocesses share the card
        clearing = clear_in_background(work, keep=DDP_GROUP_DIRS)
        ddp_row, nccl_row, context_rows = ddp_phases(work, clearing=clearing,
                                                     group=group)
        drill_row = elastic_drill_card(work)
    finally:
        if warmup is not None and warmup[0].poll() is None:
            warmup[0].kill()  # a phase before publish_artifacts failed
            warmup[0].wait()
        for proc in later:  # a phase between its start and its own failed
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if clearing is not None:
            clearing.join()
        shutil.rmtree(work, ignore_errors=True)
        prewrite.cleanup()
    # launches of each warp kernel on each training path, counted from 0
    # just before it; the final line's `launches` are the command line's
    paths = {"train": train_row, "cli_train": cli_row,
             "cli_resume": resume_row, "cli_flyingchairs": chairs_row}
    by_path = {key: {p: r[f"warp_{key}_launches"] for p, r in paths.items()}
               for key in ("fwd", "flow_grad")}
    # this slice's paths: Inception-v3 from the command line (train, eval
    # and predict at the flyingchairs preset, train at the sintel preset)
    # and the bench verb; no correlation kernel runs on them
    inception_paths = {
        **{f"cli_{k}_inception": v
           for k, v in inception_row["launches"].items()},
        "cli_sintel_inception": {
            "warp_fwd": sintel_inc_row["warp_fwd_launches"],
            "warp_flow_grad": sintel_inc_row["warp_flow_grad_launches"]},
        "cli_bench": bench_row["launches"]}
    # the VGG16 paths: VGG16Flow's train, eval and predict at the
    # flyingchairs_vgg preset, and its train under loss.occlusion
    inception_paths.update({f"cli_{k}_vgg": v
                            for k, v in vgg_row["launches"].items()})
    # the UCF-101 action models: st_single's train, eval and predict at
    # the ucf101 preset, a step of st_baseline and of ucf101_spatial, and
    # the UCF-101 loader's bench
    inception_paths.update({f"cli_{k}_ucf101": v
                            for k, v in ucf_row["launches"].items()})
    # the staged recipe (`train --recipe`): each stage's fit, Inception-v3
    # on the Chairs mixture and on Sintel volumes, then st_single
    inception_paths.update({
        f"cli_recipe_{st['stage']}": {"warp_fwd": 0, "warp_flow_grad": 0,
                                      **st["launches"]}
        for st in recipe_row["stages"]})
    for p, k in inception_paths.items():
        by_path["fwd"][p] = k["warp_fwd"]
        by_path["flow_grad"][p] = k["warp_flow_grad"]
    by_path["fwd"]["cli_eval"] = eval_row["eval_warp_fwd_launches"]
    # and of the correlation kernels (with the warps on FlowNet-C/CS
    # training): the serving run, the FlowNet-C and FlowNet-CS training
    # phases, and the FlowNet-C command line's train, eval and predict
    corr_paths = {f"train_{m}": r["launches"] for m, r in corr_train.items()}
    corr_paths.update({f"cli_{k}_flownet_c": v
                       for k, v in cli_c_row["launches"].items()})
    corr_paths["train_flownet_c_bf16"] = bf16_train["launches"]
    corr_paths.update({f"cli_{k}_flownet_c_bf16": v
                       for k, v in cli_bf16_row["launches"].items()})
    # the training job's paths: at 2 steps a call, at 1 and under
    # remat, and the uninterrupted run of the preemption phase
    corr_paths.update({f"cli_train_job_{name}": r["launches"]
                       for name, r in job_row["runs"].items()})
    corr_paths["cli_preempt_faults"] = preempt_row["launches"]
    # data parallelism and the elastic pool, each process's own counts:
    # the two ranks' check step, their `train --multihost` run, the NCCL
    # rank, and each surviving elastic host's incarnations summed
    for r in ddp_row["check"]["ranks"]:
        corr_paths[f"ddp_flownet_c_check_rank{r['rank']}"] = r["launches"]
    for r, s in enumerate(ddp_row["cli"]["ranks"]):
        corr_paths[f"ddp_flownet_c_rank{r}"] = s["kernel_launches"]
    corr_paths["ddp_nccl_world1"] = nccl_row["kernel_launches"]
    # spatial and temporal context parallelism, in the same two ranks:
    # each spatial rank's step (the correlation on full-height operands),
    # each time rank's (the warps on its half of the pairs), and the
    # ranks of `train --multihost --set mesh.spatial=2`
    # (and, since item 10.1, every other family's spatial ranks)
    # (and, since item 10.2, each kind's step in bf16 compute: the bf16
    # correlation kernels on FlowNet-C's and FlowNet-CS's gathered rows)
    for phase in ("spatial_flownet_c", "time_volume",
                  *(f"spatial_{k}" for k in CONTEXT["families"])):
        for r in context_rows[phase]["ranks"]:
            corr_paths[f"{phase}_rank{r['rank']}"] = r["launches"]
            corr_paths[f"{phase}_bf16_rank{r['rank']}"] = r["bfloat16"][
                "launches"]
    for r, s in enumerate(context_rows["spatial_cli"]["ranks"]):
        corr_paths[f"spatial_cli_rank{r}"] = s["kernel_launches"]
    for h in ("host-0", "host-2"):
        corr_paths[f"elastic_drill_{h}"] = drill_row["hosts"][h]["launches"]
    for key, counter in (("fwd", "warp_fwd"),
                         ("flow_grad", "warp_flow_grad")):
        by_path[key].update({p: c[counter] for p, c in corr_paths.items()})
    corr_by_path = {c.name: {p: n.get(c.name, 0) for p, n in
                             {**corr_paths, **inception_paths}.items()}
                    for c in corr_counters()}
    corr_by_path["corr"]["serve"] = corr_launches
    corr_by_path["corr"].update({f"serve_tiers_{t}": r["corr_launches"]
                                 for t, r in tiers_row["tiers"].items()})
    corr_by_path["corr_bf16"].update({
        f"serve_tiers_{t}": r["corr_bf16_launches"]
        for t, r in tiers_row["tiers"].items()})
    corr_by_path["corr"]["serve_stream"] = stream_row["corr_launches"]
    by_path["fwd"]["serve_stream"] = stream_row["warp_fwd_launches"]
    # this slice's paths: the serving benchmark's modes
    # (tools/serve_bench.py), each counted from 0 just before it
    for mode, k in serve_bench_row["launches"].items():
        for c in corr_by_path:
            corr_by_path[c][f"serve_bench_{mode}"] = k[c]
        by_path["fwd"][f"serve_bench_{mode}"] = k["warp_fwd"]
        by_path["flow_grad"][f"serve_bench_{mode}"] = k["warp_flow_grad"]
    # this slice's serving path: POST /v1/flow and /v1/flow/stream
    corr_by_path["corr"]["serve_http"] = http_row["launches"]["corr"]
    by_path["fwd"]["serve_http"] = http_row["launches"]["warp_fwd"]
    # this slice's path: the fleet's replica processes, from their final
    # records (launches after engine.warm(); a SIGKILLed one writes none)
    fleet_launches = {
        "serve_single": fleet_row["single"]["kernel_launches"],
        **{f"serve_fleet_replica_{i}": r["kernel_launches"]
           for i, r in fleet_row["replicas"].items()},
        **{f"serve_autoscale_replica_{i}": r["kernel_launches"]
           for i, r in autoscale_row["replicas"].items()}}
    for p, k in fleet_launches.items():
        corr_by_path["corr"][p] = k["corr"]
        corr_by_path["corr_bf16"][p] = k["corr_bf16"]
        by_path["fwd"][p] = k["warp_fwd"]
    # this slice's path: the Sintel volumes from the command line
    for route, r in sintel_row["routes"].items():
        by_path["fwd"][f"cli_sintel_{route}"] = r["warp_fwd_launches"]
        by_path["flow_grad"][f"cli_sintel_{route}"] = \
            r["warp_flow_grad_launches"]
    by_path["fwd"]["cli_sintel_eval"] = sintel_row["eval"]["warp_fwd_launches"]
    # the float32 kernels' main path: the training job (K = 2)
    main_path = job_row["runs"]["k2"]["launches"]
    # the bf16 kernels' main path: FlowNet-C's `train` in bf16 compute
    bf16_path = cli_bf16_row["launches"]["train"]

    sources = {"corr": ("deepof_tpu_torch/csrc/corr.cu",
                        "deepof_tpu/ops/pallas/corr.py:46"),
               "corr_bwd_f1": ("deepof_tpu_torch/csrc/corr_bwd.cu",
                               "deepof_tpu/ops/pallas/corr.py:167")}
    sources["corr_bwd_f2"] = sources["corr_bwd_f1"]
    checks = {"float32": (train_fwd, bwd), "bfloat16": (fwd_bf16, bwd_bf16)}

    def corr_entry(kernel, dtype):
        # the main path's shape (training, batch 4): FlowNet-C's `train`
        # on the command line in `dtype`, with its per-step launches from
        # the training phase of that dtype; float32's serving shape
        # (batch 8) with its own launches nested
        name = kernel + DTYPES[dtype]
        fwd_row, bwd_row = checks[dtype]
        row = fwd_row if kernel == "corr" else bwd_row
        one = row if kernel == "corr" else row[kernel]
        bf16 = dtype == "bfloat16"
        path = bf16_path if bf16 else main_path
        steps = bf16_train if bf16 else corr_train["flownet_c"]
        entry = {"name": name, "route": "cuda",
                 "source": sources[kernel][0],
                 "replaces": sources[kernel][1], "dtype": dtype,
                 "launches": path[name],
                 "launches_by_path": corr_by_path[name],
                 "launches_per_step": steps["launches_per_step"][name],
                 "shape": row["shape"],
                 **{k: one[k] for k in (
                     "max_abs_err", "rel_err", "max_ulps", "bitwise_equal",
                     "equals_f32_kernel_rounded", "ms", "ms_runs", "ptxas")
                    if k in one},
                 **{k: row[k] for k in (
                     "bitwise_repeatable", "call_ms", "plain_ms",
                     "bound_ms", "bound_by") if k in row},
                 "library_ms": None,
                 "library_note": "no single PyTorch call computes a "
                                 "correlation cost volume or its gradient"}
        if kernel != "corr":
            entry["plain_note"] = ("correlation_backward_reference, both "
                                   "gradients in one call")
        elif not bf16:
            entry["serve_shape"] = {
                "launches": corr_launches,
                "launches_per_dispatch": (corr_launches
                                          / serve_row["dispatches"]),
                "launches_by_tier": {
                    t: {"launches": r["corr_launches"],
                        "dispatches": r["dispatches"]}
                    for t, r in tiers_row["tiers"].items()},
                "launches_in_stream": {
                    "launches": stream_row["corr_launches"],
                    "cold_dispatches": stream_row["dispatches"]["cold"]},
                "launches_over_http": {
                    "launches": http_row["launches"]["corr"],
                    "dispatches": http_row["dispatches"]},
                "launches_in_fleet_replicas": {
                    p: n for p, n in corr_by_path["corr"].items()
                    if p.startswith(("serve_single", "serve_fleet",
                                     "serve_autoscale"))},
                "serve_half_bucket": {k: half[k] for k in (
                    "shape", "max_abs_err", "bitwise_equal", "ms",
                    "plain_ms", "bound_ms")},
                **{k: full[k] for k in ("shape", "max_abs_err", "ms",
                                        "call_ms", "plain_ms", "bound_ms",
                                        "bound_by")}}
        return entry

    def warp_entry(name, key):
        # the one launch over the six main-path levels, with the one-level
        # launches of each level beside it
        rows = [r[key] for r in warp_rows]
        one = fused[key]
        return {
            "name": name, "route": "cuda",
            "source": "deepof_tpu_torch/csrc/warp.cu",
            "replaces": replaces[name],
            "launches": by_path[key]["cli_train_job_k2"],
            "launches_by_path": by_path[key],
            "launches_per_step": by_path[key]["train"] / TRAIN_STEPS,
            "max_abs_err": one["max_abs_err"],
            "ms": one["ms"], "ms_runs": one["ms_runs"],
            "plain_ms": one["plain_ms"],
            "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
            "library_ms": one["library_ms"],
            "library_ms_runs": one["library_ms_runs"],
            "library": "six F.grid_sample(bilinear, border, "
                       "align_corners=True) calls"
                       + ("" if key == "fwd" else ", autograd.grad wrt grid"),
            "shape": [list(s) for s in WARP_LEVELS],
            "call_ms": one["call_ms"],
            "per_level": [{"shape": w["shape"], **{k: r[k] for k in (
                "ms", "ms_runs", "call_ms", "plain_ms", "library_ms",
                "library_ms_runs", "bound_ms")}}
                for w, r in zip(warp_rows, rows)],
            "volume_shape": {
                "shape": [r["shape"] for r in volume["levels"]],
                "launches": by_path[key]["cli_sintel_cached"],
                "steps": SINTEL_STEPS,
                "bitwise_equal": volume[key]["bitwise_equal"],
                **{k: volume[key][k] for k in (
                    "max_abs_err", "ms", "ms_runs", "call_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by",
                    "smooth_flow_ms")}},
            "inception_shape": {
                "shape": [list(s) for s in INCEPTION_LEVELS],
                "launches": by_path[key]["cli_train_inception"],
                "steps": INCEPTION_STEPS,
                **inception_row["warp_levels"][key]},
            "sintel_inception_shape": {
                "launches": by_path[key]["cli_sintel_inception"],
                "steps": SINTEL_STEPS,
                **sintel_inc_row["warp_volume"][key],
                "shape": sintel_inc_row["warp_volume"]["shape"]},
            "bench_shape": {
                "shape": [list(s) for s in BENCH_LEVELS],
                "launches": by_path[key]["cli_bench"],
                **bench_row["warp_levels"][key]},
            "vgg_shape": {
                "shape": [list(s) for s in VGG_LEVELS],
                "launches": by_path[key]["cli_train_vgg"],
                "steps": VGG_STEPS,
                "launches_eval": by_path[key]["cli_eval_vgg"],
                **vgg_row["warp_levels"][key]},
            "ucf101_shape": {
                "shape": [list(s) for s in UCF_LEVELS],
                "launches": by_path[key]["cli_train_ucf101"],
                "steps": UCF_STEPS,
                "launches_eval": by_path[key]["cli_eval_ucf101"],
                **ucf_row["warp_levels"][key]},
            "recipe_stages": {
                st["stage"]: {"launches": by_path[key][
                    f"cli_recipe_{st['stage']}"], "steps": st["steps"],
                    "eval_forwards": st["eval_forwards"]}
                for st in recipe_row["stages"]},
            "ucf101_baseline_shape": {
                "shape": [list(s) for s in UCF_BASELINE_LEVELS],
                "launches": by_path[key]["cli_train_st_baseline_ucf101"],
                "steps": 1,
                **ucf_row["warp_levels_baseline"][key]},
            **({"serve_shape": {
                "shape": serve_warp["shape"],
                "launches": stream_row["warp_fwd_launches"],
                "warm_dispatches": stream_row["dispatches"]["warm"],
                "launches_over_http": http_row["launches"]["warp_fwd"],
                "launches_in_fleet_replicas": {
                    p: n for p, n in by_path["fwd"].items()
                    if p.startswith(("serve_single", "serve_fleet",
                                     "serve_autoscale"))},
                "serve_half_bucket": {k: half[k] for k in (
                    "shape", "max_abs_err", "bitwise_equal", "ms",
                    "plain_ms", "bound_ms")},
                "bitwise_equal": serve_warp["fwd"]["bitwise_equal"],
                **{k: serve_warp["fwd"][k] for k in (
                    "max_abs_err", "ms", "ms_runs", "call_ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by")}}}
               if key == "fwd" else {})}

    replaces = {"warp_fwd": "deepof_tpu/ops/pallas/warp.py:85",
                "warp_flow_grad": "deepof_tpu/ops/pallas/warp.py:111"}

    def site_entry(name, row_key, launches, path, shape, note):
        # the forward kernel at a data site (augmentation, occlusion),
        # its launches on that site's own counter
        # (ops/cuda/warp.py::SITE_COUNTERS)
        one = vgg_row[row_key]
        return {"name": name, "route": "cuda", "kernel": "warp_fwd",
                "source": "deepof_tpu_torch/csrc/warp.cu",
                "replaces": replaces["warp_fwd"],
                "launches": launches, "path": path,
                "shape": shape, "note": note,
                **{k: one[k] for k in (
                    "max_abs_err", "bitwise_equal", "ms", "ms_runs",
                    "call_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")},
                "library": f"{len(shape)} F.grid_sample(bilinear, border, "
                           "align_corners=True) calls"}
    def bf16_entry(name, key):
        # the bf16 instances: the main path `train --set
        # loss.gather_dtype=bfloat16` (warp_impl auto), timed at
        # FlowNet-S's six levels on that route; the XLA route and the
        # Sintel volume's levels beside it
        auto = warp_bf16["routes"]["auto"][key]
        return {
            "name": name, "route": "cuda",
            "source": "deepof_tpu_torch/csrc/warp.cu",
            "replaces": replaces[name.replace("_bf16", "")],
            "dtype": "bfloat16",
            "launches": gather_row["runs"]["auto"]["launches"][name],
            "launches_by_path": {
                f"cli_train_gather_bf16_{impl}": r["launches"][name]
                for impl, r in gather_row["runs"].items()},
            "launches_per_step": 1,
            "shape": warp_bf16["shape"],
            "pallas_levels": warp_bf16["routes"]["auto"]["pallas_levels"],
            "bitwise_equal": all(e["bitwise_equal"] for e in
                                 warp_bf16["routes"].values()),
            **{k: auto[k] for k in (
                "max_abs_err", "ms", "ms_runs", "call_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_ms_runs")},
            "library": warp_bf16["library"],
            "xla_route": {k: warp_bf16["routes"]["xla"][key][k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
            "volume_shape": {
                "shape": warp_bf16_volume["shape"],
                "bitwise_equal": all(e["bitwise_equal"] for e in
                                     warp_bf16_volume["routes"].values()),
                **{k: warp_bf16_volume["routes"]["auto"][key][k] for k in (
                    "ms", "plain_ms", "library_ms", "bound_ms",
                    "bound_by")}}}

    emit("ledger", flownet_c_train_step=ledger_row["flownet_c_train_step"],
         flownet_c_serve_f32_cold=ledger_row["flownet_c_serve_f32_cold"],
         trace_s={"cli_train": cli_row["ledger_trace_s"],
                  "cli_train_flownet_c": ledger_row["flownet_c_trace_s"],
                  "serve_http_warm": http_row["ledger_trace_s"]},
         boot=fleet_row["boot"], boot_single=fleet_row["single"]["boot"])
    emit("timeline", spans=TIMELINE)
    emit("total", seconds=time.monotonic() - START,
         phase_seconds={"serve_bench": serve_bench_row["seconds"],
                        "cli_train_job": job_row["seconds"],
                        "cli_preempt_faults": preempt_row["seconds"],
                        "serve_http": http_row["seconds"],
                        "cli_train_gather_bf16": gather_row["seconds"],
                        "cli_serve": serve_cli_row["seconds"],
                        "serve_fleet": fleet_row["seconds"],
                        "serve_autoscale": autoscale_row["seconds"],
                        "cli_train_inception": inception_row["seconds"],
                        "cli_sintel_inception": sintel_inc_row["seconds"],
                        "cli_bench": bench_row["seconds"],
                        "cli_train_vgg": vgg_row["seconds"],
                        "cli_train_ucf101": ucf_row["seconds"],
                        "cli_recipe": recipe_row["seconds"],
                        "ddp_flownet_c": ddp_row["seconds"],
                        "ddp_nccl_world1": nccl_row["seconds"],
                        "spatial_cli": context_rows["spatial_cli"][
                            "seconds"],
                        "elastic_drill": drill_row["seconds"]})
    print(json.dumps({"kernels": [
        *(corr_entry(k, dtype) for dtype in DTYPES for k in CORR_KERNELS),
        warp_entry("warp_fwd", "fwd"),
        warp_entry("warp_flow_grad", "flow_grad"),
        bf16_entry("warp_fwd_bf16", "fwd"),
        bf16_entry("warp_flow_grad_bf16", "flow_grad"),
        {"name": "warp_fwd_quality", "route": "cuda", "kernel": "warp_fwd",
         "source": "deepof_tpu_torch/csrc/warp.cu",
         "replaces": replaces["warp_fwd"],
         "launches": http_row["quality"]["warp_fwd_quality_launches"],
         "path": "serve_http (obs.quality_sample_rate=0.5): one launch a "
                 "scored request",
         "launches_by_path": {
             "serve_http": http_row["quality"]["warp_fwd_quality_launches"],
             **{f"serve_bench_{m}": k["warp_fwd_quality"]
                for m, k in serve_bench_row["launches"].items()}},
         "launches_total": http_row["quality"][
             "warp_fwd_quality_launches_total"],
         "shape": quality_warp["shape"],
         "bitwise_equal": quality_warp["fwd"]["bitwise_equal"],
         **{k: quality_warp["fwd"][k] for k in (
             "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
             "bound_by", "library_ms")},
         "library": "one F.grid_sample(bilinear, border, "
                    "align_corners=True) call"},
        site_entry("warp_fwd_augment", "warp_augment",
                   vgg_row["launches"]["train"]["warp_fwd_augment"],
                   "cli_train_vgg", [list(AUGMENT_SHAPE)] * 2,
                   "the augmentation's resample of the source and target "
                   "frames, one launch a staged batch; flows of the "
                   "preset's sampled parameters (scale 2.0, flip, 17 "
                   "degrees included)"),
        site_entry("warp_fwd_occlusion", "warp_occlusion",
                   vgg_row["launches"]["train_occlusion"][
                       "warp_fwd_occlusion"],
                   "cli_train_vgg (--set loss.occlusion=true)",
                   [[b, 2, h, w] for b, _, h, w in VGG_LEVELS],
                   "the occlusion mask's warp of the backward flows (C = "
                   "2, the generic instance) by the forward ones, VGG's "
                   "five levels in one launch")]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def deterministic_cli(argv: list[str]) -> int:
    """`deepof_tpu_torch.cli.main(argv)` under cuDNN's deterministic
    algorithms (`ddp_nccl_world1`'s NCCL rank, beside a plain run in the
    same mode)."""
    import torch

    from deepof_tpu_torch import cli

    torch.backends.cudnn.deterministic = True
    return cli.main(argv)


if __name__ == "__main__":
    if sys.argv[1:2] == ["ddp_rank"]:  # one rank of ddp_flownet_c's check
        sys.exit(ddp_rank(sys.argv[2]))
    if sys.argv[1:2] == ["gloo_probe"]:  # gloo's collectives on the card
        sys.exit(gloo_cuda_probe())
    if sys.argv[1:2] == ["deterministic_cli"]:
        sys.exit(deterministic_cli(sys.argv[2:]))
    sys.exit(main())
