"""Chip smoke test of the PyTorch/CUDA port (`deepof_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a: H100) and the CUDA toolkit's nvcc. Builds
every CUDA kernel from `deepof_tpu_torch/csrc` into `build/`, checks each
against its plain PyTorch version on the card, then serves FlowNet-C at
full width through `InferenceEngine` and checks that the main path went
through the kernels. Each phase prints one JSON line; the last two lines
are the kernel summary and the card's name and power limit, and the very
last line is {"ok": true, "device": {...}}. Any failure exits non-zero
with no such line; so does a host without a GPU.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

# Data-sheet peaks of one H100 SXM (dense): float32 outside the tensor
# cores, and HBM3 bandwidth. The bound of a kernel is the larger of its
# operations over the first and its bytes over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

KERNEL_TOL = 1e-4  # kernel vs plain version, float32 (summation order)
SERVE_TOL = 1e-3   # served raw flow vs the same model with the plain corr


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


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


def corr_bound_ms(b, c, h, w, n) -> tuple[float, str]:
    flops = 2.0 * b * h * w * n * n * c
    nbytes = 4.0 * (2 * b * c * h * w + b * n * n * h * w)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def check_corr(shape, max_disp, stride, seed):
    """Kernel vs correlation_reference on the card at one NCHW shape."""
    import torch

    from deepof_tpu_torch.ops.corr import correlation_reference
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    f1 = torch.randn(shape, device="cuda", generator=g)
    f2 = torch.randn(shape, device="cuda", generator=g)
    got = correlation_cuda(f1, f2, max_disp, stride)
    want = correlation_reference(f1, f2, max_disp, stride)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    b, c, h, w = shape
    n = 2 * (max_disp // stride) + 1
    bound, bound_by = corr_bound_ms(b, c, h, w, n)
    row = {"shape": list(shape), "max_disp": max_disp, "stride": stride,
           "max_abs_err": err,
           "kernel_ms": time_ms(lambda: correlation_cuda(f1, f2, max_disp,
                                                         stride)),
           "plain_ms": time_ms(lambda: correlation_reference(
               f1, f2, max_disp, stride), warmup=1, iters=5),
           "bound_ms": bound, "bound_by": bound_by}
    emit("kernels", kernel="corr", **row)
    if not err <= KERNEL_TOL:
        raise AssertionError(f"corr kernel disagrees at {shape}: max abs "
                             f"err {err} > {KERNEL_TOL}")
    return row


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
            eng.model.corr_impl = "reference"
            try:
                want = fwd(x)
            finally:
                eng.model.corr_impl = "auto"
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
    # device-side events only (kernels and copies): an operator's own
    # row repeats the time of the kernels it launched
    kernels = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if (dev > 0 and str(e.device_type).endswith("CUDA")
                and e.key != "Activity Buffer Request"):
            kernels.append((dev / 1e3 / iters, e.key))
    kernels.sort(reverse=True)
    busy = sum(t for t, _ in kernels)
    corr = sum(t for t, k in kernels if "corr_fwd" in k)
    emit("profile", bucket=list(bucket), batch=int(x.shape[0]), host=host,
         dispatch_ms=dispatch_ms, device_time_visible=busy > 0,
         device_busy_ms=busy, corr_ms=corr,
         corr_share_of_busy=(corr / busy) if busy else None,
         idle_share_of_dispatch=(1 - busy / dispatch_ms) if busy else None,
         top=[{"ms": t, "name": k[:90]} for t, k in kernels[:10]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from deepof_tpu_torch.core.config import ExperimentConfig
    from deepof_tpu_torch.ops.cuda import build

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    t0 = time.monotonic()
    info = {name: build.build(name) for name in build.SOURCES}
    emit("build", seconds=time.monotonic() - t0,
         libraries={k: v["path"] for k, v in info.items()},
         ptxas={k: [ln for ln in v["log"].splitlines() if "registers" in ln
                    or "spill" in ln] for k, v in info.items()})

    cfg = ExperimentConfig(model="flownet_c")  # full width, paper geometry
    b, (h, w) = cfg.serve.max_batch, cfg.data.image_size
    full = check_corr((b, 256, h // 8, w // 8), cfg.corr_max_disp,
                      cfg.corr_stride, seed=0)
    check_corr((3, 40, 13, 17), 4, 1, seed=1)  # ragged

    serve_row, corr_launches = serve(cfg)

    print(json.dumps({"kernels": [{
        "name": "corr",
        "route": "cuda",
        "source": "deepof_tpu_torch/csrc/corr.cu",
        "replaces": "deepof_tpu/ops/pallas/corr.py:46",
        "launches": corr_launches,
        "launches_per_dispatch": corr_launches / serve_row["dispatches"],
        "max_abs_err": full["max_abs_err"],
        "ms": full["kernel_ms"],
        "kernel_ms": full["kernel_ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": full["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes a correlation "
                        "cost volume"}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
