"""The port's serving benchmark (`deepof_tpu_torch/tools/serve_bench.py`)
against the JAX package's `tools/serve_bench.py`, loaded by importlib as
the JAX package's own tests load it, both on the CPU.

Where a real model runs, both tools run the JAX tool's own weights:
`_real_model_params(cfg)` (flax's init from `PRNGKey(0)`), loaded into
the port's model by `convert.py::load_flax_params`; the warm walk's
refinement stage is the JAX engine's `refine_init_params` (gate 0),
loaded into the port's `FlowNetRefine`.

Tolerances, and why:

  - the seeded request pairs and `_coherent_walk`: bitwise.
  - `run_workload` through fake-executor engines (flows are the channel
    differences of each package's prepared pair, then `flow_to_native`):
    atol 2 x 1.5 x 3/255 + 2e-3 = 0.0373 px. It composes the tolerances
    the port's engine parity tests use on the two steps that differ:
    `tests/test_torch_serve.py::test_prepare_pair_matches_jax` (atol
    3/255 on each prepared channel: cv2's fixed-point resize against
    torch's bilinear), twice for the difference of two channels, scaled
    by flow_to_native's largest factor (native width 96 over bucket 64),
    plus `test_postprocess_and_flow_to_native_match_jax`'s atol 2e-3.
    Measured on an x86-64 CPU: 0.0054 on flows up to 1.10.
  - the stream walk's decode counts and flags: exact.
  - `precision_bench`: `weight_bytes` exact in every tier (both count
    every parameter and buffer at its stored width: the int8 tier's int8
    weights and float32 scales). `epe_vs_f32` within atol 5.7e-3 px of
    JAX's: each flow of either tier is within flow_to_native's 2e-3 of
    JAX's per component, so a mean endpoint distance moves by at most
    2 x sqrt(2) x 2e-3. Measured: 1.2e-5 (bf16) and 2.2e-5 (int8).
  - `quality_bench`'s f32 proxy means: rtol 1e-3. The scorer itself is
    held at rtol 1e-5 on the same rows (`tests/test_torch_quality.py`);
    here each package scores its own prepared rows (the resize above).
    Measured: 2.4e-4 (photo), 7.4e-5 (smooth), 2.0e-4 (census).
  - `warm_stream_bench` (the cold network at width 0.25, so it runs the
    weights drawn once for the cases above): `warm_steps` and
    `warm_cold_fallbacks` exact; `epe_vs_cold` within the same 5.7e-3 px
    as `epe_vs_f32`. Measured: 6.7e-4 (0.069075 against 0.069741).

The file takes ~46 s alone on an 8-core x86-64 host, most of it the JAX
side's op-by-op flax init and its compiles of the three tiers.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from deepof_tpu.serve import engine as jax_engine
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.models.flownet2 import FlowNetRefine
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.serve.engine import InferenceEngine, make_fake_forward
from deepof_tpu_torch.tools import serve_bench as sb

# one intra-op pool a pytest-xdist worker: the workers share the cores
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_ATOL = 2 * 1.5 * 3 / 255 + 2e-3
EPE_ATOL = 2 * np.sqrt(2) * 2e-3
QUALITY_RTOL = 1e-3
#: the JAX schema tests' small real-model workload
SMALL = dict(requests=4, gap_ms=0.0, max_batch=2, timeout_ms=5.0,
             bucket=(32, 64), native_hw=(30, 60))


@pytest.fixture(scope="module")
def jsb():
    path = os.path.join(ROOT, "tools", "serve_bench.py")
    spec = importlib.util.spec_from_file_location("serve_bench_jax", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_params(jsb):
    """The JAX tool's weights of FlowNet-S at width 0.25, and the port's
    FlowNet-S with them. A flax init draws each parameter from
    `PRNGKey(0)` by its path and shape, so they are the tool's weights
    at any image size."""
    _, params = jsb._real_model_params(
        jsb._bench_cfg(SMALL["bucket"], 2, 5.0, None))
    return params, load_flax_params(build_model(
        "flownet_s", width_mult=0.25, device="cpu"), params).eval()


def test_request_pairs_and_coherent_walk_are_jax_bits(jsb, monkeypatch):
    sent = []
    run = jsb.run_workload

    def recording(engine, requests, gap_ms, precision=None):
        sent.append(requests)
        return run(engine, requests, gap_ms, precision)

    monkeypatch.setattr(jsb, "run_workload", recording)
    jsb.serve_bench(requests=5, gap_ms=0.0, exec_ms=0.0)
    ours = sb._pairs(5, (48, 96))
    assert len(sent) == 1 and len(sent[0]) == len(ours) == 5
    for (a, b), (c, d) in zip(sent[0], ours):
        assert a.dtype == c.dtype == np.uint8
        assert np.array_equal(a, c) and np.array_equal(b, d)
    want = jsb._coherent_walk(np.random.RandomState(0), (60, 120), 5)
    got = sb._coherent_walk(np.random.RandomState(0), (60, 120), 5)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype
               for a, b in zip(want, got))


def test_run_workload_through_fake_engines_matches_jax(jsb):
    pairs = sb._pairs(8, (48, 96))
    jcfg = jsb._bench_cfg((64, 64), 4, 5.0, None)
    with jax_engine.InferenceEngine(
            jcfg, forward_fn=jax_engine.make_fake_forward(1.0)) as eng:
        _, jerr, want = jsb.run_workload(eng, pairs, 0.0)
    cfg = sb._bench_cfg((64, 64), 4, 5.0, None)
    with InferenceEngine(cfg, forward_fn=make_fake_forward(1.0),
                         device="cpu") as eng:
        _, err, got = sb.run_workload(eng, pairs, 0.0)
    assert jerr == err == 0
    for g, w in zip(got, want):
        assert g["flow"].shape == w["flow"].shape == (48, 96, 2)
        np.testing.assert_allclose(g["flow"], w["flow"], atol=FAKE_ATOL,
                                   rtol=0)


def test_stream_walk_counts_equal_jax(jsb):
    kw = dict(frames=8, decode_ms=1.0, exec_ms=1.0, max_batch=4,
              timeout_ms=2.0, warm_frames=0)
    want = jsb.stream_bench(**kw)
    got = sb.stream_bench(**kw, device="cpu")
    keys = ("frames", "flows", "errors", "stream_decodes",
            "pairwise_decodes", "decode_delta", "decode_saved",
            "session_frames", "flow_bitwise_equal")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["flow_bitwise_equal"] is True and got["decode_saved"] == 7
    assert all(got[k] is None for k in sb.STREAM_REQUIRED_KEYS
               if k.startswith(("warm_", "epe_")))


def test_precision_tiers_match_jax(jsb, small_params):
    small_model = small_params[1]
    want = jsb.precision_bench(**SMALL)
    got = sb.precision_bench(**SMALL, device="cpu", model=small_model)
    assert list(got["tiers"]) == list(want["tiers"]) \
        == ["f32", "bf16", "int8"]
    for tier, w in want["tiers"].items():
        g = got["tiers"][tier]
        assert g["errors"] == w["errors"] == 0
        assert g["weight_bytes"] == w["weight_bytes"], tier
        assert abs(g["epe_vs_f32"] - w["epe_vs_f32"]) <= EPE_ATOL, \
            (tier, g["epe_vs_f32"], w["epe_vs_f32"])
    assert got["tiers"]["f32"]["epe_vs_f32"] == 0.0


def test_quality_proxy_means_match_jax(jsb, small_params):
    small_model = small_params[1]
    kw = dict(SMALL, tiers=("f32",), sample_rate=0.5)
    want = jsb.quality_bench(**kw)
    got = sb.quality_bench(**kw, device="cpu", model=small_model)
    g, w = got["tiers"]["f32"], want["tiers"]["f32"]
    assert g["scored"] == w["scored"] == 4
    for proxy in ("photo", "smooth", "census"):
        np.testing.assert_allclose(g[proxy], w[proxy], rtol=QUALITY_RTOL,
                                   err_msg=proxy)
    assert got["quality"]["scored"] == want["quality"]["scored"] == 4


def test_warm_walk_matches_jax(jsb, small_params, monkeypatch):
    # the cold network at width 0.25 (the JAX tool's model_width
    # argument), so the walk runs the weights already drawn
    frames, width = 6, 0.25
    params, _ = small_params
    kw = dict(frames=frames, model_width=width, bucket=SMALL["bucket"],
              native_hw=SMALL["native_hw"])
    monkeypatch.setattr(jsb, "_real_model_params",
                        lambda cfg: (jax_engine.build_serve_model(cfg),
                                     params))
    jcfg = jsb._bench_cfg(SMALL["bucket"], 1, 0.0, None)
    jcfg = jcfg.replace(width_mult=width, serve=dataclasses.replace(
        jcfg.serve, session=dataclasses.replace(
            jcfg.serve.session, warm_start=True, warm_width=0.5)))
    refine_params = jax_engine.refine_init_params(
        jcfg, jax_engine.build_refine_model(jcfg))
    model = load_flax_params(build_model("flownet_s", width_mult=width,
                                         device="cpu"), params).eval()
    refine = load_flax_params(FlowNetRefine(width_mult=width * 0.5,
                                            residual=True),
                              refine_params).eval()
    want = jsb.warm_stream_bench(**kw)
    got = sb.warm_stream_bench(**kw, device="cpu", model=model,
                               refine=refine)
    # prime, one cold fallback, then a warm step a frame
    assert got["warm_steps"] == want["warm_steps"] == frames - 2
    assert got["warm_cold_fallbacks"] == want["warm_cold_fallbacks"] == 1
    assert got["warm_errors"] == want["warm_errors"] == 0
    assert abs(got["epe_vs_cold"] - want["epe_vs_cold"]) <= EPE_ATOL, \
        (got["epe_vs_cold"], want["epe_vs_cold"])
