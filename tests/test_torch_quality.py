"""Label-free quality scoring (`obs/quality.py`) in the PyTorch port
against the JAX package's: the sampler's decisions, the score triple of
the numpy reference and of the torch scorer against JAX's numpy
reference and its jitted scorer, the drift verdict after the same stream
of scores, the engine's `serve_quality*` block, and the router's merge
of the replicas' blocks. Inputs are numpy draws from fixed seeds.

Tolerances, each with its reason:
  - score triples: 1e-5 relative. The numpy references differ in the
    resize only (cv2's in JAX, a half-pixel bilinear of the port's own:
    float32 and float64 arithmetic), the torch scorer sums in float32
    in another order than XLA; measured at most 3e-7 relative;
  - the drift verdict, the counters, the histograms and the maps: equal
    (the same floats go in);
  - the engine's per-key sums: 1e-5 relative (the numpy references as
    above), its counters and the sampled set: equal.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.obs import quality as jq
from deepof_tpu.obs.registry import merge_stats_blocks as jax_merge
from deepof_tpu.serve.engine import InferenceEngine as JaxEngine
from deepof_tpu.serve.engine import make_fake_forward as jax_fake
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.obs import quality as tq
from deepof_tpu_torch.obs.registry import merge_stats_blocks
from deepof_tpu_torch.serve.engine import InferenceEngine

BUCKET = (32, 48)


@pytest.mark.parametrize("rate,seed", [(0.1, 0), (0.5, 3), (0.9, 7),
                                       (0.0, 1), (1.0, 2)])
def test_sampler_decisions_equal_jax_over_10000_indices(rate, seed):
    ours, theirs = tq.QualitySampler(rate, seed), jq.QualitySampler(rate,
                                                                    seed)
    got = [ours.sample(i) for i in range(10000)]
    assert got == [theirs.sample(i) for i in range(10000)]
    assert ours.rate == theirs.rate


def _row(rs, hw, fhw, mag=3.0):
    x = (rs.rand(*hw, 6).astype(np.float32) - 0.5)
    flow = ((rs.rand(*fhw, 2) - 0.5) * 2 * mag).astype(np.float32)
    return x, flow


@pytest.mark.parametrize("hw,fhw", [((64, 96), (16, 24)),
                                    ((48, 64), (48, 64)),
                                    ((40, 56), (20, 28)),
                                    ((36, 52), (9, 13))])
def test_score_triples_equal_jax(hw, fhw):
    x, flow = _row(np.random.RandomState(sum(hw)), hw, fhw)
    want_np = np.array(jq.score_pair_np(x, flow))
    want_jit = np.asarray(jax.jit(jq.make_score_fn())(x[None], flow[None]))
    got_np = np.array(tq.score_pair_np(x, flow))
    got_torch = np.array(tq.make_score_fn("cpu")(x[None], flow[None]))
    for got in (got_np, got_torch):
        np.testing.assert_allclose(got, want_np, rtol=1e-5)
        np.testing.assert_allclose(got, want_jit, rtol=1e-5)


def _stream(seed=4, n=40):
    """(photo, smooth, census) triples: a calm reference, then a drift."""
    rs = np.random.RandomState(seed)
    calm = 3.0 + rs.rand(n // 2) * 0.4
    drift = np.where(rs.rand(n - n // 2) < 0.6, 7.0 + rs.rand(n - n // 2),
                     3.1)
    photo = np.concatenate([calm, drift])
    return [(float(p), float(rs.rand()), float(20 + rs.rand()))
            for p in photo]


def _feed(mod, triples, **kw):
    """Every triple through a scorer of `mod`, each as one sampled
    request (the score function returns the triple it is handed)."""
    sc = mod.QualityScorer(lambda bucket, x, flow: tuple(x[0]), 1.0, **kw)
    try:
        for i, t in enumerate(triples):
            assert sc.submit(np.array(t), np.zeros((1, 1, 2), np.float32),
                             BUCKET, ("f32", "int8")[i % 2],
                             ("cold", "warm")[i % 3 == 0])
        assert sc.drain(30.0)
        return sc.stats()
    finally:
        sc.close()


def test_drift_verdict_equals_jax_after_the_same_stream():
    kw = dict(ref_samples=8, window=16, drift_factor=1.5, budget=0.2)
    triples = _stream()
    got, want = _feed(tq, triples, **kw), _feed(jq, triples, **kw)
    assert got == want
    assert got["serve_quality"]["exhausted"]
    assert got["serve_quality_breaches"] > 0
    # a calm stream burns nothing
    calm = [(3.0 + 0.01 * i, 0.1, 20.0) for i in range(20)]
    got, want = _feed(tq, calm, **kw), _feed(jq, calm, **kw)
    assert got == want and not got["serve_quality"]["exhausted"]


def test_a_full_queue_drops_and_counts_as_jax():
    out = []
    for mod in (tq, jq):
        gate = threading.Event()

        def score(bucket, x, flow, _g=gate):
            _g.wait(10.0)
            return 1.0, 1.0, 1.0

        sc = mod.QualityScorer(score, 1.0, queue_depth=2)
        try:
            took = [sc.submit(np.zeros(3), np.zeros((1, 1, 2)), BUCKET,
                              "f32", "cold") for _ in range(6)]
            gate.set()
            assert sc.drain(10.0)
            s = sc.stats()
        finally:
            sc.close()
        out.append((took[:2], sum(took), s["serve_quality_dropped"],
                    s["serve_quality_sampled"], s["serve_quality_scored"]))
    assert out[0] == out[1]
    assert out[0][0] == [True, True] and out[0][2] >= 3


def _cfgs(rate, **obs):
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        model="flownet_s", width_mult=0.125,
        data=dataclasses.replace(jcfg.data, dataset="synthetic",
                                 image_size=BUCKET, gt_size=BUCKET),
        serve=dataclasses.replace(jcfg.serve, max_batch=2,
                                  batch_timeout_ms=5.0),
        obs=dataclasses.replace(jcfg.obs, quality_sample_rate=rate,
                                quality_seed=5, **obs))
    with pytest.warns(UserWarning, match="ignored keys"):
        cfg = config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, cfg


def _serve(make, cfg, pairs, **kw):
    with make(cfg, forward_fn=jax_fake(0.0), **kw) as eng:
        for a, b in pairs:  # one at a time: the same acceptance order
            eng.submit(a, b).result(timeout=30)
        if eng._quality is not None:
            assert eng._quality.drain(30.0)
        return eng.stats()


def test_engine_quality_block_equals_jax():
    """A stand-in executor's engine scores through the numpy reference in
    both packages: the same requests sampled, the same verdict, the same
    serve_quality* keys."""
    rs = np.random.RandomState(11)
    pairs = [tuple(rs.randint(0, 256, (*BUCKET, 3), dtype=np.uint8)
                   for _ in range(2)) for _ in range(14)]
    jcfg, cfg = _cfgs(0.5, quality_ref_samples=3, quality_drift_factor=1.2)
    want = _serve(JaxEngine, jcfg, pairs)
    got = _serve(InferenceEngine, cfg, pairs, device="cpu")
    qkeys = {k for k in want if k.startswith("serve_quality")}
    assert qkeys == {k for k in got if k.startswith("serve_quality")}
    assert len(qkeys) == 17
    sampler = tq.QualitySampler(0.5, 5)
    assert got["serve_quality_sampled"] == got["serve_quality_scored"] \
        == sum(sampler.sample(i) for i in range(len(pairs))) > 0
    for k in qkeys:
        if k.endswith("_sum_by_key"):
            assert got[k].keys() == want[k].keys()
            np.testing.assert_allclose(list(got[k].values()),
                                       list(want[k].values()), rtol=1e-5)
        elif k == "serve_quality":
            for f in ("scored", "ref_samples", "breaches", "exhausted",
                      "budget", "drift_factor", "sample_rate"):
                assert got[k][f] == want[k][f], f
            np.testing.assert_allclose(got[k]["ref_p50"], want[k]["ref_p50"],
                                       rtol=1e-5)
        elif k.endswith("_hist"):
            assert got[k]["counts"] == want[k]["counts"], k
        elif k.endswith("_p50"):
            assert got[k] == want[k], k
        else:
            assert got[k] == want[k], k


def test_rate_zero_leaves_the_stats_schema_unchanged():
    rs = np.random.RandomState(12)
    pairs = [tuple(rs.randint(0, 256, (*BUCKET, 3), dtype=np.uint8)
                   for _ in range(2)) for _ in range(3)]
    jcfg, cfg = _cfgs(0.0)
    got = _serve(InferenceEngine, cfg, pairs, device="cpu")
    plain = _serve(InferenceEngine, dataclasses.replace(
        cfg, obs=type(cfg.obs)()), pairs, device="cpu")
    want = _serve(JaxEngine, jcfg, pairs)
    assert set(got) == set(plain) == set(want)
    assert not any(k.startswith("serve_quality") for k in got)


def test_a_model_engine_scores_with_torch_on_its_device():
    """A model engine (a small FlowNet-S on the CPU) scores every sampled
    request through the torch scorer; each triple equals the numpy
    reference's on the same input row and raw flow."""
    _, cfg = _cfgs(1.0)
    seen = []
    with InferenceEngine(cfg, device="cpu") as eng:
        inner = eng._quality._score_fn

        def recording(bucket, x, flow):
            out = inner(bucket, x, flow)
            seen.append((x[0].copy(), flow[0].copy(), out))
            return out

        eng._quality._score_fn = recording
        rs = np.random.RandomState(13)
        for _ in range(3):
            eng.submit(*(rs.randint(0, 256, (*BUCKET, 3), dtype=np.uint8)
                         for _ in range(2))).result(timeout=60)
        assert eng._quality.drain(60.0)
        stats = eng.stats()
    assert stats["serve_quality_scored"] == len(seen) == 3
    for x, flow, triple in seen:
        assert flow.shape[:2] == (BUCKET[0] // 2, BUCKET[1] // 2)  # resized
        np.testing.assert_allclose(triple, tq.score_pair_np(x, flow),
                                   rtol=1e-5)


def test_router_merges_quality_blocks_exactly_as_jax():
    kw = dict(ref_samples=4, window=8)
    a = _feed(tq, _stream(1, 12), **kw)
    b = _feed(tq, _stream(2, 20), **kw)
    got, want = merge_stats_blocks([a, b]), jax_merge([a, b])
    assert got == want
    assert got["serve_quality_scored"] == 32
    assert got["serve_quality_photo_hist"]["counts"] == [
        x + y for x, y in zip(a["serve_quality_photo_hist"]["counts"],
                              b["serve_quality_photo_hist"]["counts"])]
    assert got["serve_quality_scored_by_key"] == {
        k: a["serve_quality_scored_by_key"].get(k, 0)
        + b["serve_quality_scored_by_key"].get(k, 0)
        for k in set(a["serve_quality_scored_by_key"])
        | set(b["serve_quality_scored_by_key"])}
    assert "serve_quality" not in got  # derived: re-derived, not merged
