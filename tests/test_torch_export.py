"""`deepof_tpu_torch/obs/export.py` (a copy) against the JAX package's
`deepof_tpu/obs/export.py` on the same inputs: histograms filled from one
seeded sample set, their merge, percentiles, the SLO state and the
Prometheus text. Text and numbers are compared exactly.
"""

import numpy as np
import pytest

from deepof_tpu.obs import export as jax_export
from deepof_tpu_torch.obs import export


def _fill(mod, seconds):
    h = mod.LatencyHistogram()
    for s in seconds:
        h.observe(s)
    return h.snapshot()


def _samples(seed, n=500):
    """Latencies in seconds, log-uniform from 0.1 ms to 30 s (past the
    largest bound, so the +Inf bucket is used)."""
    rs = np.random.RandomState(seed)
    return list(10 ** rs.uniform(-4, np.log10(30.0), n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_and_their_merge_equal_jax(seed):
    a, b = _samples(seed), _samples(seed + 10, 80)
    got = [_fill(export, a), _fill(export, b)]
    want = [_fill(jax_export, a), _fill(jax_export, b)]
    assert got == want
    assert export.merge_hists(got) == jax_export.merge_hists(want)
    assert export.LATENCY_BUCKETS_MS == jax_export.LATENCY_BUCKETS_MS
    with pytest.raises(ValueError):
        export.merge_hists([got[0], {"buckets_ms": [1.0], "counts": [0, 0],
                                     "sum_ms": 0, "count": 0}])


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.9, 0.99, 1.0])
def test_percentile_equals_jax(frac):
    snap = _fill(export, _samples(3))
    assert export.percentile_ms(snap, frac) == \
        jax_export.percentile_ms(snap, frac)
    assert export.percentile_ms(None, frac) is None
    assert export.percentile_ms(_fill(export, []), frac) is None


@pytest.mark.parametrize("target,budget,failures", [
    (50.0, 0.01, 0), (100.0, 0.05, 7), (3.0, 0.5, 2), (16384.0, 0.01, 0)])
def test_slo_state_equals_jax(target, budget, failures):
    snap = _fill(export, _samples(4))
    got = export.slo_state(snap, 520, failures, target, budget)
    assert got == jax_export.slo_state(snap, 520, failures, target, budget)
    assert export.slo_state(None, 0, 0, target, budget) == \
        jax_export.slo_state(None, 0, 0, target, budget)


def test_validate_slo_refuses_what_jax_refuses():
    from types import SimpleNamespace as NS

    for cfg in (NS(slo_latency_ms=1e6, slo_error_budget=0.01),
                NS(slo_latency_ms=100.0, slo_error_budget=0.0)):
        with pytest.raises(ValueError):
            jax_export.validate_slo(cfg)
        with pytest.raises(ValueError):
            export.validate_slo(cfg)
    export.validate_slo(NS(slo_latency_ms=100.0, slo_error_budget=0.01))


def test_prometheus_text_equals_jax_and_parses_back():
    snap = _fill(export, _samples(5))
    stats = {"serve_requests": 12, "serve_errors": 0,
             "serve_occupancy_mean": 3.25, "serve_sessions_warm_start": True,
             "serve_requests_by_tier": {"f32": 7, "bf16": 5},
             "state": {"mode": "warm"}, "skipped": None, "name": "x",
             "serve_latency_hist": snap,
             "serve_slo": export.slo_state(snap, 12, 1, 100.0, 0.01)}
    text = export.render_prometheus(stats)
    assert text == jax_export.render_prometheus(stats)
    parsed = export.parse_prometheus(text)
    assert parsed == jax_export.parse_prometheus(text)
    assert parsed["deepof_serve_requests"] == 12
    assert parsed['deepof_serve_latency_ms_bucket{le="+Inf"}'] == 500
    assert parsed['deepof_serve_requests_by_tier{key="bf16"}'] == 5


def test_metrics_server_serves_the_stats():
    import http.client
    import json

    httpd = export.start_metrics_server(lambda: {"serve_requests": 3})
    try:
        conn = http.client.HTTPConnection(*httpd.server_address[:2],
                                          timeout=10)
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
        assert export.parse_prometheus(body) == {"deepof_serve_requests": 3}
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read()) == {"serve_requests": 3}
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
