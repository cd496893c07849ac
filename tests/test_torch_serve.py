"""The PyTorch port's serving path against the JAX package's: bucket
choice, preprocessing, postprocessing and the micro-batching engine.

Tolerances, each with its reason:
  - prepare_pair: 3/255. The JAX package resizes uint8 images with cv2,
    in fixed point with a rounded uint8 result; the port resizes in
    float32 with PyTorch.
  - postprocess_flow / flow_to_native: 2e-3 at |flow| ~ 10. cv2 and
    PyTorch compute the bilinear weights of a float32 resize in
    different precision (relative error ~1e-4).
  - engine responses: atol 1e-4, rtol 1e-4 on identical prepared rows.
    float32 convolutions sum in another order in XLA and in PyTorch; the
    native-size responses also pass through the two resizes, at a scale
    (2x) whose bilinear weights both compute exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("cv2")  # the JAX side's resize

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.serve import buckets as jax_buckets
from deepof_tpu.serve.engine import InferenceEngine as JaxEngine
from deepof_tpu.train.evaluate import postprocess_flow as jax_postprocess
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import config_from_dict
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.serve.buckets import (flow_to_native, pick_bucket,
                                            prepare_pair, resolve_buckets)
from deepof_tpu_torch.serve.engine import InferenceEngine, ServeError
from deepof_tpu_torch.train.evaluate import postprocess_flow

BUCKET = (64, 128)


def _jax_cfg(log_dir, max_batch=4, buckets=()):
    cfg = JaxConfig()
    return cfg.replace(
        model="flownet_c", width_mult=0.25, corr_max_disp=4, corr_stride=1,
        data=dataclasses.replace(cfg.data, image_size=BUCKET),
        serve=dataclasses.replace(cfg.serve, max_batch=max_batch,
                                  batch_timeout_ms=200.0, buckets=buckets),
        train=dataclasses.replace(cfg.train, log_dir=str(log_dir)))


def _port_cfg(jax_cfg):
    with pytest.warns(UserWarning, match="ignored keys"):
        return config_from_dict(dataclasses.asdict(jax_cfg))


def _img(rs, hw):
    return rs.randint(0, 256, (*hw, 3), dtype=np.uint8)


def test_config_loads_jax_dict(tmp_path):
    jcfg = _jax_cfg(tmp_path, buckets=((64, 128), (128, 256)))
    cfg = _port_cfg(jcfg)
    assert cfg.model == "flownet_c" and cfg.corr_max_disp == 4
    assert cfg.serve.buckets == ((64, 128), (128, 256))
    assert cfg.data.image_size == BUCKET
    assert cfg.train.eval_clip == jcfg.train.eval_clip


def test_buckets_match_jax(tmp_path):
    jcfg = _jax_cfg(tmp_path, buckets=((128, 256), (64, 128), (64, 64),
                                       (128, 256)))
    cfg = _port_cfg(jcfg)
    ladder = resolve_buckets(cfg)
    assert ladder == jax_buckets.resolve_buckets(jcfg)
    for hw in [(30, 60), (64, 100), (65, 64), (500, 900), (64, 128)]:
        assert pick_bucket(hw, ladder) == jax_buckets.pick_bucket(hw, ladder)
    assert resolve_buckets(_port_cfg(_jax_cfg(tmp_path))) == (BUCKET,)


@pytest.mark.parametrize("native", [(48, 96), (100, 180), (64, 128)])
def test_prepare_pair_matches_jax(native):
    rs = np.random.RandomState(0)
    a, b = _img(rs, native), _img(rs, native)
    mean = (97.533, 99.238, 97.056)
    got = prepare_pair(a, b, BUCKET, mean)
    want = jax_buckets.prepare_pair(a, b, BUCKET, mean)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=3 / 255, rtol=0)


@pytest.mark.parametrize("native", [(96, 160), (128, 256), (64, 128)])
def test_postprocess_and_flow_to_native_match_jax(tmp_path, native):
    rs = np.random.RandomState(1)
    jcfg = _jax_cfg(tmp_path)
    cfg = _port_cfg(jcfg)
    flow = (rs.randn(2, *BUCKET, 2) * 5).astype(np.float32)  # |amplified| ~ 10
    np.testing.assert_allclose(postprocess_flow(flow, cfg, native),
                               jax_postprocess(flow, jcfg, native),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(
        flow_to_native(flow[0], cfg, BUCKET, native),
        jax_buckets.flow_to_native(flow[0], jcfg, BUCKET, native),
        atol=2e-3, rtol=0)


def _models(jcfg):
    rs = np.random.RandomState(2)
    jm = jax_build_model("flownet_c", width_mult=0.25, corr_max_disp=4,
                         corr_stride=1)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, *BUCKET, 6)))["params"]
    params = jax.tree_util.tree_map(
        lambda a: (rs.randn(*a.shape) * (0.1 if a.ndim == 1 else
                   1.0 / np.sqrt(np.prod(a.shape[:-1])))).astype(np.float32),
        params)
    model = build_model("flownet_c", width_mult=0.25, corr_max_disp=4,
                        corr_stride=1, device="cpu")
    load_flax_params(model, params)
    return (jm, params), model


def test_engine_matches_jax_engine(tmp_path):
    jcfg = _jax_cfg(tmp_path)
    cfg = _port_cfg(jcfg)
    jax_mp, model = _models(jcfg)
    rs = np.random.RandomState(3)
    mean = (97.533, 99.238, 97.056)
    rows = []
    for native in [BUCKET, (128, 256)] * 3:
        rows.append((jax_buckets.prepare_pair(_img(rs, native),
                                              _img(rs, native), BUCKET, mean),
                     native))
    with JaxEngine(jcfg, model_params=jax_mp) as jeng:
        want = [f.result(timeout=300)["flow"] for f in
                [jeng.submit_prepared(x, BUCKET, hw) for x, hw in rows]]
    with InferenceEngine(cfg, model=model, device="cpu") as eng:
        futs = [eng.submit_prepared(x, BUCKET, hw) for x, hw in rows]
        got = [f.result(timeout=300) for f in futs]
        stats = eng.stats()
    for (x, hw), g, w in zip(rows, got, want):
        assert g["flow"].shape == (*hw, 2) and g["bucket"] == BUCKET
        np.testing.assert_allclose(g["flow"], w, atol=1e-4, rtol=1e-4)
    assert stats["serve_requests"] == stats["serve_responses"] == 6
    assert stats["serve_batches"] == 2 and stats["serve_errors"] == 0
    assert stats["serve_latency_p50_ms"] is not None


def test_engine_row_independent_of_batchmates(tmp_path):
    cfg = _port_cfg(_jax_cfg(tmp_path))
    _, model = _models(None)
    rs = np.random.RandomState(4)
    rows = [prepare_pair(_img(rs, BUCKET), _img(rs, BUCKET), BUCKET,
                         (0, 0, 0)) for _ in range(4)]
    with InferenceEngine(cfg, model=model, device="cpu") as eng:
        alone = eng.submit_prepared(rows[0], BUCKET, BUCKET).result(60)
        full = [f.result(60) for f in [eng.submit_prepared(r, BUCKET, BUCKET)
                                       for r in rows]]
    np.testing.assert_array_equal(alone["flow"], full[0]["flow"])


def test_engine_errors_are_structured(tmp_path):
    cfg = _port_cfg(_jax_cfg(tmp_path))
    _, model = _models(None)
    eng = InferenceEngine(cfg, model=model, device="cpu")
    try:
        bad = eng.submit(np.zeros((4, 4), np.uint8), np.zeros((4, 4), np.uint8))
        with pytest.raises(ServeError) as e:
            bad.result(10)
        assert e.value.code == "bad_input"
        png = eng.submit("a.png", "b.png")
        with pytest.raises(ServeError) as e:
            png.result(10)
        assert e.value.code == "bad_input"
        with pytest.raises(ValueError, match="fp4"):
            InferenceEngine(dataclasses.replace(cfg, serve=dataclasses.replace(
                cfg.serve, precisions=("f32", "fp4"))), model=model,
                device="cpu")

        def boom(*args, **kwargs):
            raise RuntimeError("device lost")

        eng._forward = boom
        fut = eng.submit_prepared(np.zeros((*BUCKET, 6), np.float32), BUCKET,
                                  BUCKET)
        with pytest.raises(ServeError) as e:
            fut.result(10)
        assert e.value.code == "dispatch_failed"
    finally:
        eng.close()
    late = eng.submit_prepared(np.zeros((*BUCKET, 6), np.float32), BUCKET,
                               BUCKET)
    with pytest.raises(ServeError) as e:
        late.result(10)
    assert e.value.code == "engine_closed"
    assert eng.stats()["serve_dispatch_failures"] == 1


def test_predict_pairs_writes_flo(tmp_path):
    from deepof_tpu_torch.io.flo import read_flo
    from deepof_tpu_torch.predict import predict_pairs

    cfg = _port_cfg(_jax_cfg(tmp_path))
    _, model = _models(None)
    rs = np.random.RandomState(5)
    paths = []
    for i in range(3):
        a, b = tmp_path / f"a{i}.npy", tmp_path / f"b{i}.npy"
        np.save(a, _img(rs, (48, 96)))
        np.save(b, _img(rs, (48, 96)))
        paths.append((str(a), str(b)))
    written = predict_pairs(cfg, paths, str(tmp_path / "out"), model=model,
                            device="cpu", write_png=False)  # --no-png
    assert [p.rsplit("/", 1)[1] for p in written] == [
        "0000_a0_flow.flo", "0001_a1_flow.flo", "0002_a2_flow.flo"]
    for p in written:
        flow = read_flo(p)
        assert flow.shape == (48, 96, 2) and np.isfinite(flow).all()


def test_engine_batches_per_tier_and_refuses_an_unserved_one(tmp_path):
    """Rows of two tiers never share a flush (serve_tier_splits); each
    response is its tier's forward of the row, bit for bit; a tier the
    engine does not serve fails that request alone with bad_request."""
    from deepof_tpu_torch.serve.engine import make_raw_forward
    from deepof_tpu_torch.serve.quant import quantize_model

    cfg = _port_cfg(_jax_cfg(tmp_path))
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(
        cfg.serve, precisions=("int8", "f32")))
    _, model = _models(None)
    rs = np.random.RandomState(6)
    rows = [prepare_pair(_img(rs, BUCKET), _img(rs, BUCKET), BUCKET,
                         (0, 0, 0)) for _ in range(4)]
    tiers = ["f32", "int8", None, "f32"]
    with InferenceEngine(cfg, model=model, device="cpu") as eng:
        futs = [eng.submit_prepared(r, BUCKET, BUCKET, precision=t)
                for r, t in zip(rows, tiers)]
        bad = eng.submit_prepared(rows[0], BUCKET, BUCKET, precision="bf16")
        got = [f.result(60) for f in futs]
        with pytest.raises(ServeError) as e:
            bad.result(60)
        stats = eng.stats()
    assert e.value.code == "bad_request" and "bf16" in str(e.value)
    assert [g["precision"] for g in got] == ["f32", "int8", "int8", "f32"]
    assert stats["serve_tier_splits"] >= 1 and stats["serve_tiers"] == 2
    assert stats["serve_requests_by_tier"] == {"int8": 2, "f32": 2}
    assert stats["serve_responses_by_tier"] == {"int8": 2, "f32": 2}
    assert stats["serve_errors"] == 1
    raw = {t: make_raw_forward(quantize_model(model, t))(
        np.stack([rows[0]] * 4)) for t in ("f32", "int8")}
    assert not np.array_equal(raw["f32"], raw["int8"])
    for r, g in zip(rows, got):
        tier_model = quantize_model(model, g["precision"])
        want = make_raw_forward(tier_model)(np.stack([r] + [np.zeros_like(r)]
                                                     * 3))[0]
        np.testing.assert_array_equal(
            g["flow"], flow_to_native(want, cfg, BUCKET, BUCKET))
