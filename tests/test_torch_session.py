"""The PyTorch port's streaming sessions (`serve/session.py`) and the
engine's `submit_next` with temporal warm start, against the JAX
package's.

The store's scenarios (`tests/test_session.py:79-146`,
`tests/test_warm.py:100-161`) run on the JAX package's `SessionStore` and
on the port's copy alike. The engine cases run the port's engine on the
CPU with FlowNet-C at width 0.25, max_disp 4, stride 1: a walk with
`warm_start=False` is bit for bit the pairwise walk; expiry is structured
and resumable; a rebucket re-primes and a bad frame keeps the session; a
warm step never shares a flush with a cold one; warm walks are bit-stable
across engines, and their first step is the cold walk's. Last, a warm
walk through the port's engine against the JAX engine's, with the same
weights carried across (the refinement stage's gate set to 0.5, so the
stage's own output counts).

Tolerance of that last case: atol 1e-4, rtol 1e-4 on the native flows,
as for the engine's cold responses (`test_torch_serve.py`): float32
convolutions sum in another order, and a warm step's prior is the
previous step's output of its own engine. Measured on an x86-64 CPU:
5.5e-6, 1.2e-5 and 4.4e-5 on the three steps, whose flows reach 11.8,
19.6 and 59.5 (the random stage adds its output to the prior each
step).
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepof_tpu.core.config import ExperimentConfig as JaxConfig
from deepof_tpu.models.registry import build_model as jax_build_model
from deepof_tpu.serve import engine as jax_engine
from deepof_tpu.serve.session import SessionExpired as JaxExpired
from deepof_tpu.serve.session import SessionStore as JaxStore
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                          ServeConfig, SessionConfig,
                                          TrainConfig, config_from_dict)
from deepof_tpu_torch.models.flownet2 import FlowNetRefine
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.serve.engine import InferenceEngine, ServeError
from deepof_tpu_torch.serve.session import SessionExpired, SessionStore

STORES = [pytest.param((JaxStore, JaxExpired), id="jax"),
          pytest.param((SessionStore, SessionExpired), id="port")]
GEOMETRY = {"width_mult": 0.25, "corr_max_disp": 4, "corr_stride": 1}


def _row(rs, hw=(4, 4)):
    return rs.rand(*hw, 3).astype(np.float32)


# ------------------------------------------------------------ the store


@pytest.mark.parametrize("store", STORES)
def test_store_lru_bound_and_tombstones(store):
    Store, Expired = store
    rs = np.random.RandomState(0)
    s = Store(max_sessions=2, ttl_s=0, sweep_s=0)
    for sid in ("a", "b", "c"):  # c evicts a, the oldest
        assert s.advance(sid, _row(rs), (4, 4), (4, 4), "f32")[0] == "primed"
    st = s.stats()
    assert st["serve_sessions_active"] == 2
    assert st["serve_sessions_evicted"] == 1
    # touching b keeps it; a new session now evicts c
    assert s.advance("b", _row(rs), (4, 4), (4, 4), "f32")[0] == "step"
    s.advance("d", _row(rs), (4, 4), (4, 4), "f32")
    assert s.contains("b") and not s.contains("c")
    # a dead id: one structured notification, then a resume
    with pytest.raises(Expired) as e:
        s.advance("a", _row(rs), (4, 4), (4, 4), "f32")
    assert e.value.reason == "evicted"
    assert s.advance("a", _row(rs), (4, 4), (4, 4), "f32")[0] == "primed"
    st = s.stats()
    assert st["serve_sessions_resumed"] == 1
    assert st["serve_sessions_active"] == 2
    s.close()


@pytest.mark.parametrize("store", STORES)
def test_store_ttl_on_access_and_swept(store):
    Store, Expired = store
    rs = np.random.RandomState(1)
    lazy = Store(max_sessions=8, ttl_s=0.15, sweep_s=0)
    lazy.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    time.sleep(0.25)
    with pytest.raises(Expired) as e:
        lazy.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    assert e.value.reason == "expired"
    assert lazy.stats()["serve_sessions_expired"] == 1
    lazy.close()

    swept = Store(max_sessions=8, ttl_s=0.1, sweep_s=0.02)
    swept.advance("w", _row(rs), (4, 4), (4, 4), "f32")
    deadline = time.monotonic() + 5.0
    while (swept.stats()["serve_sessions_expired"] < 1
           and time.monotonic() < deadline):
        time.sleep(0.02)
    st = swept.stats()
    assert st["serve_sessions_expired"] == 1
    assert st["serve_sessions_active"] == 0
    swept.close()
    assert not swept._sweeper.is_alive()


@pytest.mark.parametrize("store", STORES)
def test_store_delete_ends_clean(store):
    Store, _ = store
    rs = np.random.RandomState(2)
    s = Store(max_sessions=4, ttl_s=0, sweep_s=0)
    s.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    assert s.delete("v") is True
    assert s.delete("v") is False
    assert s.advance("v", _row(rs), (4, 4), (4, 4), "f32")[0] == "primed"
    st = s.stats()
    assert st["serve_sessions_deleted"] == 1
    assert st["serve_sessions_created"] == 2
    assert st["serve_sessions_resumed"] == 0
    s.close()


@pytest.mark.parametrize("store", STORES)
def test_store_prior_lifecycle_and_epoch_guard(store):
    Store, _ = store
    rs = np.random.RandomState(3)
    s = Store(max_sessions=4, ttl_s=0, sweep_s=0)
    s.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    kind, _, prior, epoch, _ = s.advance("v", _row(rs), (4, 4), (4, 4),
                                         "f32")
    assert kind == "step" and prior is None
    flow = np.ones((2, 2, 2), np.float32)
    assert s.set_flow("v", flow, (4, 4), epoch) is True
    out = s.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    assert out[0] == "step" and np.array_equal(out[2], flow)
    assert s.set_flow("v", flow, (8, 8), epoch) is False      # bucket
    assert s.set_flow("v", flow, (4, 4), epoch + 99) is False  # epoch
    assert s.set_flow("ghost", flow, (4, 4), epoch) is False   # dead
    # a rebucket re-primes and drops the prior
    s.set_flow("v", flow, (4, 4), epoch)
    kind, sess = s.advance("v", _row(rs, (8, 8)), (8, 8), (8, 8), "f32")
    assert kind == "primed" and sess.flow is None
    out = s.advance("v", _row(rs, (8, 8)), (8, 8), (8, 8), "f32")
    assert out[0] == "step" and out[2] is None
    assert s.set_flow("v", flow, (4, 4), epoch) is False  # a straggler
    s.close()


@pytest.mark.parametrize("store", STORES)
def test_store_resume_drops_prior_and_rejects_stragglers(store):
    Store, Expired = store
    rs = np.random.RandomState(4)
    s = Store(max_sessions=4, ttl_s=0.15, sweep_s=0)
    s.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    old_epoch = s.advance("v", _row(rs), (4, 4), (4, 4), "f32")[3]
    s.set_flow("v", np.ones((2, 2, 2), np.float32), (4, 4), old_epoch)
    time.sleep(0.25)
    with pytest.raises(Expired):
        s.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    kind, sess = s.advance("v", _row(rs), (4, 4), (4, 4), "f32")
    assert kind == "primed" and sess.flow is None
    assert s.stats()["serve_sessions_resumed"] == 1
    # the dispatch in flight across the expiry lands late: same id, same
    # bucket, dropped on the epoch
    assert s.set_flow("v", np.ones((2, 2, 2), np.float32), (4, 4),
                      old_epoch) is False
    assert s.advance("v", _row(rs), (4, 4), (4, 4), "f32")[2] is None
    s.close()


# ------------------------------------------------------------ the engine


def _cfg(warm_start=False, buckets=(), max_batch=4, timeout_ms=5.0,
         **session_kw):
    return ExperimentConfig(
        model="flownet_c", **GEOMETRY,
        data=DataConfig(dataset="synthetic", image_size=(32, 64),
                        gt_size=(32, 64)),
        serve=ServeConfig(max_batch=max_batch, batch_timeout_ms=timeout_ms,
                          buckets=buckets, session=SessionConfig(
                              warm_start=warm_start, **session_kw)),
        train=TrainConfig(eval_amplifier=1.0, eval_clip=(-1e6, 1e6)))


def _frames(rs, n, hw=(30, 60)):
    return [rs.randint(1, 255, (*hw, 3), dtype=np.uint8) for _ in range(n)]


def _walk(eng, frames, sid="vid"):
    assert eng.submit_next(sid, frames[0]).result(60)["primed"] is True
    return [eng.submit_next(sid, f).result(60) for f in frames[1:]]


def test_cold_walk_is_bitwise_the_pairwise_walk():
    frames = _frames(np.random.RandomState(5), 5)
    with InferenceEngine(_cfg(), device="cpu") as eng:
        pairwise = [eng.submit(a, b).result(60)["flow"]
                    for a, b in zip(frames, frames[1:])]
        streamed = _walk(eng, frames)
        stats = eng.stats()
    for i, (pw, st) in enumerate(zip(pairwise, streamed)):
        assert np.array_equal(pw, st["flow"]), f"pair {i}"
        assert "warm" not in st
    assert [st["frame_index"] for st in streamed] == [1, 2, 3, 4]
    assert stats["serve_sessions_frames"] == 5
    assert stats["serve_sessions_steps"] == 4
    assert stats["serve_sessions_decode_saved"] == 4
    assert stats["serve_session_latency_p50_ms"] is not None
    assert stats["serve_sessions_warm_steps"] == 0


def test_session_expired_is_structured_and_resumable():
    frames = _frames(np.random.RandomState(6), 3)
    with InferenceEngine(_cfg(ttl_s=0.15, sweep_s=0.02),
                         device="cpu") as eng:
        eng.submit_next("v", frames[0]).result(60)
        eng.submit_next("v", frames[1]).result(60)
        time.sleep(0.3)
        with pytest.raises(ServeError) as e:
            eng.submit_next("v", frames[2]).result(60)
        assert e.value.code == "session_expired"
        assert eng.stats()["serve_errors"] == 1
        assert eng.submit_next("v", frames[2]).result(60)["primed"] is True
        assert eng.stats()["serve_sessions_resumed"] == 1
    assert not eng.sessions._sweeper.is_alive()


def test_rebucket_reprimes_and_a_bad_frame_keeps_the_session():
    rs = np.random.RandomState(7)
    with InferenceEngine(_cfg(buckets=((32, 64), (64, 64))),
                         device="cpu") as eng:
        eng.submit_next("v", _frames(rs, 1)[0]).result(60)
        big = _frames(rs, 2, (60, 60))
        assert eng.submit_next("v", big[0]).result(60)["primed"] is True
        assert eng.stats()["serve_sessions_rebucketed"] == 1
        with pytest.raises(ServeError) as e:
            eng.submit_next("v", "/nonexistent/frame.png").result(60)
        assert e.value.code == "bad_input"
        res = eng.submit_next("v", big[1]).result(60)
        assert res["frame_index"] == 2 and res["bucket"] == (64, 64)


def test_warm_step_never_shares_a_flush_with_a_cold_one():
    frames = _frames(np.random.RandomState(8), 3)
    with InferenceEngine(_cfg(warm_start=True, timeout_ms=200.0),
                         device="cpu") as eng:
        eng.submit_next("v", frames[0]).result(60)
        assert eng.submit_next("v", frames[1]).result(60)["warm"] is False
        # warm, then a cold pair inside the batching window: same bucket
        # and tier, another mode
        f_warm = eng.submit_next("v", frames[2])
        f_cold = eng.submit(frames[1], frames[2])
        assert f_warm.result(60)["warm"] is True
        assert f_cold.result(60)["flow"].shape == (30, 60, 2)
        stats = eng.stats()
    assert stats["serve_warm_splits"] >= 1
    assert stats["serve_sessions_warm_steps"] == 1
    assert stats["serve_sessions_cold_fallbacks"] == 1


def test_warm_walks_are_bit_stable_and_start_cold():
    frames = _frames(np.random.RandomState(9), 5)
    walks = []
    for warm_start in (True, True, False):
        with InferenceEngine(_cfg(warm_start=warm_start),
                             device="cpu") as eng:
            walks.append(_walk(eng, frames))
    warm_a, warm_b, cold = walks
    assert [r["warm"] for r in warm_a] == [False, True, True, True]
    for a, b in zip(warm_a, warm_b):
        assert np.array_equal(a["flow"], b["flow"])
    assert np.array_equal(warm_a[0]["flow"], cold[0]["flow"])
    assert all(np.isfinite(r["flow"]).all() for r in warm_a)


def _jax_weights(jcfg, bucket):
    """(flax params of the cold FlowNet-C, of the refinement stage with
    its gate at 0.5), drawn with numpy."""
    rs = np.random.RandomState(10)

    def draw(tree):
        return jax.tree_util.tree_map(
            lambda a: (rs.randn(*a.shape) * (0.1 if len(a.shape) == 1 else
                       1.0 / np.sqrt(np.prod(a.shape[:-1])))
                       ).astype(np.float32), tree)

    jm = jax_build_model("flownet_c", **GEOMETRY)
    x = jnp.zeros((1, *bucket, 6))
    cold = draw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)["params"])
    refine_model = jax_engine.build_refine_model(jcfg)
    refine = draw(jax.eval_shape(
        refine_model.init, jax.random.PRNGKey(0), x,
        jnp.zeros((1, bucket[0] // 2, bucket[1] // 2, 2)))["params"])
    refine["gate"] = np.float32(0.5)
    return jm, cold, refine


def test_warm_walk_matches_the_jax_engine(tmp_path, monkeypatch):
    bucket = (64, 64)
    jcfg = JaxConfig()
    jcfg = jcfg.replace(
        model="flownet_c", **GEOMETRY,
        data=dataclasses.replace(jcfg.data, image_size=bucket),
        serve=dataclasses.replace(
            jcfg.serve, max_batch=2, batch_timeout_ms=5.0,
            session=dataclasses.replace(jcfg.serve.session,
                                        warm_start=True)),
        train=dataclasses.replace(jcfg.train, log_dir=str(tmp_path)))
    with pytest.warns(UserWarning, match="ignored keys"):
        cfg = config_from_dict(dataclasses.asdict(jcfg))
    jm, cold, refine = _jax_weights(jcfg, bucket)
    monkeypatch.setattr(jax_engine, "refine_init_params",
                        lambda cfg, model: refine)
    rs = np.random.RandomState(11)
    base = rs.randint(1, 255, (80, 80, 3), dtype=np.uint8)
    # a coherent walk: a textured frame shifted a pixel a step
    frames = [np.ascontiguousarray(base[8 - k:72 - k, 8:72])
              for k in range(4)]
    with jax_engine.InferenceEngine(jcfg, model_params=(jm, cold)) as jeng:
        want = _walk(jeng, frames)
    width = cfg.width_mult * cfg.serve.session.warm_width
    port_refine = load_flax_params(
        FlowNetRefine(width_mult=width, residual=True), refine)
    model = load_flax_params(build_model("flownet_c", device="cpu",
                                         **GEOMETRY), cold)
    with InferenceEngine(cfg, model=model, refine=port_refine,
                         device="cpu") as eng:
        got = _walk(eng, frames)
    assert [r["warm"] for r in got] == [r["warm"] for r in want] \
        == [False, True, True]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["flow"], w["flow"], atol=1e-4,
                                   rtol=1e-4)


def test_config_carries_sessions_and_tiers_from_a_jax_dict():
    jcfg = JaxConfig()
    jcfg = jcfg.replace(serve=dataclasses.replace(
        jcfg.serve, precisions=("int8", "f32"),
        session=dataclasses.replace(jcfg.serve.session, max_sessions=7,
                                    ttl_s=3.5, sweep_s=0.5, warm_start=True,
                                    warm_width=0.25)))
    with pytest.warns(UserWarning) as record:
        cfg = config_from_dict(dataclasses.asdict(jcfg))
    ignored = " ".join(str(w.message) for w in record)
    assert "serve.session" not in ignored and "serve.precisions" not in ignored
    assert cfg.serve.precisions == ("int8", "f32")
    assert dataclasses.asdict(cfg.serve.session) == dataclasses.asdict(
        jcfg.serve.session)


def test_close_stops_every_thread_it_started():
    before = set(threading.enumerate())
    eng = InferenceEngine(_cfg(warm_start=True, ttl_s=1.0, sweep_s=0.01),
                          device="cpu")
    assert eng.sessions._sweeper.is_alive()
    eng.close()
    assert set(threading.enumerate()) <= before
