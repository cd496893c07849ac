"""The port's visual outputs and image inputs against the JAX package's:
`flow_to_color`, `dump_visuals` and `predict`'s flow-colour PNG (the same
file names, the same images as cv2 writes them), and PNG / JPEG paths
into `InferenceEngine`; and F14, the postprocess warm-up of `warm()`.

No tolerance: the colour wheel is the same numpy code, and the PNG
writer stores the bytes cv2.imwrite stores (the decoded images are
compared; the compressed streams differ).
"""

import os

import cv2
import numpy as np
import pytest

from deepof_tpu.predict import write_outputs as jax_write_outputs
from deepof_tpu.train.evaluate import dump_visuals as jax_dump_visuals
from deepof_tpu.utils.flowviz import flow_to_color as jax_flow_to_color
from deepof_tpu_torch import native
from deepof_tpu_torch.core.config import DataConfig, ExperimentConfig
from deepof_tpu_torch.io.png import write_png
from deepof_tpu_torch.models.registry import build_model
from deepof_tpu_torch.predict import write_outputs
from deepof_tpu_torch.serve import engine as engine_mod
from deepof_tpu_torch.serve.engine import InferenceEngine, ServeError
from deepof_tpu_torch.train.evaluate import dump_visuals
from deepof_tpu_torch.utils.flowviz import flow_to_color


def _flow(rs, h=23, w=31, c=2, scale=4.0):
    return (rs.randn(h, w, c) * scale).astype(np.float32)


@pytest.mark.parametrize("max_flow", [None, 3.0])
def test_flow_to_color_is_the_jax_one(max_flow):
    rs = np.random.RandomState(0)
    flow = _flow(rs)
    flow[0, :3] = 2e9  # unknown flow: black
    flow[1, 0] = np.array([0.0, 0.0])
    got = flow_to_color(flow, max_flow)
    assert got.dtype == np.uint8 and got.shape == (23, 31, 3)
    np.testing.assert_array_equal(got, jax_flow_to_color(flow, max_flow))
    assert (got[0, :3] == 0).all()


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        np.testing.assert_array_equal(cv2.imread(os.path.join(a, n)),
                                      cv2.imread(os.path.join(b, n)),
                                      err_msg=n)
    return names


@pytest.mark.parametrize("rows", [3, 10])
def test_dump_visuals_writes_the_jax_files(tmp_path, rows):
    """Volume-shaped arrays (four flow pairs, three reconstructions): the
    first pair and the first frame of up to 8 samples."""
    rs = np.random.RandomState(1)
    flow = np.stack([_flow(rs, c=8) for _ in range(rows)])
    gt = np.stack([_flow(rs, c=8) for _ in range(rows)])
    recon = rs.rand(rows, 23, 31, 9).astype(np.float32) * 1.2 - 0.1
    dump_visuals(str(tmp_path / "port"), "val0", flow, recon, gt)
    jax_dump_visuals(str(tmp_path / "jax"), "val0", flow, recon, gt)
    names = _same_files(tmp_path / "port", tmp_path / "jax")
    assert len(names) == 3 * min(rows, 8)
    dump_visuals(str(tmp_path / "p2"), "x", flow)  # flow colours only
    jax_dump_visuals(str(tmp_path / "j2"), "x", flow)
    assert _same_files(tmp_path / "p2", tmp_path / "j2")[0] == "x_s0_flow.png"


def test_predict_outputs_are_the_jax_files(tmp_path):
    flow = _flow(np.random.RandomState(2), 40, 56)
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    got = write_outputs(str(tmp_path / "p"), "0000_a", flow)
    want = jax_write_outputs(str(tmp_path / "j"), "0000_a", flow)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["0000_a_flow.flo",
                                                 "0000_a_flow.png"]
    assert open(got[0], "rb").read() == open(want[0], "rb").read()
    _same_files(tmp_path / "p", tmp_path / "j")
    assert write_outputs(str(tmp_path / "p"), "b", flow, write_png=False) \
        == [str(tmp_path / "p" / "b_flow.flo")]


def _engine():
    cfg = ExperimentConfig(width_mult=0.25,
                           data=DataConfig(image_size=(32, 48)))
    model = build_model("flownet_s", width_mult=0.25, device="cpu")
    return InferenceEngine(cfg, model=model, device="cpu")


def test_engine_takes_png_and_jpeg_paths(tmp_path):
    """A PNG or JPEG path gives the flow of its decoded array, as cv2
    decodes it; a format this build has no codec for is a bad_input that
    names the codecs."""
    rs = np.random.RandomState(3)
    a, b = (rs.randint(0, 256, (30, 44, 3), np.uint8) for _ in range(2))
    write_png(tmp_path / "a.png", a)
    cv2.imwrite(str(tmp_path / "b.jpg"), b)
    with _engine() as eng:
        want = eng.submit(a, cv2.imread(str(tmp_path / "b.jpg"))).result(60)
        got = eng.submit(str(tmp_path / "a.png"),
                         str(tmp_path / "b.jpg")).result(60)
        np.testing.assert_array_equal(got["flow"], want["flow"])
        no_jpeg = frozenset({"ppm", "png"})
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native, "codecs", lambda: no_jpeg)
            mp.setattr(native, "image_supported",
                       lambda p: not str(p).endswith(".jpg"))
            with pytest.raises(ServeError, match="png") as e:
                eng.submit(str(tmp_path / "a.png"),
                           str(tmp_path / "b.jpg")).result(60)
            assert e.value.code == "bad_input"


def test_warm_runs_the_postprocess_path_first(monkeypatch):
    """F14: `warm()` calls `flow_to_native` before its forwards, as the
    JAX engine's does, so the first request does not pay for it."""
    calls = []
    inner = engine_mod.flow_to_native

    def counted(*a, **kw):
        calls.append(a[2:])
        return inner(*a, **kw)

    monkeypatch.setattr(engine_mod, "flow_to_native", counted)
    with _engine() as eng:
        out = eng.warm()
        assert calls and calls[0] == ((2, 2), (2, 2))
        assert len(out["buckets"]) == 1
