"""The port's MPI-Sintel loader and FlyingChairs' streaming mode against
the JAX package's, on fixture trees written in a temporary directory.

Routes and tolerances:
  - streaming (`data.cache_decoded=False`): both packages decode a batch
    with the same C++ (`decode_image_batch`, its fused bilinear resize)
    and read the same `.flo` bytes: bit for bit, crops included;
  - cached, frames at the network size (no resize): the port's own-size
    decode is cv2.imread's output (test_torch_native_io.py): bit for bit;
  - cached, frames resized: the JAX package resizes with cv2.resize on
    uint8 and rounds back to uint8, the port with PyTorch's bilinear
    interpolation in float32 (the same sampling rule, no rounding):
    within 1 grey level (0.656 measured on these fixtures);
  - "python-png" (the route of a native build without a PNG codec) is
    the native route bit for bit.
Window lists, val membership (bamboo_2's second window), the pair split
file and the random draws (window indices, then each crop's y, x) are
compared exactly.
"""

import os
import sys

import numpy as np
import pytest

import chip_smoke
from deepof_tpu.core.config import DataConfig as JaxDataConfig
from deepof_tpu.data.datasets import FlyingChairsData as JaxChairs
from deepof_tpu.data.datasets import SintelData as JaxSintel
from deepof_tpu_torch import native
from deepof_tpu_torch.core.config import DataConfig
from deepof_tpu_torch.data.datasets import (FlyingChairsData, SintelData,
                                            build_dataset)
from deepof_tpu_torch.io.flo import write_flo
from deepof_tpu_torch.io.ppm import write_ppm_bgr

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_native import jax_native_loaded  # noqa: E402

CLIPS = {"alley_1": 5, "bamboo_2": 8, "market_2": 6}
NATIVE_HW = (36, 60)


@pytest.fixture(scope="module")
def jax_decoder():
    """The JAX package's native library loaded in this process (its
    datasets' streaming route; `tests/_jax_native.py`)."""
    assert jax_native_loaded(), "deepof_tpu.native does not load: the " \
        "JAX datasets would decode with cv2"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("sintel")
    chip_smoke.write_sintel(str(root), CLIPS, NATIVE_HW, seed=3)
    return str(root)


def _cfgs(root, **kw):
    return (DataConfig(dataset="sintel", data_path=root, **kw),
            JaxDataConfig(dataset="sintel", data_path=root, **kw))


@pytest.mark.parametrize("t", [2, 3, 4])
def test_windows_and_val_membership_match_jax(tree, t):
    port, jax_ = (cls(c) for cls, c in zip((SintelData, JaxSintel),
                                           _cfgs(tree, time_step=t)))
    assert port.windows == jax_.windows
    assert port.flow_windows == jax_.flow_windows
    assert port.val_idx == jax_.val_idx
    assert port.train_idx == jax_.train_idx
    assert (port.num_train, port.num_val) == (jax_.num_train, jax_.num_val)
    # bamboo_2 (after alley_1) has a second val window, at frame
    # time_step, when it has more than time_step windows
    bamboo = CLIPS["alley_1"] - t + 1
    assert (bamboo + t in port.val_idx) == (CLIPS["bamboo_2"] - t + 1 > t)
    assert isinstance(build_dataset(_cfgs(tree, time_step=t)[0]), SintelData)


def test_pair_split_file_matches_jax(tree, tmp_path):
    pairs = sum(n - 1 for n in CLIPS.values())
    split = tmp_path / "Sintel_train_val.txt"
    split.write_text("".join("2\n" if k % 4 == 1 else "1\n"
                             for k in range(pairs)))
    port, jax_ = (cls(c) for cls, c in zip(
        (SintelData, JaxSintel),
        _cfgs(tree, sintel_pair_split_file=str(split))))
    assert port.val_idx == jax_.val_idx == list(range(1, pairs, 4))
    assert port.train_idx == jax_.train_idx
    for text, match in ((("1\n" * (pairs - 1)), "entries but"),
                        ("1\n" * (pairs - 1) + "3\n", "expected")):
        split.write_text(text)
        for cls, c in zip((SintelData, JaxSintel),
                          _cfgs(tree, sintel_pair_split_file=str(split))):
            with pytest.raises(ValueError, match=match):
                cls(c)
    for cls, c in zip((SintelData, JaxSintel), _cfgs(
            tree, time_step=3, sintel_pair_split_file=str(split))):
        with pytest.raises(ValueError, match="requires"):
            cls(c)


def _draws(ds, seed, n_val):
    rs = np.random.RandomState(seed)
    out = [ds.sample_train(3, rng=rs) for _ in range(2)]
    out += [ds.sample_val(3, b) for b in range(n_val)]
    out.append(rs.randint(0, 1 << 30))  # the stream after the draws
    return out


def _assert_draws(got, want, atol):
    assert got[-1] == want[-1]  # the same rng draws were taken
    for g, w in zip(got[:-1], want[:-1]):
        assert set(g) == set(w) == {"volume", "flow"}
        assert g["volume"].dtype == w["volume"].dtype == np.float32
        assert g["volume"].shape == w["volume"].shape
        np.testing.assert_array_equal(g["flow"], w["flow"])
        np.testing.assert_allclose(g["volume"], w["volume"], rtol=0,
                                   atol=atol)


# (route, image_size, crop, volume tolerance in grey levels)
@pytest.mark.parametrize("cache,size,crop,atol", [
    (False, NATIVE_HW, (28, 44), 0.0),   # streaming, native size
    (False, (24, 48), (16, 40), 0.0),    # streaming, fused resize
    (True, NATIVE_HW, (28, 44), 0.0),    # cached, native size
    (True, (24, 48), (16, 40), 1.0)])    # cached, resized
@pytest.mark.parametrize("t", [2, 3])
def test_batches_match_jax(tree, jax_decoder, t, cache, size, crop, atol):
    port, jax_ = (cls(c) for cls, c in zip(
        (SintelData, JaxSintel),
        _cfgs(tree, time_step=t, image_size=size, crop_size=crop,
              cache_decoded=cache)))
    assert port.decode_route == ("native" if cache else "native-batch")
    got, want = _draws(port, 7, 2), _draws(jax_, 7, 2)
    _assert_draws(got, want, atol)
    b = got[0]
    assert b["volume"].shape == (3, *crop, 3 * t)
    assert b["flow"].shape == (3, *NATIVE_HW, 2 * (t - 1))
    assert got[2]["volume"].shape == (3, *size, 3 * t)  # val: no crop


def test_python_png_route_is_the_native_route(tree, monkeypatch):
    """A native build without a PNG codec reads the frames with io/png.py,
    cached or not: the same batches as the native route."""
    want = _draws(SintelData(_cfgs(tree, time_step=3, image_size=(24, 48),
                                   crop_size=(16, 40))[0]), 5, 1)
    monkeypatch.setattr(native, "codecs", lambda: frozenset({"ppm"}))
    for cache in (True, False):
        ds = SintelData(_cfgs(tree, time_step=3, image_size=(24, 48),
                              crop_size=(16, 40), cache_decoded=cache)[0])
        assert ds.decode_route == "python-png"
        _assert_draws(_draws(ds, 5, 1), want, 0.0)


def test_max_measured_resize_gap_is_under_one_grey_level(tree):
    """The cached route's resize against cv2's, measured: the tolerance
    of test_batches_match_jax's resized case, with what it allows."""
    port, jax_ = (cls(c) for cls, c in zip(
        (SintelData, JaxSintel), _cfgs(tree, time_step=2,
                                       image_size=(24, 48))))
    gap = max(float(np.abs(port.sample_val(2, b)["volume"]
                           - jax_.sample_val(2, b)["volume"]).max())
              for b in range(2))
    assert 0.0 < gap < 1.0


@pytest.fixture(scope="module")
def chairs(tmp_path_factory):
    root = tmp_path_factory.mktemp("chairs")
    rs = np.random.RandomState(0)
    for i in range(1, 7):
        for k in (1, 2):
            write_ppm_bgr(root / f"{i:05d}_img{k}.ppm",
                          rs.randint(0, 256, (30, 40, 3), np.uint8))
        write_flo(root / f"{i:05d}_flow.flo",
                  rs.randn(30, 40, 2).astype(np.float32))
    return str(root)


@pytest.mark.parametrize("size", [(30, 40), (24, 32)])
def test_flyingchairs_streaming_is_the_jax_native_batch(chairs, jax_decoder,
                                                        size):
    cfg = dict(dataset="flyingchairs", data_path=chairs, image_size=size,
               cache_decoded=False)
    port = FlyingChairsData(DataConfig(**cfg))
    jax_ = JaxChairs(JaxDataConfig(**cfg))
    for a, b in ((port.sample_train(3, iteration=1),
                  jax_.sample_train(3, iteration=1)),
                 (port.sample_val(2, 0), jax_.sample_val(2, 0))):
        assert set(a) == set(b) == {"source", "target", "flow"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the streaming route is the fused decode: no cache is filled
    assert port.cache_stats()["entries"] == 0
