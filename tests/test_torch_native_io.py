"""The port's native decoder (`deepof_tpu_torch/native`) against the JAX
package's (`deepof_tpu.native`, the same C++) and cv2, and the port's
PNG codec (`deepof_tpu_torch/io/png.py`) against cv2.

Tolerances: none. The batch decode with its fused resize, the `.flo`
reader and the dims probes are the JAX package's code, bit for bit. The
own-size decode is libpng's / libjpeg's / the PPM reader's output with
the channels swapped to BGR, which cv2.imread gives bit for bit for PNG
and PPM. For JPEG the two may link different libjpeg builds (IDCT and
chroma upsampling may differ in the last bit); on this host they agree
exactly on the test's 4:2:0 and 4:4:4 files, measured, so the test
holds them equal and would show a difference if a build changed.
"""

import os
import sys

import cv2
import numpy as np
import pytest

from deepof_tpu_torch import native
from deepof_tpu_torch.io.flo import write_flo
from deepof_tpu_torch.io.png import png_bytes, read_png_bgr, write_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _jax_native import jax_native, jax_native_loaded  # noqa: E402

BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "build", "deepof_tpu_torch")


def _texture(rs, h, w):
    """A smooth image with noise: every PNG filter type pays off on some
    rows of it, so cv2 writes all five with IMWRITE_PNG_ALL_FILTERS."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    smooth = 127 + 100 * np.sin(0.07 * yy + 0.05 * xx)[..., None] * \
        rs.rand(3)
    noise = rs.rand(h, w, 3) * 255
    return np.where((xx % 37 < 19)[..., None], smooth, noise).astype(
        np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Frames of three sizes in PPM, PNG and JPEG (two subsamplings),
    and .flo files of one size."""
    # the JAX library whole in this process (`tests/_jax_native.py`)
    assert jax_native_loaded(), "deepof_tpu.native does not load"
    root = tmp_path_factory.mktemp("native")
    rs = np.random.RandomState(0)
    out = {"img": [], "flo": []}
    for i, (h, w) in enumerate([(37, 53), (64, 96), (120, 160)]):
        img = _texture(rs, h, w)
        for ext, params in (("ppm", []), ("png", []),
                            ("jpg", [cv2.IMWRITE_JPEG_QUALITY, 90]),
                            ("444.jpg", [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444
                                         ])):
            p = str(root / f"f{i}.{ext}")
            assert cv2.imwrite(p, img, params)
            out["img"].append(p)
    for i in range(3):
        p = str(root / f"f{i}.flo")
        write_flo(p, rs.randn(30, 44, 2).astype(np.float32) * 5)
        out["flo"].append(p)
    return out


def test_the_build_links_every_codec_into_the_build_directory():
    assert native.codecs() == {"ppm", "png", "jpeg"}  # this host: both libs
    lib = native.library_path()
    assert os.path.dirname(lib) == BUILD
    assert os.path.basename(lib).startswith("libdeepof_io-png-jpeg-")


@pytest.mark.parametrize("size", [(48, 64), (120, 160), (200, 300)])
def test_batch_decode_with_resize_is_the_jax_decoder(files, size):
    got = native.decode_image_batch(files["img"], size)
    want = jax_native.decode_image_batch(files["img"], size)
    assert got.shape == (len(files["img"]), *size, 3)
    np.testing.assert_array_equal(got, want)


def test_flo_batch_and_dims_are_the_jax_reader(files):
    np.testing.assert_array_equal(
        native.read_flo_batch(files["flo"], (30, 44)),
        jax_native.read_flo_batch(files["flo"], (30, 44)))
    assert native.flo_dims(files["flo"][0]) == \
        jax_native.flo_dims(files["flo"][0]) == (30, 44)


def test_own_size_decode_is_cv2_imread(files):
    for p in files["img"]:
        want = cv2.imread(p, cv2.IMREAD_COLOR)
        assert native.image_dims(p) == want.shape[:2], p
        got = native.imread_bgr(p)
        assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, want, err_msg=p)
        assert native.image_supported(p) == jax_native.image_supported(p)


def test_grey_and_rgba_png_decode_as_cv2(tmp_path):
    rs = np.random.RandomState(1)
    img = _texture(rs, 40, 50)
    alpha = np.full((40, 50, 1), 255, np.uint8)  # opaque: cv2 drops it
    for name, arr in (("grey", img[..., 1]),
                      ("rgba", np.concatenate([img, alpha], -1))):
        p = str(tmp_path / f"{name}.png")
        cv2.imwrite(p, arr)
        np.testing.assert_array_equal(native.imread_bgr(p), cv2.imread(p))


def test_bad_files_raise(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\0" * 20)
    with pytest.raises(OSError):
        native.imread_bgr(str(p))
    with pytest.raises(OSError):
        native.image_dims(str(tmp_path / "missing.png"))
    with pytest.raises(OSError):
        native.decode_image_batch([str(p)], (8, 8))
    with pytest.raises(OSError):
        native.flo_dims(str(p))


FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH", "ALL_FILTERS"]


@pytest.mark.parametrize("kind", ["bgr", "grey", "bgra"])
@pytest.mark.parametrize("flt", FILTERS)
def test_python_png_reader_is_cv2_imread(tmp_path, kind, flt):
    """Files cv2 writes with each row filter (and all five mixed), in
    8-bit grey, RGB and RGBA: read bit for bit as cv2.imread reads them."""
    rs = np.random.RandomState(FILTERS.index(flt))
    img = _texture(rs, 45, 67)
    arr = {"bgr": img, "grey": img[..., 0],
           "bgra": np.concatenate([img, rs.randint(0, 256, (45, 67, 1),
                                                   dtype=np.uint8)], -1)}[kind]
    name = flt if flt == "ALL_FILTERS" else f"FILTER_{flt}"
    p = str(tmp_path / "f.png")
    assert cv2.imwrite(p, arr, [cv2.IMWRITE_PNG_FILTER,
                                getattr(cv2, f"IMWRITE_PNG_{name}")])
    np.testing.assert_array_equal(read_png_bgr(p), cv2.imread(p))


@pytest.mark.parametrize("shape", [(1, 1, 3), (31, 17, 3), (20, 30),
                                   (20, 30, 1)])
def test_png_writer_round_trips_through_cv2(tmp_path, shape):
    """BGR images come back from cv2.imread as written, grey ones from
    IMREAD_GRAYSCALE; both readers of the port read the file as cv2."""
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "w.png")
    write_png(p, img)
    if len(shape) == 3 and shape[-1] == 3:
        np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_COLOR), img)
    else:
        np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE),
                                      img.reshape(shape[:2]))
    np.testing.assert_array_equal(read_png_bgr(p), cv2.imread(p))
    np.testing.assert_array_equal(native.imread_bgr(p), cv2.imread(p))


def test_png_reader_refuses_what_it_does_not_read(tmp_path):
    p = tmp_path / "x.png"
    data = bytearray(png_bytes(np.zeros((4, 4, 3), np.uint8)))
    data[-5] ^= 1  # IEND's CRC
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_png_bgr(p)
    cv2.imwrite(str(p), np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        read_png_bgr(p)
    with pytest.raises(ValueError, match="must be"):
        png_bytes(np.zeros((4, 4, 2), np.uint8))
