"""The PyTorch port's bilinear backward warp against the JAX package's.

Inputs are numpy draws from fixed seeds, fed to both packages.
Tolerance: 1e-5 absolute and relative, in float32, for values and
gradients alike. The plain version repeats the XLA formulation's
arithmetic (the same gather, the same blend order), so the only
differences are float32 rounding in another order of operations; the
JAX package pins its Pallas kernel to its XLA path at the same 1e-5
(`tests/test_pallas_warp.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepof_tpu.ops.pallas.warp import backward_warp_pallas
from deepof_tpu.ops.warp import backward_warp as jax_warp
from deepof_tpu_torch.ops.cuda import warp as cuda_warp
from deepof_tpu_torch.ops.warp import (BackwardWarpLevels, backward_warp,
                                       backward_warp_nchw,
                                       backward_warp_reference,
                                       warp_flow_grad_reference)
from test_warp import warp_oracle

TOL = dict(atol=1e-5, rtol=1e-5)

# the shapes and flow magnitudes of tests/test_pallas_warp.py:20-27
PALLAS_CASES = [((2, 5, 7, 3), 3.0), ((2, 10, 14, 3), 30.0),
                ((1, 40, 56, 3), 80.0), ((1, 80, 112, 3), 20.0),
                ((2, 16, 128, 2), 200.0)]


def _inputs(shape, mag, seed=0):
    rs = np.random.RandomState(seed)
    b, h, w, c = shape
    img = rs.rand(b, h, w, c).astype(np.float32)
    flow = (rs.randn(b, h, w, 2) * mag).astype(np.float32)
    return img, flow


def _port(img, flow, impl="auto"):
    return backward_warp(torch.from_numpy(img), torch.from_numpy(flow),
                         impl).numpy()


def _plain(img, flow):
    """`backward_warp_reference` on NHWC numpy arrays."""
    out = backward_warp_reference(
        torch.from_numpy(img).permute(0, 3, 1, 2).contiguous(),
        torch.from_numpy(flow).permute(0, 3, 1, 2).contiguous())
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("shape,mag", PALLAS_CASES)
def test_plain_warp_matches_xla_and_pallas(shape, mag):
    img, flow = _inputs(shape, mag)
    got = _plain(img, flow)
    np.testing.assert_array_equal(_port(img, flow), got)
    want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), "xla"))
    np.testing.assert_allclose(got, want, **TOL)
    pallas = np.asarray(backward_warp_pallas(jnp.asarray(img),
                                             jnp.asarray(flow), True))
    np.testing.assert_allclose(got, pallas, **TOL)


@pytest.mark.parametrize("shape,mag", [((2, 6, 9, 3), 2.0),
                                       ((1, 7, 5, 2), 8.0),
                                       ((2, 4, 4, 1), 0.5)])
def test_plain_warp_matches_numpy_oracle(shape, mag):
    img, flow = _inputs(shape, mag, seed=1)
    np.testing.assert_allclose(_plain(img, flow), warp_oracle(img, flow),
                               **TOL)


@pytest.mark.parametrize("mag", [2.0, 50.0])
def test_function_gradients_match_jax(mag):
    """Flow and image cotangents of the autograd.Function against jax's
    VJP of the XLA warp; flows x50 saturate most pixels at the border,
    where the flow gradient must be exactly the JAX path's."""
    img, flow = _inputs((2, 10, 14, 3), mag, seed=2)
    ct = np.random.RandomState(3).randn(2, 10, 14, 3).astype(np.float32)
    _, vjp = jax.vjp(lambda i, f: jax_warp(i, f, "xla"), jnp.asarray(img),
                     jnp.asarray(flow))
    want_img, want_flow = (np.asarray(g) for g in vjp(jnp.asarray(ct)))

    ti = torch.from_numpy(img).requires_grad_(True)
    tf = torch.from_numpy(flow).requires_grad_(True)
    backward_warp(ti, tf).backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tf.grad.numpy(), want_flow, **TOL)
    np.testing.assert_allclose(ti.grad.numpy(), want_img, **TOL)
    if mag > 10:  # saturated pixels: zero flow gradient on that side
        sat = np.asarray(want_flow == 0.0)
        assert sat.any() and (tf.grad.numpy()[sat] == 0.0).all()


def test_function_on_cpu_runs_the_plain_version():
    img, flow = _inputs((2, 6, 8, 3), 3.0, seed=4)
    ti = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous()
    tf = torch.from_numpy(flow).permute(0, 3, 1, 2).contiguous()
    before = (cuda_warp.fwd_launches.count, cuda_warp.grad_launches.count)
    tf.requires_grad_(True)
    out = BackwardWarpLevels.apply(1, ti, tf)[0]
    assert torch.equal(out, backward_warp_reference(ti, tf.detach()))
    out.square().sum().backward()
    # the flow gradient is the plain flow-gradient version, bit for bit,
    # and autograd of the plain forward up to rounding
    assert torch.equal(tf.grad, warp_flow_grad_reference(
        ti, tf.detach(), 2 * out.detach()))
    ref = tf.detach().clone().requires_grad_(True)
    backward_warp_reference(ti, ref).square().sum().backward()
    torch.testing.assert_close(tf.grad, ref.grad, rtol=1e-6, atol=1e-6)
    # every TPU route name takes the same path on a CPU tensor
    for impl in ("auto", "xla", "pallas"):
        assert torch.equal(backward_warp_nchw(ti, tf.detach(), impl), out)
    assert (cuda_warp.fwd_launches.count,
            cuda_warp.grad_launches.count) == before
    for impl in ("grid_sample", "reference"):
        with pytest.raises(ValueError, match="unknown warp impl"):
            backward_warp_nchw(ti, tf, impl)


def test_nonfinite_flow_keeps_finite_pixels_finite():
    img, flow = _inputs((1, 6, 7, 3), 3.0, seed=5)
    flow[0, 1, 2] = (np.nan, 1.0)
    flow[0, 3, 4] = (np.inf, -np.inf)
    flow[0, 4, 5] = (1e30, -1e30)
    out = _plain(img, flow)
    bad = ~np.isfinite(flow).all(-1)
    assert np.isfinite(out[~bad]).all()
    # a NaN flow gives NaN there, as the JAX package's XLA path does (an
    # infinite one is left to each package's float-to-int conversion)
    want = np.asarray(jax_warp(jnp.asarray(img), jnp.asarray(flow), "xla"))
    assert np.isnan(out[0, 1, 2]).all() and np.isnan(want[0, 1, 2]).all()
    # a huge finite flow lands on the border, exactly as the oracle does
    np.testing.assert_allclose(out[0, 4, 5], warp_oracle(
        img, np.where(np.isfinite(flow), flow, 0.0))[0, 4, 5], **TOL)


def test_grid_sample_border_is_the_library_yardstick():
    """F.grid_sample(bilinear, border, align_corners=True) on normalised
    pixel coordinates computes the same warp (ROADMAP F4, corrected): it
    is timed beside the kernels, never used by the port."""
    img, flow = _inputs((2, 24, 32, 3), 6.0, seed=6)
    b, h, w, _ = img.shape
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([2 * (xs + flow[..., 0]) / (w - 1) - 1,
                     2 * (ys + flow[..., 1]) / (h - 1) - 1], -1)
    lib = F.grid_sample(torch.from_numpy(img).permute(0, 3, 1, 2),
                        torch.from_numpy(grid.astype(np.float32)),
                        mode="bilinear", padding_mode="border",
                        align_corners=True).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(lib, _plain(img, flow), **TOL)
