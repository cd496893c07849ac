"""The PyTorch port's bf16 compute (`train.compute_dtype="bfloat16"`)
against the JAX package's, op by op, on the CPU: the cost volume and its
gradients (`ops/corr.py::Correlation` on bf16 feature maps) and the
model blocks `ConvELU`, `Deconv` and `FlowDecoder` with `dtype=bf16`
against the flax blocks with `dtype=jnp.bfloat16`, from the same weights.

The JAX side runs as its own tests run it: the Pallas correlation in
interpret mode (its custom VJP `_bwd` for the gradients) and XLA on the
CPU. Tolerances, each with its reason and the value measured on an
x86-64 CPU:
  - cost volume vs `correlation_pallas(interpret=True)`: one bf16 ulp of
    each value. Both upcast to float32, sum the channels in float32 and
    round once to bf16; the float32 sums differ in their order only, so
    the rounded values differ by at most one ulp (measured: 0 ulp at
    both geometries here; 1 ulp in 1 of 84,672 values at C = 256).
  - cost volume vs the XLA sweep (`ops/corr.py::correlation`, what
    `impl="auto"` runs on the CPU): 1e-2 of the largest entry. The sweep
    rounds every product to bf16 before its float32 mean (measured
    3.9e-3 and 5.3e-3).
  - gradients vs `jax.grad` through `correlation_pallas`: 1e-2 of each
    gradient's largest entry. The JAX VJP rounds g * f / C to bf16 before
    it adds into float32; the port multiplies in float32 (measured
    3.7e-3 / 3.4e-3 and 4.9e-3 / 4.2e-3 for df1 / df2).
  - blocks: 1.6e-2 of the largest entry. flax rounds the bf16 conv
    result and then adds the bias in bf16; oneDNN (and cuDNN) add the
    bias before the one rounding, so part of the elements differ by one
    bf16 ulp (measured at most 6.9e-3; the flax block's own bf16 vs
    float32 gap is 3.4e-3 to 5.8e-3, so this limit cannot tell the
    precisions apart).
  - blocks with a zero bias: one bf16 ulp of each value, the ulp floored
    at that of 2**-12 of the largest entry (near a sum that cancels to
    ~0 the float32 summation order alone moves a few ulps of the small
    result). Both round the float32 conv sum once and the ELU once, so
    only the summation order differs (measured at most 1 ulp, in under
    0.03% of the values). This is the case that tells bf16 from float32:
    the block computed in float32 and rounded at the end is off by more
    than one ulp in ~17% of the values, by hundreds of ulps at most
    (394 to 1194 over five seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from deepof_tpu.models import common as jax_common
from deepof_tpu.ops.corr import correlation as jax_correlation
from deepof_tpu.ops.pallas.corr import correlation_pallas
from deepof_tpu_torch.convert import load_flax_params
from deepof_tpu_torch.models import common
from deepof_tpu_torch.ops.corr import (Correlation,
                                       correlation_backward_reference,
                                       correlation_reference)

# (B, C, H, W), max_disp, stride: a small grid, and a ragged one (W = 17,
# C = 40, H not a multiple of the Pallas kernel's 8-row tile)
GEOMETRIES = [((2, 8, 12, 16), 4, 2), ((2, 40, 13, 17), 4, 1)]
XLA_TOL = 1e-2
GRAD_TOL = 1e-2
BLOCK_TOL = 1.6e-2


def _bf16_pair(shape, seed):
    """Two NHWC feature maps drawn with numpy and rounded to bf16: (jax
    arrays, NCHW torch tensors holding the same bf16 values)."""
    rs = np.random.RandomState(seed)
    b, c, h, w = shape
    arrays = [jnp.asarray(rs.randn(b, h, w, c).astype(np.float32),
                          jnp.bfloat16) for _ in range(2)]
    return arrays, [_to_torch(a) for a in arrays]


def _to_torch(a):
    """A bf16 NHWC jax array as a contiguous bf16 NCHW torch tensor."""
    return torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() \
        .permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _bf16_ulp(x):
    """One bf16 ulp at each value of x (bf16 keeps 8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float32)), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("shape,max_disp,stride", GEOMETRIES)
def test_bf16_cost_volume_matches_the_pallas_kernel(shape, max_disp, stride):
    (j1, j2), (t1, t2) = _bf16_pair(shape, 0)
    got = Correlation.apply(t1, t2, max_disp, stride)
    assert got.dtype == torch.bfloat16
    want = correlation_pallas(j1, j2, max_disp, stride, 8, True)
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    g = _nhwc(got)
    assert g.shape == want.shape
    assert np.all(np.abs(g - want) <= _bf16_ulp(want))
    sweep = np.asarray(jax_correlation(j1, j2, max_disp, stride,
                                       impl="xla").astype(jnp.float32))
    np.testing.assert_allclose(g, sweep, rtol=0,
                               atol=XLA_TOL * np.abs(sweep).max())


@pytest.mark.parametrize("shape,max_disp,stride", GEOMETRIES)
def test_bf16_cost_volume_gradients_match_the_pallas_vjp(shape, max_disp,
                                                         stride):
    (j1, j2), (t1, t2) = _bf16_pair(shape, 1)
    b, c, h, w = shape
    n = 2 * (max_disp // stride) + 1
    jg = jnp.asarray(np.random.RandomState(2).randn(b, h, w, n * n)
                     .astype(np.float32), jnp.bfloat16)
    _, vjp = jax.vjp(lambda a, v: correlation_pallas(a, v, max_disp, stride,
                                                     8, True), j1, j2)
    want = vjp(jg)
    t1.requires_grad_(True)
    t2.requires_grad_(True)
    Correlation.apply(t1, t2, max_disp, stride).backward(_to_torch(jg))
    for name, got, w in (("df1", t1.grad, want[0]), ("df2", t2.grad,
                                                     want[1])):
        assert got.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(_nhwc(got), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_plain_versions_upcast_and_return_the_input_dtype():
    """`correlation_reference` and `correlation_backward_reference` on
    bf16 inputs (and a bf16 cotangent) give the float32 results on the
    upcast inputs, rounded once to bf16."""
    rs = np.random.RandomState(3)
    f1, f2 = (torch.from_numpy(rs.randn(2, 16, 9, 12).astype(np.float32))
              .bfloat16() for _ in range(2))
    g = torch.from_numpy(rs.randn(2, 25, 9, 12).astype(np.float32)).bfloat16()
    got = correlation_reference(f1, f2, 4, 2)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, correlation_reference(f1.float(), f2.float(), 4,
                                                  2).bfloat16())
    grads = correlation_backward_reference(f1, f2, g, 4, 2)
    want = correlation_backward_reference(f1.float(), f2.float(), g.float(),
                                          4, 2)
    for got, w in zip(grads, want):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, w.bfloat16())


def _random_params(params, rs):
    """Normals scaled by 1/sqrt(fan-in) for kernels and 0.1 for biases
    (the bilinear deconv init would hide a missing kernel flip)."""
    def draw(a):
        scale = 0.1 if len(a.shape) == 1 else 1.0 / np.sqrt(
            np.prod(a.shape[:-1]))
        return (rs.randn(*a.shape) * scale).astype(np.float32)

    return jax.tree_util.tree_map(draw, params)


def _check_close(got, want, what):
    g, w = _nhwc(got), np.asarray(want.astype(jnp.float32))
    assert g.shape == w.shape, what
    np.testing.assert_allclose(g, w, rtol=0,
                               atol=BLOCK_TOL * np.abs(w).max(),
                               err_msg=what)


def _bf16_ulps_floored(got, want):
    """|got - want| in bf16 ulps of max(|want|, 2**-12 * max |want|)."""
    w = np.asarray(want.astype(jnp.float32))
    return np.abs(_nhwc(got) - w) / _bf16_ulp(
        np.maximum(np.abs(w), np.abs(w).max() * 2.0**-12))


BLOCKS = ["conv_elu", "conv_linear", "deconv", "deconv_linear"]


def _bf16_blocks(name, zero_bias=False):
    """The flax block `name` in bf16 applied to a numpy input, and the
    port's block with the same weights: (port output, flax output)."""
    rs = np.random.RandomState(4)
    x = rs.randn(2, 17, 23, 16).astype(np.float32)
    bf = jnp.bfloat16
    jax_block, block = {
        "conv_elu": (jax_common.ConvELU(24, (3, 3), 2, dtype=bf),
                     common.ConvELU(16, 24, (3, 3), 2,
                                    dtype=torch.bfloat16)),
        "conv_linear": (jax_common.ConvELU(24, (5, 5), act=False, dtype=bf),
                        common.ConvELU(16, 24, (5, 5), act=False,
                                       dtype=torch.bfloat16)),
        "deconv": (jax_common.Deconv(24, dtype=bf),
                   common.Deconv(16, 24, dtype=torch.bfloat16)),
        "deconv_linear": (jax_common.Deconv(24, act=False, dtype=bf),
                          common.Deconv(16, 24, act=False,
                                        dtype=torch.bfloat16)),
    }[name]
    params = _random_params(jax_block.init(jax.random.PRNGKey(0),
                                           jnp.asarray(x))["params"], rs)
    if zero_bias:
        params = jax.tree_util.tree_map(
            lambda a: a * 0 if a.ndim == 1 else a, params)
    want = jax_block.apply({"params": params}, jnp.asarray(x))
    holder = nn.Module()
    holder.block = block
    load_flax_params(holder, {"block": params})
    assert all(p.dtype == torch.float32 for p in block.parameters())
    got = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.bfloat16 and want.dtype == bf
    return got, want


@pytest.mark.parametrize("name", BLOCKS)
def test_bf16_blocks_match_flax(name):
    _check_close(*_bf16_blocks(name), name)


@pytest.mark.parametrize("name", BLOCKS)
def test_bf16_blocks_without_bias_round_as_flax(name):
    got, want = _bf16_blocks(name, zero_bias=True)
    assert _bf16_ulps_floored(got, want).max() <= 1, name


def test_bf16_flow_decoder_matches_flax():
    rs = np.random.RandomState(5)
    feats = [rs.randn(2, 3, 4, 32).astype(np.float32),
             rs.randn(2, 6, 8, 16).astype(np.float32),
             rs.randn(2, 12, 16, 8).astype(np.float32)]
    jax_dec = jax_common.FlowDecoder(upconv_features=(16, 8),
                                     dtype=jnp.bfloat16)
    jfeats = [jnp.asarray(f) for f in feats]
    params = _random_params(jax_dec.init(jax.random.PRNGKey(0),
                                         jfeats)["params"], rs)
    want = jax_dec.apply({"params": params}, jfeats)
    dec = common.FlowDecoder([32, 16, 8], [16, 8], dtype=torch.bfloat16)
    load_flax_params(dec, params)
    got = dec([torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats])
    assert len(got) == len(want) == 3
    for level, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16
        _check_close(g, w, f"level {level}")
