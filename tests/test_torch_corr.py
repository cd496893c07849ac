"""The PyTorch port's correlation against the JAX package's: the numpy
oracle, the XLA sweep and the Pallas kernel in interpret mode.

Tolerances: 1e-5 in float32 (the sums over channels run in another
order), 0.05 for bf16 inputs (bf16 rounding of the inputs and output),
as tests/test_pallas_corr.py pins them for the JAX kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepof_tpu.ops.corr import correlation as jax_correlation
from deepof_tpu.ops.corr import correlation_oracle
from deepof_tpu.ops.pallas.corr import correlation_pallas
from deepof_tpu_torch.ops.corr import (correlation, correlation_nchw,
                                       correlation_reference)

# (shape, max_disp, stride): the plain case, and a ragged H with stride 2
CASES = [((2, 12, 16, 8), 2, 1), ((2, 11, 16, 8), 4, 2)]


def _feats(shape, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(*shape).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,max_disp,stride", CASES)
def test_corr_reference_matches_jax(shape, max_disp, stride):
    f1, f2 = _feats(shape)
    got = correlation(torch.from_numpy(f1), torch.from_numpy(f2),
                      max_disp, stride).numpy()
    want_oracle = correlation_oracle(f1, f2, max_disp=max_disp, stride=stride)
    want_xla = np.asarray(jax_correlation(jnp.asarray(f1), jnp.asarray(f2),
                                          max_disp, stride, impl="xla"))
    want_pallas = np.asarray(correlation_pallas(
        jnp.asarray(f1), jnp.asarray(f2), max_disp, stride, 4, True))
    assert got.shape == want_oracle.shape
    for want in (want_oracle, want_xla, want_pallas):
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_corr_reference_bf16_inputs():
    f1, f2 = _feats((2, 12, 16, 8))
    got = correlation(torch.from_numpy(f1).bfloat16(),
                      torch.from_numpy(f2).bfloat16(), 2, 1)
    assert got.dtype == torch.bfloat16  # f32 accumulation, input dtype out
    want = correlation_oracle(f1, f2, max_disp=2, stride=1)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.05,
                               rtol=0.05)
    pallas = correlation_pallas(jnp.asarray(f1, jnp.bfloat16),
                                jnp.asarray(f2, jnp.bfloat16), 2, 1, 4, True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), atol=0.05,
                               rtol=0.05)


@pytest.mark.parametrize("shape,max_disp,stride", CASES)
def test_corr_nhwc_and_nchw_agree_exactly(shape, max_disp, stride):
    f1, f2 = _feats(shape, seed=1)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    nhwc = correlation(t1, t2, max_disp, stride)
    nchw = correlation_nchw(t1.permute(0, 3, 1, 2).contiguous(),
                            t2.permute(0, 3, 1, 2).contiguous(),
                            max_disp, stride)
    assert torch.equal(nhwc.permute(0, 3, 1, 2), nchw)
    ref = correlation_reference(t1.permute(0, 3, 1, 2).contiguous(),
                                t2.permute(0, 3, 1, 2).contiguous(),
                                max_disp, stride)
    assert torch.equal(ref, nchw)


def test_corr_impl_rejects_unknown():
    t = torch.zeros(1, 4, 3, 3)
    with pytest.raises(ValueError, match="impl"):
        correlation_nchw(t, t, 1, 1, impl="xla")


def test_corr_impl_has_no_reference_route():
    """No setting sends a tensor around the kernel: the plain version is
    what "auto" runs on a CPU tensor, never a value of its own."""
    from deepof_tpu_torch.ops.cuda.corr import launches

    t = torch.zeros(1, 4, 3, 3)
    before = launches.count
    with pytest.raises(ValueError, match="only 'auto'"):
        correlation_nchw(t, t, 1, 1, impl="reference")
    with pytest.raises(ValueError, match="only 'auto'"):
        correlation(t.permute(0, 2, 3, 1), t.permute(0, 2, 3, 1), 1, 1,
                    impl="reference")
    assert launches.count == before


def test_corr_cuda_wrapper_rejects_cpu_tensors():
    """The kernel wrapper never runs the plain version: a CPU tensor is
    refused, not computed."""
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda, launches

    t = torch.zeros(1, 4, 3, 3)
    before = launches.count
    with pytest.raises(ValueError, match="cpu"):
        correlation_cuda(t, t, 1, 1)
    assert launches.count == before
