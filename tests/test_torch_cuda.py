"""Tests of the PyTorch port's CUDA kernels, on the card.

They skip on a host without a CUDA device. This file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from deepof_tpu_torch.ops.corr import correlation_nchw, correlation_reference

# (B, C, H, W), max_disp, stride: plain, ragged with stride 2, ragged odd
CASES = [((2, 8, 12, 16), 2, 1), ((2, 8, 11, 16), 4, 2),
         ((3, 40, 13, 17), 4, 1), ((1, 20, 9, 70), 6, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", CASES)
def test_corr_kernel_matches_reference(cuda, shape, max_disp, stride):
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda, launches

    rs = np.random.RandomState(0)
    f1 = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)
    f2 = torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)
    before = launches.count
    got = correlation_nchw(f1, f2, max_disp, stride)  # "auto": the kernel
    assert launches.count == before + 1
    want = correlation_reference(f1, f2, max_disp, stride)
    # float32, sums over channels in another order
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    assert torch.equal(got, correlation_cuda(f1, f2, max_disp, stride))


@pytest.mark.cuda
def test_corr_kernel_refuses_what_it_does_not_take(cuda):
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda

    t = torch.zeros(1, 4, 5, 6, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        correlation_cuda(t.bfloat16(), t.bfloat16(), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_cuda(t.transpose(2, 3), t.transpose(2, 3), 2, 1)
    with pytest.raises(ValueError, match="vs"):
        correlation_cuda(t, t[:, :2].contiguous(), 2, 1)
