"""Tests of the PyTorch port's CUDA kernels (correlation and its two
backward kernels, in float32 and bf16; warp and its flow gradient, one
level and a list of levels per launch, and the T-frame volume loss's
folded pairs), and of the serving path that
reaches them (a warm-start dispatch; the int8 tier's weights), on the
card.

They skip on a host without a CUDA device. This file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Add `-k corr`, `-k corr_bwd`, `-k bf16` or `-k warp` for one kernel's
cases, `-k "warm or int8"` for the serving cases, `-k "pinned_ring or
device_side_skip"` for the metric fetch and the skip on the card,
`-k "inception or tf32"` for Inception-v3's train step and the float32
rule (F17), `-k "vgg or augmentation or occlusion"` for VGG16Flow's step,
the augmentation's warp and the occlusion warp (C = 2), `-k "bf16_warp
or quality"` for the warps' bf16 instances (loss.gather_dtype=bfloat16)
and the quality scorer's warp, `-k library` for the artifact store's
library install, `-k "ranks or nccl"` for data parallelism on the card
(two gloo ranks sharing it, one NCCL rank).
"""

import time

import numpy as np
import pytest
import torch

from deepof_tpu_torch.ops.corr import (correlation_backward_reference,
                                       correlation_nchw, correlation_reference)

# (B, C, H, W), max_disp, stride. The kernel's tiles (csrc/corr.cu): 64
# columns a block, 8 a thread, 7 displacement columns a thread, up to 7
# displacement rows a block, 16 channels a chunk; one template instance
# for each stride 1-4 and a generic one. So: W not a multiple of 8 (17,
# 23, 33, 70, 130); n not a multiple of 7 (5, 9) and n = 1; C not a
# multiple of 16 (40, 17, 12); H under the pad (5 < 20), where whole
# blocks write zeros; n = 41, which splits the displacement columns over
# two blocks; strides 1-6; and the serving shape.
CASES = [((2, 8, 12, 16), 2, 1), ((2, 8, 11, 16), 4, 2),
         ((3, 40, 13, 17), 4, 1), ((1, 20, 9, 70), 6, 3),
         ((2, 8, 10, 20), 0, 1), ((2, 12, 5, 33), 20, 2),
         ((3, 17, 11, 64), 12, 3), ((2, 24, 9, 36), 8, 4),
         ((2, 20, 9, 23), 10, 5), ((1, 6, 8, 16), 12, 6),
         ((1, 40, 7, 130), 20, 1), ((8, 256, 48, 64), 20, 2)]


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
    # the same float32 fused multiply-adds over the channels, ascending,
    # and the same float32 1/C: the same bits at every C
    assert torch.equal(got, want)
    assert torch.equal(got, correlation_cuda(f1, f2, max_disp, stride))


@pytest.mark.cuda
def test_corr_kernel_refuses_what_it_does_not_take(cuda):
    from deepof_tpu_torch.ops.cuda.corr import correlation_cuda

    t = torch.zeros(1, 4, 5, 6, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        correlation_cuda(t.half(), t.half(), 2, 1)
    with pytest.raises(TypeError, match="mixed dtypes"):
        correlation_cuda(t, t.bfloat16(), 2, 1)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_cuda(t.transpose(2, 3), t.transpose(2, 3), 2, 1)
    with pytest.raises(ValueError, match="vs"):
        correlation_cuda(t, t[:, :2].contiguous(), 2, 1)


# (B, C, H, W), max_disp, stride of the backward kernels (csrc/corr_bwd.cu:
# 64 columns x 64 channels a block, 8 columns x 8 channels a thread, the
# displacement columns staged 21 at a time and walked 7 at a time; one
# template instance for each stride 1-4 and a generic one): strides 1-5,
# C not a multiple of 8 or 64 (40, 17, 12, 3, 33, 264), W not a multiple
# of 64 and across tiles (16, 17, 23, 33, 36, 65, 130), H and W under the
# pad (5 < 20, W 9 < 20), n = 41 (two staged blocks of displacement
# columns), max_disp = 0 (n = 1), and the training shape (batch 4).
CORR_BWD_CASES = [((2, 8, 12, 16), 2, 1), ((3, 40, 13, 17), 4, 1),
                  ((2, 12, 11, 16), 4, 2), ((3, 17, 11, 64), 12, 3),
                  ((2, 24, 9, 36), 8, 4), ((2, 20, 9, 23), 10, 5),
                  ((2, 3, 10, 20), 0, 1), ((2, 12, 5, 33), 20, 2),
                  ((2, 33, 7, 65), 8, 2), ((1, 264, 6, 130), 20, 2),
                  ((2, 16, 5, 9), 20, 2), ((1, 64, 9, 70), 20, 1),
                  ((2, 128, 8, 65), 0, 1), ((2, 64, 12, 130), 12, 4),
                  ((4, 256, 48, 64), 20, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", CORR_BWD_CASES)
def test_corr_bwd_kernels_match_reference(cuda, shape, max_disp, stride):
    from deepof_tpu_torch.ops.cuda import corr as cc

    rs = np.random.RandomState(1)
    b, c, h, w = shape
    n = 2 * (max_disp // stride) + 1
    f1, f2 = (torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(cuda)
              .requires_grad_(True) for _ in range(2))
    g = torch.from_numpy(rs.randn(b, n * n, h, w).astype(np.float32)).to(cuda)
    counters = (cc.launches, cc.bwd_f1_launches, cc.bwd_f2_launches)
    before = [k.count for k in counters]
    correlation_nchw(f1, f2, max_disp, stride).backward(g)  # the kernels
    assert [k.count - b0 for k, b0 in zip(counters, before)] == [1, 1, 1]
    want = correlation_backward_reference(f1.detach(), f2.detach(), g,
                                          max_disp, stride)
    # float32 sums of up to n*n*C terms in the plain version's order, but
    # scaled by 1/C at the end where the plain version divides g by C
    # first: 1e-5 of the largest gradient entry, and the same bits where
    # C is a power of two (the scaling is exact)
    for got, w in zip((f1.grad, f2.grad), want):
        scale = float(w.abs().max())
        torch.testing.assert_close(got, w, atol=1e-5 * scale, rtol=0)
        if c & (c - 1) == 0:
            assert torch.equal(got, w)
    # a fixed summation order and no atomics: the same bits every call
    again = cc.correlation_bwd_cuda(f1.detach(), f2.detach(), g, max_disp,
                                    stride)
    assert torch.equal(again[0], f1.grad) and torch.equal(again[1], f2.grad)


@pytest.mark.cuda
def test_corr_kernels_refuse_what_they_do_not_take(cuda):
    from deepof_tpu_torch.ops.cuda.corr import (correlation_bwd_cuda,
                                                correlation_cuda)

    t = torch.zeros(1, 4, 5, 6, device=cuda)
    g = torch.zeros(1, 9, 5, 6, device=cuda)
    with pytest.raises(RuntimeError, match="requires grad"):
        correlation_cuda(t.clone().requires_grad_(True), t, 2, 2)
    with torch.no_grad():  # no graph: the kernel may run
        correlation_cuda(t.clone().requires_grad_(True), t, 2, 2)
    with pytest.raises(TypeError, match="mixed dtypes"):
        correlation_bwd_cuda(t, t, g.bfloat16(), 2, 2)
    with pytest.raises(TypeError, match="mixed dtypes"):
        correlation_bwd_cuda(t.bfloat16(), t, g.bfloat16(), 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        correlation_bwd_cuda(t, t, g.transpose(2, 3), 2, 2)
    with pytest.raises(ValueError, match="want"):
        correlation_bwd_cuda(t, t, g, 2, 1)  # n = 5: g needs 25 maps


def _bf16(rs, *shape, device):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32)).to(
        device).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", CASES)
def test_corr_bf16_kernel_is_the_f32_kernel_rounded(cuda, shape, max_disp,
                                                    stride):
    """The bf16 forward stages bf16 into the float32 kernel's tiles and
    rounds its float32 result once: bit for bit the float32 kernel on the
    upcast inputs, rounded to bf16, and so the plain version's bits
    wherever the float32 kernel gives them (at every C)."""
    from deepof_tpu_torch.ops.cuda import corr as cc

    rs = np.random.RandomState(2)
    f1, f2 = (_bf16(rs, *shape, device=cuda) for _ in range(2))
    counters = (cc.bf16_launches, cc.launches)
    before = [k.count for k in counters]
    got = correlation_nchw(f1, f2, max_disp, stride)  # "auto": the kernel
    assert [k.count - b0 for k, b0 in zip(counters, before)] == [1, 0]
    assert got.dtype == torch.bfloat16
    f32 = cc.correlation_cuda(f1.float(), f2.float(), max_disp, stride)
    assert torch.equal(got, f32.bfloat16())
    assert torch.equal(got, correlation_reference(f1, f2, max_disp, stride))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,max_disp,stride", CORR_BWD_CASES)
def test_corr_bwd_bf16_kernels_are_the_f32_kernels_rounded(cuda, shape,
                                                           max_disp, stride):
    """Both bf16 backward kernels: bit for bit the float32 kernels on the
    upcast inputs, rounded to bf16; the plain backward's bits where C is
    a power of two (as for float32); the same bits every call."""
    from deepof_tpu_torch.ops.cuda import corr as cc

    rs = np.random.RandomState(3)
    b, c, h, w = shape
    n = 2 * (max_disp // stride) + 1
    f1, f2 = (_bf16(rs, *shape, device=cuda).requires_grad_(True)
              for _ in range(2))
    g = _bf16(rs, b, n * n, h, w, device=cuda)
    counters = (cc.bf16_launches, cc.bwd_f1_bf16_launches,
                cc.bwd_f2_bf16_launches, cc.launches, cc.bwd_f1_launches,
                cc.bwd_f2_launches)
    before = [k.count for k in counters]
    correlation_nchw(f1, f2, max_disp, stride).backward(g)  # the kernels
    assert [k.count - b0 for k, b0 in zip(counters, before)] == [
        1, 1, 1, 0, 0, 0]
    got = (f1.grad, f2.grad)
    a1, a2 = f1.detach(), f2.detach()
    f32 = cc.correlation_bwd_cuda(a1.float(), a2.float(), g.float(),
                                  max_disp, stride)
    plain = correlation_backward_reference(a1, a2, g, max_disp, stride)
    for x, w32, p in zip(got, f32, plain):
        assert x.dtype == p.dtype == torch.bfloat16
        assert torch.equal(x, w32.bfloat16())
        if c & (c - 1) == 0:
            assert torch.equal(x, p)
    again = cc.correlation_bwd_cuda(a1, a2, g, max_disp, stride)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


# (B, C, H, W), flow magnitude: training pyramid levels, a ragged shape
# and huge flows that saturate at the border
WARP_CASES = [((4, 3, 192, 256), 5.0), ((4, 3, 24, 32), 5.0),
              ((4, 3, 6, 8), 5.0), ((3, 5, 13, 70), 3.0),
              ((2, 3, 48, 64), 200.0)]


def _warp_inputs(cuda, shape, mag, seed=0):
    rs = np.random.RandomState(seed)
    b, c, h, w = shape
    img = torch.from_numpy(rs.rand(b, c, h, w).astype(np.float32)).to(cuda)
    flow = torch.from_numpy((rs.randn(b, 2, h, w) * mag).astype(
        np.float32)).to(cuda)
    ct = torch.from_numpy(rs.randn(b, c, h, w).astype(np.float32)).to(cuda)
    return img, flow, ct


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mag", WARP_CASES)
def test_warp_kernels_match_reference(cuda, shape, mag):
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (backward_warp_nchw,
                                           backward_warp_reference)

    img, flow, ct = _warp_inputs(cuda, shape, mag)
    before = (cw.fwd_launches.count, cw.grad_launches.count)
    f = flow.clone().requires_grad_(True)
    got = backward_warp_nchw(img, f)  # "auto": the kernels
    got.backward(ct)
    assert (cw.fwd_launches.count, cw.grad_launches.count) == (
        before[0] + 1, before[1] + 1)
    ref = flow.clone().requires_grad_(True)
    want = backward_warp_reference(img, ref)
    want.backward(ct)
    # float32; the kernel fuses multiply-adds where autograd rounds each
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(f.grad, ref.grad, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_warp_kernels_survive_nonfinite_flows(cuda):
    """NaN, inf and huge flows: no fault, finite outputs where the flow
    is finite, and the plain version's values everywhere else too (NaN
    where it gives NaN, as the JAX package's XLA path does)."""
    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_cuda,
                                                warp_fwd_cuda)
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    img, flow, ct = _warp_inputs(cuda, (2, 3, 16, 20), 3.0, seed=1)
    nan, inf = float("nan"), float("inf")
    flow[0, 0, 2, 3] = nan
    flow[0, 1, 4, 5] = inf
    flow[1, 0, 6, 7] = -inf
    flow[1, 1, 8, 9] = 3e38
    flow[0, 0, 10, 11], flow[0, 1, 10, 11] = inf, nan
    flow[1, 0, 12, 13], flow[1, 1, 1, 2] = -3e38, -inf
    # a NaN weight beside a side saturated at the left or top, whose
    # gradient is exactly 0 in the plain version
    flow[0, 0, 5, 6], flow[0, 1, 5, 6] = nan, -50.0
    flow[1, 0, 9, 10], flow[1, 1, 9, 10] = -50.0, nan
    out = warp_fwd_cuda(img, flow)
    grad = warp_flow_grad_cuda(img, flow, ct)
    torch.cuda.synchronize()
    bad = ~torch.isfinite(flow).all(1)  # (B, H, W)
    assert torch.isfinite(out.permute(0, 2, 3, 1)[~bad]).all()
    assert torch.isfinite(grad.permute(0, 2, 3, 1)[~bad]).all()

    f = flow.clone().requires_grad_(True)
    want = backward_warp_reference(img, f)
    want.backward(ct)
    assert out.isnan().any() and grad.isnan().any()
    torch.testing.assert_close(out, want.detach(), atol=1e-5, rtol=0,
                               equal_nan=True)
    torch.testing.assert_close(grad, f.grad, atol=1e-4, rtol=0,
                               equal_nan=True)


@pytest.mark.cuda
def test_warp_kernels_refuse_what_they_do_not_take(cuda):
    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_cuda,
                                                warp_flow_grad_levels_cuda,
                                                warp_fwd_cuda,
                                                warp_fwd_levels_cuda)

    img = torch.zeros(1, 3, 5, 6, device=cuda)
    flow = torch.zeros(1, 2, 5, 6, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        warp_fwd_cuda(img.half(), flow)
    with pytest.raises(TypeError, match="float32"):
        warp_fwd_cuda(img.bfloat16(), flow.bfloat16())
    with pytest.raises(TypeError, match="float32"):
        warp_flow_grad_cuda(img, flow, img.bfloat16())
    with pytest.raises(TypeError, match="one dtype"):
        warp_fwd_levels_cuda([img, img.bfloat16()], [flow, flow])
    with pytest.raises(ValueError, match="only the loss"):
        warp_fwd_levels_cuda([img.bfloat16()], [flow], site="augment")
    with pytest.raises(ValueError, match="does not match"):
        warp_fwd_cuda(img.transpose(2, 3), flow)
    with pytest.raises(ValueError, match="is on cpu"):
        warp_fwd_cuda(img.cpu(), flow)
    with pytest.raises(ValueError, match="is on cpu"):  # mixed devices
        warp_fwd_levels_cuda([img, img.cpu()], [flow, flow])
    with pytest.raises(ValueError, match="does not match"):
        warp_fwd_cuda(img, flow[..., :5].contiguous())
    with pytest.raises(ValueError, match="2 channels"):
        warp_fwd_cuda(img, img)
    with pytest.raises(ValueError, match="cotangent"):
        warp_flow_grad_cuda(img, flow, img[:, :2].contiguous())
    with pytest.raises(ValueError, match="1 to 8"):
        warp_fwd_levels_cuda([img] * 9, [flow] * 9)
    with pytest.raises(ValueError, match="does not share"):  # B
        warp_fwd_levels_cuda([img, img.expand(2, 3, 5, 6)],
                             [flow, flow.expand(2, 2, 5, 6)])
    with pytest.raises(ValueError, match="does not share"):  # C
        warp_flow_grad_levels_cuda([img, img[:, :2]], [flow, flow],
                                   [img, img[:, :2]])


def _levels(cuda, shapes, c, layout, mag, seed):
    """Images and cotangents (B, C, H, W) in `layout` ("nhwc": views of
    NHWC memory, as the loss hands them over; "nchw": contiguous), planar
    flows, one per (B, H, W)."""
    rs = np.random.RandomState(seed)
    images, flows, cts = [], [], []
    for b, h, w in shapes:
        img = torch.from_numpy(rs.rand(b, h, w, c).astype(np.float32))
        ct = torch.from_numpy(rs.randn(b, h, w, c).astype(np.float32))
        if layout == "nhwc":
            img, ct = img.permute(0, 3, 1, 2), ct.permute(0, 3, 1, 2)
        else:
            img = img.permute(0, 3, 1, 2).contiguous()
            ct = ct.permute(0, 3, 1, 2).contiguous()
        images.append(img.to(cuda))
        cts.append(ct.to(cuda))
        flows.append(torch.from_numpy((rs.randn(b, 2, h, w) * mag).astype(
            np.float32)).to(cuda))
    return images, flows, cts


# (B, H, W) level sets, C, layout, flow magnitude: the six main-path
# levels of the training loss in its layout and contiguous, ragged sets
# (W = 1, 3, 70, 129; H = 1), eight levels, C = 1 and 5, and flows that
# saturate at the border
MAIN_LEVELS = [(4, 192 >> k, 256 >> k) for k in range(6)]
# Inception-v3's at the flyingchairs preset's 320x448: finest at H/2, two
# levels of one size
INCEPTION_LEVELS = [(4, 160 >> k, 224 >> k) for k in (0, 1, 2, 2, 3, 4)]
# the ucf101 preset's 320x384 at batch 8: st_single's five VGG levels
# and st_baseline's six FlowNet-S levels, finest at H/2
UCF101_LEVELS = [(8, 160 >> k, 192 >> k) for k in range(5)]
UCF101_BASELINE_LEVELS = [(8, 160 >> k, 192 >> k) for k in range(6)]
LEVEL_CASES = [
    (MAIN_LEVELS, 3, "nhwc", 5.0), (MAIN_LEVELS, 3, "nchw", 5.0),
    (INCEPTION_LEVELS, 3, "nhwc", 5.0),
    (UCF101_LEVELS, 3, "nhwc", 5.0), (UCF101_BASELINE_LEVELS, 3, "nhwc", 5.0),
    ([(2, 1, 1), (2, 1, 3), (2, 5, 70), (2, 1, 129)], 3, "nhwc", 3.0),
    ([(3, 13, 70), (3, 7, 35), (3, 4, 17)], 5, "nhwc", 3.0),
    ([(2, 9, 300 - 37 * k) for k in range(8)], 1, "nchw", 3.0),
    ([(2, 48, 64), (2, 24, 32)], 3, "nhwc", 200.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes,c,layout,mag", LEVEL_CASES)
def test_warp_levels_match_reference(cuda, shapes, c, layout, mag):
    """One launch per direction for all levels: the forward and the flow
    gradient bitwise equal to their plain versions at every level, and
    the flow gradient within 1e-4 of autograd of the plain forward
    (float32; autograd rounds in another order)."""
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (BackwardWarpLevels,
                                           backward_warp_reference,
                                           warp_flow_grad_reference)

    images, flows, cts = _levels(cuda, shapes, c, layout, mag,
                                 seed=len(shapes))
    fused = [f.clone().requires_grad_(True) for f in flows]
    before = (cw.fwd_launches.count, cw.grad_launches.count)
    outs = BackwardWarpLevels.apply(len(images), *images, *fused)
    sum((o * g).sum() for o, g in zip(outs, cts)).backward()
    assert (cw.fwd_launches.count, cw.grad_launches.count) == (
        before[0] + 1, before[1] + 1)
    for k, (img, flow, ct) in enumerate(zip(images, flows, cts)):
        # the image's layout (a size-1 dimension's stride is free)
        assert [s for s, n in zip(outs[k].stride(), img.shape) if n > 1] \
            == [s for s, n in zip(img.stride(), img.shape) if n > 1]
        ref = flow.clone().requires_grad_(True)
        want = backward_warp_reference(img, ref)
        want.backward(ct)
        assert torch.equal(outs[k], want), f"level {k} {tuple(img.shape)}"
        assert torch.equal(fused[k].grad,
                           warp_flow_grad_reference(img, flow, ct)), \
            f"level {k} {tuple(img.shape)}"
        torch.testing.assert_close(fused[k].grad, ref.grad, atol=1e-4,
                                   rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
@pytest.mark.parametrize("shapes,c,layout,mag", [LEVEL_CASES[0],
                                                 LEVEL_CASES[5],
                                                 LEVEL_CASES[6],
                                                 LEVEL_CASES[7]])
def test_bf16_warp_levels_match_reference(cuda, impl, shapes, c, layout,
                                          mag):
    """The bf16-image instances (loss.gather_dtype=bfloat16): one launch
    per direction on every route, each level's output (bf16 on a Pallas
    -route level, float32 on an XLA-route one) and flow gradient (from a
    cotangent of the output's dtype, as autograd hands it) bitwise equal
    to the plain versions, counted on the bf16 counters."""
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (BackwardWarpLevels,
                                           backward_warp_reference,
                                           pallas_route,
                                           warp_flow_grad_reference)

    images, flows, cts = _levels(cuda, shapes, c, layout, mag,
                                 seed=len(shapes) + 40)
    images = [i.bfloat16() if layout == "nchw"
              else i.permute(0, 2, 3, 1).bfloat16().permute(0, 3, 1, 2)
              for i in images]
    routes = tuple(pallas_route(impl, i.shape[2], i.shape[3])
                   for i in images)
    fused = [f.clone().requires_grad_(True) for f in flows]
    counters = (cw.fwd_launches, cw.grad_launches, cw.fwd_bf16_launches,
                cw.grad_bf16_launches)
    before = [c_.count for c_ in counters]
    outs = BackwardWarpLevels.apply(routes, *images, *fused)
    cts = [ct.to(o.dtype) for ct, o in zip(cts, outs)]
    sum((o * g).float().sum() for o, g in zip(outs, cts)).backward()
    assert [c_.count - b for c_, b in zip(counters, before)] == [0, 0, 1, 1]
    for k, (img, flow, ct, p) in enumerate(zip(images, flows, cts, routes)):
        assert outs[k].dtype == (torch.bfloat16 if p else torch.float32)
        assert torch.equal(outs[k], backward_warp_reference(img, flow, p)), \
            f"level {k} {tuple(img.shape)}"
        assert torch.equal(fused[k].grad,
                           warp_flow_grad_reference(img, flow, ct)), \
            f"level {k} {tuple(img.shape)}"


@pytest.mark.cuda
def test_quality_scorer_warps_on_the_card(cuda):
    """The torch quality scorer on the card: one launch of the float32
    warp kernel a call, on its own counter, and the triple within 1e-4
    of the numpy reference's (float32 sums in another order)."""
    from deepof_tpu_torch.obs.quality import make_score_fn, score_pair_np
    from deepof_tpu_torch.ops.cuda import warp as cw

    rs = np.random.RandomState(70)
    x = rs.rand(2, 96, 128, 6).astype(np.float32) - 0.5
    flow = ((rs.rand(2, 24, 32, 2) - 0.5) * 8).astype(np.float32)
    before = (cw.quality_launches.count, cw.fwd_launches.count)
    score = make_score_fn(cuda)
    for i in range(2):
        got = score(x[i:i + 1], flow[i:i + 1])
        np.testing.assert_allclose(got, score_pair_np(x[i], flow[i]),
                                   rtol=1e-4)
    assert (cw.quality_launches.count - before[0],
            cw.fwd_launches.count - before[1]) == (2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,crop", [(4, 10, (224, 480)), (2, 3, (56, 120)),
                                      (1, 2, (44, 70))])
def test_volume_loss_launches_each_warp_kernel_once(cuda, b, t, crop):
    """`pyramid_loss_multi` on a T-frame volume (the sintel preset's
    batch 4, T = 10 and crop 224x480, and small ones): one launch of
    each warp kernel for all six levels and B(T-1) folded pairs; each
    level's warped pairs and flow gradients bitwise equal to the plain
    versions on the same folded tensors."""
    from deepof_tpu_torch.core.config import LossConfig
    from deepof_tpu_torch.losses import pyramid
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (backward_warp_reference,
                                           warp_flow_grad_reference)

    rs = np.random.RandomState(t)
    h, w = crop
    flows, scales = [], []
    for k in range(6):
        h, w = -(-h // 2), -(-w // 2)
        flows.append(torch.from_numpy((rs.randn(b, h, w, 2 * (t - 1))
                                       * 0.5).astype(np.float32)).to(cuda)
                     .requires_grad_(True))
        scales.append(10.0 / 2 ** k)
    vol = torch.from_numpy(rs.rand(b, *crop, 3 * t).astype(np.float32)).to(
        cuda)
    seen = []  # per level: [image, flow, output, cotangent, flow grad]
    inner = pyramid.backward_warp_levels

    def recorded(images, fl, impl="auto"):
        outs = inner(images, fl, impl)
        for k, (i, f, o) in enumerate(zip(images, fl, outs)):
            seen.append([i, f.detach(), o.detach()])
            o.register_hook(lambda g, k=k: seen[k].append(g))
            f.register_hook(lambda g, k=k: seen[k].append(g))
        return outs

    pyramid.backward_warp_levels = recorded
    try:
        before = (cw.fwd_launches.count, cw.grad_launches.count)
        total, _, _ = pyramid.pyramid_loss_multi(
            list(zip(flows, scales)), pyramid.lrn_normalize(vol),
            LossConfig())
        total.backward()
        assert (cw.fwd_launches.count, cw.grad_launches.count) == (
            before[0] + 1, before[1] + 1)
    finally:
        pyramid.backward_warp_levels = inner
    assert len(seen) == 6
    for img, fl, out, ct, dflow in seen:
        assert img.shape[0] == fl.shape[0] == b * (t - 1)
        i, f = img.permute(0, 3, 1, 2), fl.permute(0, 3, 1, 2)
        assert torch.equal(out.permute(0, 3, 1, 2),
                           backward_warp_reference(i, f))
        assert torch.equal(dflow.permute(0, 3, 1, 2),
                           warp_flow_grad_reference(
                               i, f, ct.permute(0, 3, 1, 2)))


@pytest.mark.cuda
def test_warp_levels_survive_nonfinite_flows(cuda):
    """NaN, inf and huge flows in one level of a fused launch: the plain
    version's values at every level, NaN where it gives NaN."""
    from deepof_tpu_torch.ops.cuda.warp import (warp_flow_grad_levels_cuda,
                                                warp_fwd_levels_cuda)
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    images, flows, cts = _levels(cuda, [(2, 16, 20), (2, 8, 10)], 3, "nhwc",
                                 3.0, seed=1)
    nan, inf = float("nan"), float("inf")
    flow = flows[0]
    flow[0, 0, 2, 3], flow[0, 1, 4, 5], flow[1, 0, 6, 7] = nan, inf, -inf
    flow[1, 1, 8, 9], flow[1, 0, 12, 13] = 3e38, -3e38
    flow[0, 0, 5, 6], flow[0, 1, 5, 6] = nan, -50.0
    flow[1, 0, 9, 10], flow[1, 1, 9, 10] = -50.0, nan
    outs = warp_fwd_levels_cuda(images, flows)
    grads = warp_flow_grad_levels_cuda(images, flows, cts)
    torch.cuda.synchronize()
    assert outs[0].isnan().any()
    for img, fl, ct, out, grad in zip(images, flows, cts, outs, grads):
        f = fl.clone().requires_grad_(True)
        want = backward_warp_reference(img, f)
        want.backward(ct)
        torch.testing.assert_close(out, want.detach(), atol=0, rtol=0,
                                   equal_nan=True)
        torch.testing.assert_close(grad, f.grad, atol=1e-4, rtol=0,
                                   equal_nan=True)


def _numbered_batches(shape=(2, 48, 80, 3)):
    """next_batch for a Prefetcher: batch i holds i in every entry of its
    images, and the host arrays handed out are kept for comparison."""
    handed = []

    def next_batch():
        i = len(handed)
        b = {"source": np.full(shape, i, np.float32),
             "target": np.full(shape, -i, np.float32),
             "flow": np.full((*shape[:3], 2), i, np.float32)}
        handed.append(b)
        return b

    return next_batch, handed


@pytest.mark.cuda
def test_prefetcher_stages_batches_on_the_card(cuda, monkeypatch):
    from deepof_tpu_torch.data.prefetch import Prefetcher
    from deepof_tpu_torch.train.step import batch_to_device

    recorded = []
    record = torch.Tensor.record_stream

    def recording(t, stream):
        recorded.append((t.data_ptr(), stream))
        return record(t, stream)

    monkeypatch.setattr(torch.Tensor, "record_stream", recording)
    next_batch, handed = _numbered_batches()
    puts = []
    pre = Prefetcher(next_batch, depth=2, device=cuda,
                     phase_cb=lambda name, s: puts.append(name))
    side = torch.cuda.Stream()
    held = []
    try:
        for i in range(12):  # many more batches than pinned slots
            with torch.cuda.stream(side):
                b = pre.get()
                # read at once on the stream that waited on the copy
                assert torch.equal(b["source"], torch.full_like(
                    b["source"], i))
            held.append(b)
            assert b["source"].is_cuda and b["target"].is_cuda
            assert isinstance(b["flow"], np.ndarray)  # not a step input
            assert (b["source"].data_ptr(), side) in recorded
            assert (b["target"].data_ptr(), side) in recorded
            dev = batch_to_device(b, cuda)
            assert dev["source"] is b["source"]  # no second copy
    finally:
        pre.close()
    torch.cuda.synchronize()
    # no pinned slot was overwritten while its copy was in flight: every
    # batch held on the card is the host batch it was staged from
    for b, h in zip(held, handed):
        for k in ("source", "target"):
            np.testing.assert_array_equal(b[k].cpu().numpy(), h[k])
    assert puts and set(puts) == {"put"}
    assert 1 <= pre.stats()["max_staged_depth"] <= 2


def _serving_cfg(**serve_kw):
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              ServeConfig)

    return ExperimentConfig(
        model="flownet_c", width_mult=0.25, corr_max_disp=4, corr_stride=1,
        data=DataConfig(image_size=(64, 128)),
        serve=ServeConfig(max_batch=4, **serve_kw))


@pytest.mark.cuda
def test_warm_dispatch_launches_the_warp_once_and_no_corr(cuda, monkeypatch):
    """A warm dispatch: one warp launch at input resolution, no
    correlation; its output equals the same dispatch with the plain warp
    swapped in, bit for bit (the gate set to 1, so the stage's own output,
    which reads the warped frame, counts; cuDNN deterministic)."""
    from deepof_tpu_torch.core.config import SessionConfig
    from deepof_tpu_torch.models import flownet2
    from deepof_tpu_torch.ops.cuda import corr as cc
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import backward_warp_reference
    from deepof_tpu_torch.serve.engine import InferenceEngine

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    rs = np.random.RandomState(0)
    x = rs.rand(4, 64, 128, 6).astype(np.float32) - 0.5
    prior = (rs.randn(4, 32, 64, 2) * 3).astype(np.float32)
    key = ((64, 128), "f32", "warm")
    cfg = _serving_cfg(session=SessionConfig(warm_start=True))
    with InferenceEngine(cfg, device=cuda) as eng:
        eng.refine_models["f32"].gate.data.fill_(1.0)
        eng.warm()
        warps, corrs = cw.fwd_launches.count, cc.launches.count
        got = eng._forward(key, x, prior)
        assert cw.fwd_launches.count == warps + 1
        assert cc.launches.count == corrs
        monkeypatch.setattr(flownet2, "backward_warp_nchw",
                            backward_warp_reference)
        want = eng._forward(key, x, prior)
        assert cw.fwd_launches.count == warps + 1
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_int8_tier_holds_int8_weights_on_the_card(cuda):
    from deepof_tpu_torch.serve.engine import InferenceEngine
    from deepof_tpu_torch.serve.quant import Int8Layer

    with InferenceEngine(_serving_cfg(precisions=("int8", "bf16")),
                         device=cuda) as eng:
        int8 = eng.tier_models["int8"]
        layers = [m for m in int8.modules() if isinstance(m, Int8Layer)]
        assert layers
        for m in layers:
            assert m.q.dtype == torch.int8 and m.q.is_cuda
            assert m.scale.dtype == torch.float32 and m.scale.is_cuda
        assert not [n for n, t in (*int8.named_parameters(),
                                   *int8.named_buffers())
                    if t.is_floating_point() and t.dim() > 1]
        assert all(p.dtype == torch.bfloat16 and p.is_cuda
                   for p in eng.tier_models["bf16"].parameters())
        rs = np.random.RandomState(1)
        row = rs.rand(64, 128, 6).astype(np.float32) - 0.5
        flows = {t: eng.submit_prepared(row, (64, 128), (64, 128),
                                        precision=t).result(120)["flow"]
                 for t in ("int8", "bf16")}
    assert all(np.isfinite(f).all() for f in flows.values())
    assert not np.array_equal(flows["int8"], flows["bf16"])


def _flownet_c_steps(cuda, k, remat=False, grad_accum=2):
    """A FlowNet-C (width 0.5, 20 / 2) train step on the card at
    steps_per_call k, with its state, from fixed weights."""
    from deepof_tpu_torch.core.config import (ExperimentConfig, OptimConfig,
                                              TrainConfig)
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.schedule import step_decay_schedule
    from deepof_tpu_torch.train.state import create_train_state
    from deepof_tpu_torch.train.step import make_train_step

    cfg = ExperimentConfig(
        model="flownet_c", width_mult=0.5,
        optim=OptimConfig(learning_rate=1e-4, grad_accum=grad_accum),
        train=TrainConfig(steps_per_call=k, remat=remat))
    model = build_model("flownet_c", width_mult=0.5, seed=3, device=cuda)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    return state, make_train_step(model, cfg, (0.0, 0.0, 0.0))


def _host(metrics: dict) -> dict:
    """A step's metrics (tensors on the card) as floats and lists."""
    return {k: v.tolist() for k, v in metrics.items()}


def _train_pairs(n, hw=(128, 192)):
    rs = np.random.RandomState(7)
    return [{k: rs.rand(2, *hw, 3).astype(np.float32) * 255
             for k in ("source", "target")} for _ in range(n)]


@pytest.fixture
def deterministic():
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cudnn.deterministic,
     torch.backends.cudnn.allow_tf32) = before


@pytest.mark.cuda
def test_k_step_call_equals_single_calls_on_the_card(cuda, deterministic):
    """steps_per_call = 2 over stacked batches against two single calls,
    FlowNet-C through the correlation and warp kernels, gradient
    accumulation 2: the same metrics and weights, bit for bit."""
    from deepof_tpu_torch.ops.cuda import corr as cc

    pairs = _train_pairs(4)
    one, one_step = _flownet_c_steps(cuda, 1)
    before = cc.launches.count
    want = [_host(one_step(one, b)) for b in pairs]
    assert cc.launches.count == before + 4
    two, two_step = _flownet_c_steps(cuda, 2)
    got = [_host(two_step(two, {key: np.stack([a[key], b[key]])
                                for key in a}))
           for a, b in (pairs[0:2], pairs[2:4])]
    for key in want[0]:
        assert [v for call in got for v in call[key]] == \
            [w[key] for w in want], key
    assert (two.step, two.updates) == (one.step, one.updates) == (4, 2)
    for name, t in two.model.state_dict().items():
        assert torch.equal(t, one.model.state_dict()[name]), name


@pytest.mark.cuda
def test_remat_runs_the_corr_kernel_twice_with_the_same_bits(cuda,
                                                             deterministic):
    from deepof_tpu_torch.ops.cuda import corr as cc

    pair = _train_pairs(1)[0]
    runs = []
    for remat in (False, True):
        state, step = _flownet_c_steps(cuda, 1, remat=remat, grad_accum=1)
        counts = [c.count for c in (cc.launches, cc.bwd_f1_launches,
                                    cc.bwd_f2_launches)]
        metrics = _host(step(state, pair))
        runs.append((metrics, [c.count - n for c, n in zip(
            (cc.launches, cc.bwd_f1_launches, cc.bwd_f2_launches), counts)],
            [p.grad.clone() for p in state.model.parameters()]))
    (m0, n0, g0), (m1, n1, g1) = runs
    assert n0 == [1, 1, 1] and n1 == [2, 1, 1]
    assert m0 == m1
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_device_memory_summary_reads_the_card(cuda):
    from deepof_tpu_torch.obs.telemetry import device_memory_summary

    x = torch.empty(1 << 20, device=cuda)
    got = device_memory_summary(cuda)
    assert got["dev_mem_bytes_in_use"] >= x.numel() * 4
    assert got["dev_mem_peak_bytes"] >= got["dev_mem_bytes_in_use"]


@pytest.mark.cuda
def test_the_pinned_ring_fetch_waits_for_its_own_step_only(cuda):
    """`HostStager`: step i's values, staged behind step i, read while
    step i + 1 (a long sleep of the stream, then a write of the same
    tensor) is still queued: the read returns step i's values and does
    not wait for step i + 1."""
    from deepof_tpu_torch.train.metrics_log import AsyncFetcher, HostStager

    stager = HostStager(slots=3)
    x = torch.zeros(6, device=cuda)
    torch.cuda.synchronize()
    x.fill_(1.0)
    staged = stager.stage({"total": x[0], "scale_total": x})
    torch.cuda._sleep(int(2e9))  # ~1 s of the stream: step i + 1
    x.fill_(2.0)
    t0 = time.perf_counter()
    host = stager.read(staged)
    waited = time.perf_counter() - t0
    assert float(host["total"]) == 1.0
    assert host["scale_total"].tolist() == [1.0] * 6
    assert waited < 0.5, waited
    torch.cuda.synchronize()
    # the fetcher's consumer thread reads through the same ring
    got = []
    f = AsyncFetcher(depth=2)
    for i in range(5):
        x.fill_(float(i))
        f.submit(i, {"total": x[0]}, lambda tag, m: got.append(
            (tag, float(m["total"]))))
    assert f.drain(timeout=60)
    f.close()
    assert got == [(i, float(i)) for i in range(5)]


@pytest.mark.cuda
def test_the_device_side_skip_leaves_the_state_as_it_was(cuda):
    """A NaN batch on the card under grad_accum 2: after one finite
    micro-step, the poisoned one changes no tensor of the state (the
    parameters, the accumulator, Adam's moments, the counters), bit for
    bit, and reads nothing back."""
    state, step = _flownet_c_steps(cuda, 1)
    pairs = _train_pairs(2)
    step(state, pairs[0])

    def snapshot():
        return ([p.detach().clone() for p in state.model.parameters()]
                + [a.clone() for a in state.acc]
                + [t.clone() for s in state.optimizer.state.values()
                   for t in s.values()] + [state.counts.clone()])

    before = snapshot()
    bad = {k: v.copy() for k, v in pairs[1].items()}
    bad["source"][0, 0, 0, 0] = np.nan
    metrics = step(state, bad)
    assert metrics["update_skipped"].is_cuda
    assert float(metrics["update_skipped"]) == 1.0
    after = snapshot()
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert (state.step, state.updates, state.mini_step) == (1, 0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_inception_step_launches_each_warp_kernel_once(cuda, deterministic,
                                                      dtype, monkeypatch):
    """A thin Inception-v3 (width 0.25) forward and backward on the card
    with the flyingchairs preset's loss: each warp kernel once for its six
    levels, and the loss and gradients equal to the same step with the
    kernels' plain versions swapped in (the forward
    `backward_warp_reference`, the flow gradient
    `warp_flow_grad_reference`)."""
    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.data.datasets import DATASET_MEANS
    from deepof_tpu_torch.losses import pyramid
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (backward_warp_reference,
                                           warp_flow_grad_reference)
    from deepof_tpu_torch.train.step import batch_to_device, model_losses

    model = build_model("inception_v3", width_mult=0.25, seed=5,
                        device=cuda, dtype=getattr(torch, dtype))
    batch = batch_to_device(_train_pairs(1, (128, 160))[0], cuda)
    loss_cfg = get_config("flyingchairs").loss

    def run():
        model.zero_grad(set_to_none=True)
        total, aux = model_losses(model, batch,
                                  DATASET_MEANS["flyingchairs"], loss_cfg,
                                  compute_dtype=getattr(torch, dtype))
        total.backward()
        return total.item(), [p.grad.clone() for p in model.parameters()], aux

    before = (cw.fwd_launches.count, cw.grad_launches.count)
    loss, grads, aux = run()
    assert (cw.fwd_launches.count, cw.grad_launches.count) == (
        before[0] + 1, before[1] + 1)
    assert [tuple(d["total"].shape) for d in aux["losses"]] == [()] * 6

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, image, flow):
            ctx.save_for_backward(image, flow)
            return backward_warp_reference(image, flow)

        @staticmethod
        def backward(ctx, g):
            image, flow = ctx.saved_tensors
            return None, warp_flow_grad_reference(image, flow, g)

    # NHWC memory, as the kernel writes its output in its input's layout:
    # the loss's reductions then sum in the same order
    monkeypatch.setattr(pyramid, "backward_warp_levels", lambda im, fl, impl:
                        [Plain.apply(i.permute(0, 3, 1, 2),
                                     f.permute(0, 3, 1, 2))
                         .permute(0, 2, 3, 1).contiguous()
                         for i, f in zip(im, fl)])
    plain_loss, plain_grads, _ = run()
    assert (cw.fwd_launches.count, cw.grad_launches.count) == (
        before[0] + 1, before[1] + 1)
    assert loss == plain_loss
    for g, w in zip(grads, plain_grads):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_an_engine_computes_float32_whatever_the_tf32_switches(cuda):
    """F17: an InferenceEngine built with both TF32 switches on turns them
    off, and its flow is the same model's forward computed in float32:
    within 1e-5 of its largest entry (cuDNN may choose another float32
    algorithm: 4.6e-5 relative, 1.4e-6 absolute measured on the H100),
    and at least 10x closer than the forward with cuDNN's TF32 on."""
    from deepof_tpu_torch.core.config import DataConfig, ExperimentConfig
    from deepof_tpu_torch.serve.engine import (InferenceEngine,
                                               build_serve_model,
                                               make_raw_forward)

    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    cfg = ExperimentConfig(model="inception_v3", width_mult=0.25,
                           data=DataConfig(image_size=(128, 160)))
    x = np.random.RandomState(3).rand(1, 128, 160, 6).astype(np.float32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with InferenceEngine(cfg, device=cuda) as eng:
            assert (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32) == (False, False)
            got = eng._forward(((128, 160), "f32", "cold"),
                               np.repeat(x, eng.max_batch, 0))[:1]
        fwd = make_raw_forward(build_serve_model(cfg, cuda).eval())
        want = fwd(np.repeat(x, eng.max_batch, 0))[:1]
        torch.backends.cudnn.allow_tf32 = True
        tf32 = fwd(np.repeat(x, eng.max_batch, 0))[:1]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before
    assert np.isfinite(got).all()
    gap = np.abs(got - want).max()
    assert gap <= 1e-5 * np.abs(want).max()
    assert np.abs(tf32 - want).max() > 10 * gap


@pytest.mark.cuda
def test_augmentation_warp_is_one_launch_and_bitwise(cuda):
    """The augmentation's resample on the card: source and target in one
    launch of the forward kernel, counted on the augmentation's counter,
    each bit for bit the plain version under the flow of sampled
    parameters (scale 2.0, a flip and the full 17 degrees among them);
    and `augment_batch` a pure function of its seed on the card, one
    augmentation launch for two stacked micro-batches."""
    import math

    from deepof_tpu_torch.data import augmentation as aug
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import backward_warp_reference

    rs = np.random.RandomState(11)
    frames = [torch.from_numpy(rs.rand(4, 40, 56, 3).astype(np.float32)
                               * 255).to(cuda) for _ in range(2)]
    params = aug.sample_geo_params(aug.generator(3, 0, cuda), 4)
    params["scale"][0] = aug.SCALE_RANGE[1]
    params["flip"][1] = True
    params["angle"][2] = math.radians(aug.ROTATION_DEG)
    before = (cw.fwd_launches.count, cw.augment_launches.count)
    got = aug.apply_geo(frames, params)
    assert (cw.fwd_launches.count, cw.augment_launches.count) == (
        before[0], before[1] + 1)
    flow = aug.geo_flow(params, 40, 56).permute(0, 3, 1, 2)
    for o, f in zip(got, frames):
        assert torch.equal(o.permute(0, 3, 1, 2), backward_warp_reference(
            f.permute(0, 3, 1, 2), flow))
    batch = {"source": torch.stack(frames), "target": torch.stack(frames[::-1])}
    a = aug.augment_batch(batch, [5, 9])
    b = aug.augment_batch(batch, [5, 9])
    assert cw.augment_launches.count == before[1] + 3
    for k in ("source", "target", "net_source", "net_target"):
        assert a[k].shape == (2, 4, 40, 56, 3)
        assert torch.equal(a[k], b[k])
    one = aug.augment_batch({k: v[1] for k, v in batch.items()}, 9)
    assert torch.equal(one["net_source"], a["net_source"][1])


@pytest.mark.cuda
def test_occlusion_warp_of_two_channels_is_one_launch_and_bitwise(cuda):
    """The occlusion mask's warp at VGG's five levels: backward flows
    (C = 2, the kernel's generic instance) warped by the forward flows,
    both NHWC memory, in one launch on the occlusion counter; each level
    bit for bit the plain version."""
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (backward_warp_reference,
                                           warp_levels_forward)

    rs = np.random.RandomState(12)
    levels = [(2, 32 >> k, 48 >> k) for k in range(5)]
    bw = [torch.from_numpy((rs.randn(b, h, w, 2) * 4).astype(np.float32))
          .to(cuda) for b, h, w in levels]
    fw = [torch.from_numpy((rs.randn(b, h, w, 2) * 4).astype(np.float32))
          .to(cuda) for b, h, w in levels]
    before = (cw.fwd_launches.count, cw.occlusion_launches.count)
    outs = warp_levels_forward(bw, fw, site="occlusion")
    assert (cw.fwd_launches.count, cw.occlusion_launches.count) == (
        before[0], before[1] + 1)
    for o, i, f in zip(outs, bw, fw):
        want = backward_warp_reference(i.permute(0, 3, 1, 2),
                                       f.permute(0, 3, 1, 2))
        assert torch.equal(o.permute(0, 3, 1, 2), want)


@pytest.mark.cuda
@pytest.mark.parametrize("occlusion", [False, True])
def test_vgg_step_launches_each_warp_kernel_once(cuda, deterministic,
                                                 occlusion, monkeypatch):
    """VGG16Flow (full width, 64x96) forward and backward on the card
    with the flyingchairs_vgg preset's loss (depthwise smoothness) on an
    augmented batch: each warp kernel once for the five levels (and the
    occlusion warp once under loss.occlusion), and the loss and
    gradients equal to the same step with the kernels' plain versions
    swapped in."""
    import dataclasses

    from deepof_tpu_torch.core.config import get_config
    from deepof_tpu_torch.data.augmentation import augment_batch
    from deepof_tpu_torch.data.datasets import DATASET_MEANS
    from deepof_tpu_torch.losses import pyramid
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.ops.cuda import warp as cw
    from deepof_tpu_torch.ops.warp import (backward_warp_reference,
                                           warp_flow_grad_reference)
    from deepof_tpu_torch.train.step import batch_to_device, model_losses

    model = build_model("vgg16", seed=5, device=cuda)
    batch = augment_batch(batch_to_device(_train_pairs(1, (64, 96))[0], cuda),
                          17)
    loss_cfg = dataclasses.replace(get_config("flyingchairs_vgg").loss,
                                   occlusion=occlusion)

    def counts():
        return (cw.fwd_launches.count, cw.grad_launches.count,
                cw.occlusion_launches.count)

    def run():
        model.zero_grad(set_to_none=True)
        total, aux = model_losses(model, batch,
                                  DATASET_MEANS["flyingchairs"], loss_cfg)
        total.backward()
        return total.item(), [p.grad.clone() for p in model.parameters()], aux

    before = counts()
    loss, grads, aux = run()
    assert counts() == (before[0] + 1, before[1] + 1,
                        before[2] + int(occlusion))
    assert [tuple(d["total"].shape) for d in aux["losses"]] == [()] * 5

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, image, flow):
            ctx.save_for_backward(image, flow)
            return backward_warp_reference(image, flow)

        @staticmethod
        def backward(ctx, g):
            image, flow = ctx.saved_tensors
            return None, warp_flow_grad_reference(image, flow, g)

    monkeypatch.setattr(pyramid, "backward_warp_levels", lambda im, fl, impl:
                        [Plain.apply(i.permute(0, 3, 1, 2),
                                     f.permute(0, 3, 1, 2))
                         .permute(0, 2, 3, 1).contiguous()
                         for i, f in zip(im, fl)])
    plain_loss, plain_grads, _ = run()
    assert loss == plain_loss
    for g, w in zip(grads, plain_grads):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))


def _action_steps(cuda, name, hw, **train):
    """An action model's train step on the card (the ucf101 preset's
    loss, batch 2), with its state, from fixed weights."""
    from deepof_tpu_torch.core.config import (DataConfig, ExperimentConfig,
                                              TrainConfig, get_config)
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.train.schedule import step_decay_schedule
    from deepof_tpu_torch.train.state import create_train_state
    from deepof_tpu_torch.train.step import make_train_step

    cfg = ExperimentConfig(model=name, loss=get_config("ucf101").loss,
                           data=DataConfig(image_size=hw, batch_size=2),
                           train=TrainConfig(seed=3, **train))
    model = build_model(name, device=cuda, image_size=hw, seed=0)
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    return state, make_train_step(model, cfg, (104.0, 117.0, 123.0),
                                  smooth_border_mask=name != "ucf101_spatial")


def _action_batches(n, hw):
    rs = np.random.RandomState(11)
    return [{"source": rs.rand(2, *hw, 3).astype(np.float32) * 255,
             "target": rs.rand(2, *hw, 3).astype(np.float32) * 255,
             "label": rs.randint(0, 101, 2).astype(np.int32)}
            for _ in range(n)]


@pytest.mark.cuda
def test_dropout_masks_are_a_function_of_seed_and_step_on_the_card(
        cuda, deterministic):
    """The masks drawn on the card by torch's CUDA generator (F19: not
    threefry's, nor the CPU generator's): the same (seed, step) gives the
    same bits, another step others, keep 0.9; two steps a call give the
    bits of two single calls, and st_single under remat those without."""
    from deepof_tpu_torch.models.two_stream import KEEP_PROB, dropout_masks
    from deepof_tpu_torch.train.step import STEP_KEY

    a = dropout_masks(8, 0, 5, cuda)
    b = dropout_masks(8, 0, 5, cuda, torch.Generator(cuda))
    c = dropout_masks(8, 0, 6, cuda)
    assert all(x.is_cuda and torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert abs(torch.stack([*a, *c]).float().mean().item() - KEEP_PROB) \
        < 0.01
    hw = (32, 32)
    batches = _action_batches(2, hw)
    one, one_step = _action_steps(cuda, "ucf101_spatial", hw)
    want = [_host(one_step(one, {**p, STEP_KEY: 7 + i}))
            for i, p in enumerate(batches)]
    two, two_step = _action_steps(cuda, "ucf101_spatial", hw,
                                  steps_per_call=2)
    got = _host(two_step(two, {**{k: np.stack([p[k] for p in batches])
                                  for k in batches[0]}, STEP_KEY: 7}))
    for key in want[0]:
        assert got[key] == [w[key] for w in want], key
    for name, t in two.model.state_dict().items():
        assert torch.equal(t, one.model.state_dict()[name]), name
    runs = []
    for remat in (False, True):
        state, step = _action_steps(cuda, "st_single", hw, remat=remat)
        runs.append((_host(step(state, {**batches[0], STEP_KEY: 3})),
                     state.model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for name, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][name]), name



@pytest.fixture
def corr_store(cuda, tmp_path):
    """An artifact store holding one entry with this checkout's corr
    library (built here first): (store, its fingerprint)."""
    from deepof_tpu_torch.ops.cuda import build
    from deepof_tpu_torch.serve.artifacts import ArtifactStore

    build.build("corr")
    store = ArtifactStore(str(tmp_path / "exec"), "cuda")
    fp = "0123456789abcdef"
    assert store.publish(fp, ["corr"], name="serve:384x512:f32:cold") \
        == "published"
    return store, fp


@pytest.fixture
def cold_build_dir(tmp_path, monkeypatch):
    """An empty BUILD_DIR, no library loaded, and nvcc refused: a library
    that loads came from the store."""
    from deepof_tpu_torch.ops.cuda import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "cold")
    monkeypatch.setattr(build, "_libs", {})

    def no_nvcc():
        raise AssertionError("nvcc ran")

    monkeypatch.setattr(build, "nvcc", no_nvcc)
    return build


@pytest.mark.cuda
def test_a_library_installed_from_the_store_loads_without_nvcc(
        cuda, corr_store, cold_build_dir):
    """The artifact plane's one saving: a library fetched from the store
    (at this checkout's source hash) into an empty build directory loads
    with no nvcc run and is not counted as built; the corr kernel it
    holds gives the plain version's bits at the serving shape."""
    from deepof_tpu_torch.ops.cuda.corr import launches

    build = cold_build_dir
    store, _ = corr_store
    built = build.built_count()
    assert not build.library_path("corr").exists()
    assert store.fetch_libraries(["corr"]) == {"corr": "hit"}
    assert build.library_path("corr").exists()
    assert store.fetch_libraries(["corr"]) == {"corr": "present"}
    build.load("corr")
    assert build.built_count() == built
    rs = np.random.RandomState(3)
    f1, f2 = (torch.from_numpy(rs.randn(8, 256, 48, 64).astype(np.float32))
              .to(cuda) for _ in range(2))
    before = launches.count
    got = correlation_nchw(f1, f2, 20, 2)
    assert launches.count == before + 1
    assert torch.equal(got, correlation_reference(f1, f2, 20, 2))


@pytest.mark.cuda
def test_a_library_of_another_source_hash_is_rejected(
        cuda, corr_store, cold_build_dir, capsys):
    """A store library whose manifest hash is not this checkout's source
    hash never loads: its entry rejects loudly (source_hash_mismatch),
    the library fetch takes nothing (a miss: built from source), and a
    corrupted copy rejects on its crc."""
    import json
    import os

    from deepof_tpu_torch.serve.artifacts import MANIFEST

    store, fp = corr_store
    path = os.path.join(store.root, fp, MANIFEST)
    with open(path) as f:
        man = json.load(f)
    man["libraries"][0]["hash"] = "f" * 16
    with open(path, "w") as f:
        json.dump(man, f)
    assert store.fetch(fp) == (None, "reject:source_hash_mismatch")
    assert "REJECT" in capsys.readouterr().err
    build = cold_build_dir
    assert store.fetch_libraries(["corr"]) == {"corr": "miss"}
    assert not build.library_path("corr").exists()
    man["libraries"][0]["hash"] = build.library_path("corr").stem[-16:]
    with open(path, "w") as f:
        json.dump(man, f)
    lib = os.path.join(store.root, fp, man["libraries"][0]["file"])
    with open(lib, "r+b") as f:
        f.seek(4096)
        byte = f.read(1)
        f.seek(4096)
        f.write(bytes([byte[0] ^ 0xFF]))
    assert store.fetch_libraries(["corr"]) == {"corr": "reject:crc_mismatch"}
    assert not build.library_path("corr").exists()


def _rank_run(tmp_path, world_size: int) -> tuple[list[dict], dict]:
    """`tests/_torch_ddp_worker.py`'s grad phase in `world_size` ranks on
    this card (thin FlowNet-C through the correlation and warp kernels,
    global batch 4), and the same step in this process on the whole
    batch (cuDNN deterministic, TF32 off, as the worker)."""
    import os
    import socket
    import subprocess
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import _torch_ddp_worker as W

    from deepof_tpu_torch.core.config import DataConfig
    from deepof_tpu_torch.data.datasets import SyntheticData
    from deepof_tpu_torch.data.pipeline import derive_batch_rng
    from deepof_tpu_torch.models.registry import build_model
    from deepof_tpu_torch.parallel.mesh import World
    from deepof_tpu_torch.train.schedule import step_decay_schedule
    from deepof_tpu_torch.train.state import create_train_state
    from deepof_tpu_torch.train.step import make_train_step

    work = str(tmp_path)
    model = build_model("flownet_c", width_mult=0.25, device="cuda", seed=4,
                        **W.GEOMETRY)
    torch.save(model.state_dict(), os.path.join(work, "weights.pt"))
    batch = SyntheticData(DataConfig(dataset="synthetic", image_size=W.HW)
                          ).sample_train(W.BATCH, rng=derive_batch_rng(
                              np.array([5, 0], np.uint32), 0))
    np.savez(os.path.join(work, "batch.npz"), **batch)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = str(sock.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(repo, "tests", "_torch_ddp_worker.py"),
         work, port, str(r), str(world_size), "cuda", "grad"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=repo)
        for r in range(world_size)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"))
             for r in range(world_size)]
    cfg = W.config(os.path.join(work, "one"))
    state = create_train_state(model, cfg.optim,
                               step_decay_schedule(cfg.optim, 1))
    m = make_train_step(model, cfg, (0.0, 0.0, 0.0),
                        world=World(np.zeros((1, 1, 1))))(state, batch)
    return ranks, {"metrics": {k: v.cpu() for k, v in m.items()},
                   "grads": {n: p.grad.cpu()
                             for n, p in model.named_parameters()}}


@pytest.mark.cuda
def test_two_ranks_on_one_card_step_as_one_process_over_gloo(
        cuda, deterministic, tmp_path):
    """Two ranks share the one card, so `init_distributed` picks gloo
    (NCCL refuses two ranks on one device); their averaged gradient is
    the one-process gradient of the global batch up to the order of the
    batch sum (1e-5 of each tensor's largest entry, 1e-5 relative on
    the metrics), the same bits on both ranks."""
    ranks, one = _rank_run(tmp_path, 2)
    for r in ranks:
        assert (r["backend"], r["size"], r["device"]) == ("gloo", 2,
                                                          "cuda:0")
    r0, r1 = (r["grad"] for r in ranks)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(r0["metrics"][k].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
    for name, g in one["grads"].items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(r0["grads"][name].numpy(), g.numpy(),
                                   rtol=0, atol=1e-5 * scale, err_msg=name)
        assert torch.equal(r0["grads"][name], r1["grads"][name]), name


@pytest.mark.cuda
def test_init_distributed_over_nccl_at_world_one(cuda, deterministic,
                                                 tmp_path):
    """One rank with a card of its own joins over NCCL, and its step
    (the all_reduce included: an identity at world one) gives the plain
    step's bits."""
    ranks, one = _rank_run(tmp_path, 1)
    assert (ranks[0]["backend"], ranks[0]["size"]) == ("nccl", 1)
    got = ranks[0]["grad"]
    for k, v in one["metrics"].items():
        assert torch.equal(got["metrics"][k], v), k
    for name, g in one["grads"].items():
        assert torch.equal(got["grads"][name], g), name
