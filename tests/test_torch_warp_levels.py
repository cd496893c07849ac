"""The warp over a list of pyramid levels (`BackwardWarpLevels`,
`backward_warp_levels`) and the host side of its one-launch CUDA kernels
(`ops/cuda/warp.py`): the launch plan, the block -> pixel mapping of
`csrc/warp.cu` and the refusals that need no card.

On the CPU every level runs the plain version, so the fused call must
equal one-level calls exactly (tolerance 0: the same arithmetic on the
same inputs). The kernels themselves are held to the plain version on
the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

from deepof_tpu_torch.core.config import LossConfig
from deepof_tpu_torch.losses import photometric, pyramid
from deepof_tpu_torch.ops.cuda import warp as cw
from deepof_tpu_torch.ops.warp import (BackwardWarpLevels,
                                       backward_warp_levels,
                                       backward_warp_nchw,
                                       backward_warp_reference,
                                       warp_flow_grad_reference)

# (B, H, W) level sets, finest first: the training loss at 384x512,
# batch 4; Inception-v3's at 320x448, batch 4 (finest at H/2, two equal
# levels) and on the Sintel preset's volume (36 folded pairs of 224x480
# crops); ragged widths and one-row levels; eight levels, the most one
# launch takes
MAIN_PATH = [(4, 192 >> k, 256 >> k) for k in range(6)]
INCEPTION = [(4, 160 >> k, 224 >> k) for k in (0, 1, 2, 2, 3, 4)]
INCEPTION_VOLUME = [(36, 112, 240), (36, 56, 120), (36, 28, 60),
                    (36, 28, 60), (36, 14, 30), (36, 7, 15)]
PLAN_CASES = [
    MAIN_PATH, INCEPTION, INCEPTION_VOLUME,
    [(2, 1, 1), (2, 1, 3), (2, 5, 70), (2, 1, 129)],
    [(3, 13, 70), (3, 7, 35), (3, 4, 17), (3, 2, 9), (3, 1, 4)],
    [(1, 9, 300 - 37 * k) for k in range(8)],
    [(5, 1, 256)],
]


def _emulate_kernel_writes(shapes):
    """Pixels written by each level, counted by emulating the kernel's
    block and thread -> (level, b, y, x, x + 32, ...) mapping (`locate`
    in csrc/warp.cu) over every thread of the plan's grid."""
    tiles, blocks = cw.plan(shapes)
    first = np.array([f for _, _, f in tiles])
    tiles_x = np.array([t for t, _, _ in tiles])
    tiles_y = np.array([t for _, t, _ in tiles])
    hs = np.array([h for _, h, _ in shapes])
    ws = np.array([w for _, _, w in shapes])
    bid = np.arange(blocks)[:, None, None]
    level = np.zeros_like(bid)
    for k in range(1, cw.MAX_LEVELS):
        if k < len(shapes):
            level = np.where(bid >= first[k], k, level)
    r = bid - first[level]
    tx = r % tiles_x[level]
    r = r // tiles_x[level]
    ty_thread = np.arange(cw.ROWS)[None, :, None]
    tx_thread = np.arange(cw.THREADS_X)[None, None, :]
    y = (r % tiles_y[level]) * cw.ROWS + ty_thread
    b = r // tiles_y[level] + 0 * y
    x = tx * cw.TILE_W + tx_thread
    n = np.minimum(cw.PIX, (ws[level] - x + cw.THREADS_X - 1)
                   // cw.THREADS_X)
    live = (y < hs[level]) & (x < ws[level])
    counts = [np.zeros(s, np.int64) for s in shapes]
    lv, bb, yy, xx, nn = (np.broadcast_to(a, live.shape)[live]
                          for a in (level, b, y, x, n))
    for k, (bk, _, _) in enumerate(shapes):
        assert (bb[lv == k] < bk).all(), "a block maps past the batch"
    for i in range(cw.PIX):
        sel = nn > i
        for k in range(len(shapes)):
            m = sel & (lv == k)
            np.add.at(counts[k], (bb[m], yy[m], xx[m] + i * cw.THREADS_X), 1)
    return counts, blocks


@pytest.mark.parametrize("shapes", PLAN_CASES)
def test_launch_plan_writes_every_pixel_once(shapes):
    counts, blocks = _emulate_kernel_writes(shapes)
    for k, c in enumerate(counts):
        assert (c == 1).all(), f"level {k} {shapes[k]}"
    # finest level first, then each level's blocks in turn
    tiles, _ = cw.plan(shapes)
    assert tiles[0][2] == 0 and blocks == sum(
        b * ty * tx for (b, _, _), (tx, ty, _) in zip(shapes, tiles))


def test_main_path_plan_is_one_wave_of_small_blocks():
    tiles, blocks = cw.plan(MAIN_PATH)
    assert tiles == [(4, 24, 0), (2, 12, 384), (1, 6, 480), (1, 3, 504),
                     (1, 2, 516), (1, 1, 524)]
    assert blocks == 528


def _nhwc(t):
    """(B, H, W, C) memory seen as a (B, C, H, W) view."""
    return t.permute(0, 3, 1, 2)


def _levels(c, layout, seed=0, b=2):
    """Six levels, 32x32 down to 1x1 (the main path's pyramid scaled
    down), images and cotangents in `layout`, planar flows."""
    rs = np.random.RandomState(seed)
    images, flows, cts = [], [], []
    for k in range(6):
        h = w = 32 >> k
        img = rs.rand(b, h, w, c).astype(np.float32)
        ct = rs.randn(b, h, w, c).astype(np.float32)
        flow = (rs.randn(b, 2, h, w) * 3).astype(np.float32)
        if layout == "nhwc":
            images.append(_nhwc(torch.from_numpy(img)))
            cts.append(_nhwc(torch.from_numpy(ct)))
        else:
            images.append(torch.from_numpy(img).permute(0, 3, 1, 2)
                          .contiguous())
            cts.append(torch.from_numpy(ct).permute(0, 3, 1, 2).contiguous())
        flows.append(torch.from_numpy(flow))
    return images, flows, cts


@pytest.mark.parametrize("c,layout", [(3, "nhwc"), (3, "nchw"), (1, "nhwc"),
                                      (5, "nhwc")])
def test_levels_equal_one_level_calls(c, layout):
    """Values and flow gradients of the fused call against one call per
    level and against the plain versions, with level 2's
    output left out of the loss (its cotangent is None, its flow
    gradient zero)."""
    images, flows, cts = _levels(c, layout, seed=c)
    skip = 2
    fused = [f.clone().requires_grad_(True) for f in flows]
    outs = BackwardWarpLevels.apply(len(images), *images, *fused)
    sum((o * g).sum() for k, (o, g) in enumerate(zip(outs, cts))
        if k != skip).backward()
    for k, (img, flow, ct) in enumerate(zip(images, flows, cts)):
        single = flow.clone().requires_grad_(True)
        out = backward_warp_nchw(img, single)
        plain = flow.clone().requires_grad_(True)
        want = backward_warp_reference(img, plain)
        assert torch.equal(outs[k], out) and torch.equal(outs[k], want)
        if k == skip:
            assert torch.equal(fused[k].grad, torch.zeros_like(flow))
            continue
        (out * ct).sum().backward()
        (want * ct).sum().backward()
        assert torch.equal(fused[k].grad, single.grad)
        # the plain flow-gradient version bit for bit, and autograd of
        # the plain forward up to rounding
        assert torch.equal(fused[k].grad,
                           warp_flow_grad_reference(img, flow, ct))
        torch.testing.assert_close(fused[k].grad, plain.grad, rtol=1e-6,
                                   atol=1e-6)


def test_levels_hand_the_views_over_without_a_copy():
    """The Function saves (and on the card launches on) the NHWC views
    it is given: the same memory, the same strides."""
    images, flows, _ = _levels(3, "nhwc")
    nhwc = [i.permute(0, 2, 3, 1) for i in images]
    fl = [f.permute(0, 2, 3, 1).requires_grad_(True) for f in flows]
    outs = backward_warp_levels(nhwc, fl)
    node = outs[0].grad_fn.next_functions[0][0]
    saved = node.saved_tensors
    assert type(node).__name__ == "BackwardWarpLevelsBackward"
    for got, want in zip(saved, images + flows):
        assert got.data_ptr() == want.data_ptr()
        assert got.stride() == want.stride()
    assert not images[0].is_contiguous()  # the loss's layout, kept


def test_image_cotangent_only_when_asked():
    images, flows, cts = _levels(3, "nchw", b=1)
    ims = [i.clone().requires_grad_(k == 1) for k, i in enumerate(images)]
    outs = BackwardWarpLevels.apply(len(ims), *ims, *flows)
    sum((o * g).sum() for o, g in zip(outs, cts)).backward()
    assert ims[0].grad is None and ims[2].grad is None
    im = images[1].clone().requires_grad_(True)
    (backward_warp_reference(im, flows[1]) * cts[1]).sum().backward()
    assert torch.equal(ims[1].grad, im.grad)


def test_level_lists_are_refused_before_the_card():
    """What the CUDA wrappers refuse without a card: level counts, list
    lengths and CPU tensors (a CUDA tensor they cannot take raises too,
    on the card: tests/test_torch_cuda.py)."""
    img = torch.zeros(1, 3, 4, 4)
    flow = torch.zeros(1, 2, 4, 4)
    with pytest.raises(ValueError, match="1 to 8"):
        cw.warp_fwd_levels_cuda([img] * 9, [flow] * 9)
    with pytest.raises(ValueError, match="1 to 8"):
        cw.warp_fwd_levels_cuda([], [])
    with pytest.raises(ValueError, match="2 flows"):
        cw.warp_fwd_levels_cuda([img] * 3, [flow] * 2)
    with pytest.raises(ValueError, match="is on cpu"):
        cw.warp_flow_grad_levels_cuda([img], [flow], [img])
    with pytest.raises(ValueError, match="is on cpu"):
        cw.warp_fwd_cuda(img, flow)


def test_pyramid_loss_warps_all_levels_in_one_call(monkeypatch):
    calls = []

    def counting(images, flows, impl="auto"):
        calls.append([tuple(i.shape) for i in images])
        return backward_warp_levels(images, flows, impl)

    def never(*args, **kwargs):
        raise AssertionError("loss_interp warped a level on its own")

    monkeypatch.setattr(pyramid, "backward_warp_levels", counting)
    monkeypatch.setattr(photometric, "backward_warp", never)
    rs = np.random.RandomState(7)
    flows = [(torch.from_numpy(rs.randn(2, 16 >> k, 16 >> k, 2)
                               .astype(np.float32)), 10.0 / 2 ** k)
             for k in range(4)]
    src, tgt = (torch.from_numpy(rs.rand(2, 32, 32, 3).astype(np.float32))
                for _ in range(2))
    total, losses, recon = pyramid.pyramid_loss(flows, src, tgt,
                                                LossConfig())
    assert calls == [[(2, 16 >> k, 16 >> k, 3) for k in range(4)]]
    assert len(losses) == 4 and recon.shape == (2, 16, 16, 3)
    assert torch.isfinite(total)
