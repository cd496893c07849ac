"""The tiling of the correlation's backward kernels (`csrc/corr_bwd.cu`),
emulated in numpy on the CPU: which g and feature values each block
stages, which of them each thread reads for each displacement, and which
outputs it writes. The tile constants are read from the source, so the
emulation follows a change of tile; the thread -> (columns, channels)
mapping and the staging offsets are written out here as in the kernel:
change both together.

The emulation sums in float64 in the kernel's order and is held to the
plain backward (`correlation_backward_reference`, float32) within 1e-5
of the largest entry, the kernel's own tolerance on the card
(`tests/test_torch_cuda.py`); every output must be written exactly once.
The kernel itself runs only on the card.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deepof_tpu_torch.ops.corr import correlation_backward_reference

SOURCE = (Path(__file__).resolve().parents[1] / "deepof_tpu_torch" / "csrc"
          / "corr_bwd.cu")


def _tile_constants() -> dict[str, int]:
    """The `constexpr int NAME = expr;` lines of the source, evaluated in
    order (each may use the names before it)."""
    consts: dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);",
                                 SOURCE.read_text(), re.M):
        consts[name] = int(eval(expr, {"__builtins__": {}}, dict(consts)))
    return consts


K = _tile_constants()
TX, RX, CT, NCG, RJ, JB = (K[k] for k in ("TX", "RX", "CT", "NCG", "RJ",
                                          "JB"))
CB, THREADS = K["CB"], K["THREADS"]


def _geometry(n: int, stride: int) -> tuple[int, int]:
    """(jbe, ww) as the launch computes them."""
    jbe = min(-(-n // RJ) * RJ, JB)
    return jbe, TX + (jbe - 1) * stride


def _emulate(feat, g, max_disp, stride, wrt_f1):
    """df1 (wrt_f1, feat = f2) or df2 (feat = f1) as the kernel computes
    it, in float64, and the number of times each output is written."""
    b_n, c_n, h, w = feat.shape
    s = stride
    n = 2 * (max_disp // s) + 1
    pad = (max_disp // s) * s
    jbe, ww = _geometry(n, s)
    tid = np.arange(THREADS)
    lane = tid & 31
    xr = (lane & 3) + 4 * (tid >> 5)
    cg = lane >> 2
    out = np.zeros(feat.shape)
    writes = np.zeros(feat.shape, np.int64)
    cols_r = np.arange(RX)
    for b, y, bx, ct in itertools.product(range(b_n), range(h),
                                          range(-(-w // TX)),
                                          range(-(-c_n // CB))):
        x0, cb0 = bx * TX, ct * CB
        acc = np.zeros((THREADS, CT, RX))
        for i in range(n):
            di = i * s - pad
            yy = y + di if wrt_f1 else y - di
            if not 0 <= yy < h:
                continue
            grow = y if wrt_f1 else yy
            for j0 in range(0, n, jbe):
                nj = min(jbe, n - j0)
                xf0 = (x0 + j0 * s - pad if wrt_f1
                       else x0 - ((j0 + jbe - 1) * s - pad))
                gs = np.zeros((jbe, TX))
                fs = np.zeros((CB, ww))
                for r in range(nj):
                    j = j0 + r
                    xb = x0 if wrt_f1 else x0 - (j * s - pad)
                    cols = xb + np.arange(TX)
                    ok = (cols >= 0) & (cols < w)
                    gs[r, ok] = g[b, i * n + j, grow, cols[ok]]
                for c in range(min(CB, c_n - cb0)):
                    cols = xf0 + np.arange(ww)
                    ok = (cols >= 0) & (cols < w)
                    fs[c, ok] = feat[b, cb0 + c, yy, cols[ok]]
                for jq in range(0, nj, RJ):
                    wofs = (jq if wrt_f1 else jbe - jq - RJ) * s
                    for q in range(RJ):
                        if jq + q >= nj:
                            continue
                        gv = gs[jq + q, xr[:, None] * RX + cols_r]
                        off = q if wrt_f1 else RJ - 1 - q
                        fcols = (xr[:, None] * RX + wofs + off * s + cols_r)
                        assert fcols.min() >= 0 and fcols.max() < ww
                        for k in range(CT):
                            acc[:, k] += gv * fs[(cg + NCG * k)[:, None],
                                                 fcols]
        for k in range(CT):
            c = cb0 + cg + NCG * k
            xs = x0 + xr[:, None] * RX + cols_r
            ok = (c[:, None] < c_n) & (xs < w)
            cc = np.broadcast_to(c[:, None], xs.shape)[ok]
            out[b, cc, y, xs[ok]] = acc[:, k][ok] / c_n
            np.add.at(writes, (b, cc, y, xs[ok]), 1)
    return out, writes


# (B, C, H, W), max_disp, stride: W across two and three tiles and not a
# multiple of TX (65, 130); C across two channel blocks and not a
# multiple of CB or CT (70, 33); H under the pad; n = 41, which takes two
# blocks of staged displacement columns; n not a multiple of RJ (5, 9);
# n = 1; strides 1-6 (5 and 6 take the generic instance)
CASES = [((1, 70, 4, 65), 8, 2), ((2, 33, 6, 130), 4, 1),
         ((1, 9, 5, 20), 20, 1), ((2, 12, 7, 17), 12, 3),
         ((1, 5, 9, 36), 8, 4), ((1, 6, 9, 23), 10, 5),
         ((1, 4, 8, 16), 12, 6), ((2, 3, 5, 9), 0, 1),
         ((1, 8, 5, 70), 20, 2)]


@pytest.mark.parametrize("shape,max_disp,stride", CASES)
def test_corr_bwd_tiling_matches_reference(shape, max_disp, stride):
    rs = np.random.RandomState(7)
    b, _, h, w = shape
    n = 2 * (max_disp // stride) + 1
    f1, f2 = (rs.randn(*shape).astype(np.float32) for _ in range(2))
    g = rs.randn(b, n * n, h, w).astype(np.float32)
    want = correlation_backward_reference(
        torch.from_numpy(f1), torch.from_numpy(f2), torch.from_numpy(g),
        max_disp, stride)
    for wrt_f1, feat, ref in ((True, f2, want[0]), (False, f1, want[1])):
        got, writes = _emulate(feat.astype(np.float64), g.astype(np.float64),
                               max_disp, stride, wrt_f1)
        assert (writes == 1).all(), "an output written other than once"
        ref = ref.numpy().astype(np.float64)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_tile_constants_fit_the_warp_layout():
    """4 column threads x 8 channel groups in a warp, RX columns a thread
    with float4 loads of g, and whole register chunks in a staged block."""
    assert TX // RX == 8 and NCG == 8 and THREADS == 64
    assert RX == 8 and JB % RJ == 0 and CB == NCG * CT
