"""Wrappers of the CUDA warp kernels (`csrc/warp.cu`).

`warp_fwd_levels_cuda` replaces `deepof_tpu/ops/pallas/warp.py::_warp_kernel`
and `warp_flow_grad_levels_cuda` replaces `::_warp_flow_grad_kernel`, each
over up to eight pyramid levels in one launch. The levels share B and C
and each has its own H and W. Every tensor is read and written through
its own strides, so the loss's NHWC views reach the kernels without a
copy, and each output takes the layout of its input (`torch.empty_like`
of the image for the forward, of the flow for the gradient).
`warp_fwd_cuda` and `warp_flow_grad_cuda` are the one-level case of the
same launch.

They take float32 only, as the Pallas kernels do: the JAX wrapper casts
every operand to float32 before the call (`ops/pallas/warp.py:80`), both
kernels write float32 (`:166,195`), and the VJP hands the flow-gradient
kernel a float32 cotangent (`:274`). Under `loss.gather_dtype=
"bfloat16"` a bf16 image reaches only that wrapper's final cast (`:198`)
and XLA's gather, so that setting is a loss option (ROADMAP F11), not a
kernel path; a bf16 CUDA tensor raises here rather than being converted.
Training under `train.compute_dtype="bfloat16"` warps in float32, as the
JAX package does: the flows are cast back to float32 before the loss.

The wrappers never fall back to the plain version: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from .build import LaunchCounter, check, load

# The kernels' tile geometry (csrc/warp.cu; checked against the build at
# load): a block is ROWS rows of one TILE_W-column tile of one (level,
# batch row), and each of its THREADS_X x ROWS threads owns PIX pixels of
# a row, THREADS_X apart.
MAX_LEVELS = 8
THREADS_X, ROWS, PIX = 32, 8, 2
TILE_W = THREADS_X * PIX

fwd_launches = LaunchCounter("warp_fwd")
grad_launches = LaunchCounter("warp_flow_grad")
# the forward kernel's launches on data, by its caller
# (ops/warp.py::warp_levels_forward): the augmentation's resample, and
# the occlusion mask's warp of the backward flows (C = 2)
augment_launches = LaunchCounter("warp_fwd_augment")
occlusion_launches = LaunchCounter("warp_fwd_occlusion")
#: the forward kernel's counter by call site
SITE_COUNTERS = {"loss": fwd_launches, "augment": augment_launches,
                 "occlusion": occlusion_launches}


class _View(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p), ("sb", ctypes.c_int),
                ("sc", ctypes.c_int), ("sy", ctypes.c_int),
                ("sx", ctypes.c_int)]


class _Level(ctypes.Structure):
    _fields_ = [("image", _View), ("flow", _View), ("ct", _View),
                ("out", _View), ("H", ctypes.c_int), ("W", ctypes.c_int),
                ("tiles_x", ctypes.c_int), ("tiles_y", ctypes.c_int),
                ("first_block", ctypes.c_int)]


class _Table(ctypes.Structure):
    _fields_ = [("lv", _Level * MAX_LEVELS), ("n_levels", ctypes.c_int),
                ("C", ctypes.c_int)]


_P, _I = ctypes.c_void_p, ctypes.c_int
_LAUNCHERS = ("deepof_warp_fwd_levels_f32",
              "deepof_warp_flow_grad_levels_f32")


def _lib() -> ctypes.CDLL:
    lib = load("warp")
    if lib.deepof_warp_geometry.argtypes is None:
        for name in _LAUNCHERS:
            fn = getattr(lib, name)
            fn.argtypes = [_P, _I, _P]
            fn.restype = ctypes.c_int
        lib.deepof_warp_geometry.argtypes = [_P]
        lib.deepof_warp_geometry.restype = None
        got = (ctypes.c_int * 5)()
        lib.deepof_warp_geometry(ctypes.addressof(got))
        want = (THREADS_X, ROWS, PIX, MAX_LEVELS, ctypes.sizeof(_Table))
        if tuple(got) != want:
            raise RuntimeError(f"csrc/warp.cu geometry {tuple(got)} does not "
                               f"match the launch plan's {want}")
    return lib


def plan(shapes: Sequence[tuple[int, int, int]]
         ) -> tuple[list[tuple[int, int, int]], int]:
    """The launch plan of one call: shapes [(B, H, W)] of the levels,
    finest first -> ([(tiles_x, tiles_y, first_block)] per level, total
    blocks). Blocks are numbered level by level, and within a level by
    (b, row tile, column tile), column tile fastest."""
    levels, first = [], 0
    for b, h, w in shapes:
        tiles_x, tiles_y = -(-w // TILE_W), -(-h // ROWS)
        levels.append((tiles_x, tiles_y, first))
        first += b * tiles_y * tiles_x
    return levels, first


def _view(t: torch.Tensor) -> _View:
    return _View(t.data_ptr(), *t.stride())


def _overlapping(t: torch.Tensor) -> bool:
    """True unless every element of `t` has its own address (sorted by
    stride, each dimension steps past all that the smaller ones span)."""
    reach = 0
    for s, n in sorted((s, n) for s, n in zip(t.stride(), t.shape) if n > 1):
        if s <= reach:
            return True
        reach += s * (n - 1)
    return False


def _check(what: str, images: Sequence[torch.Tensor],
           flows: Sequence[torch.Tensor],
           cts: Sequence[torch.Tensor] | None = None) -> None:
    """Device, dtype, shape and offset checks of a level list."""
    n = len(images)
    if not 1 <= n <= MAX_LEVELS:
        raise ValueError(f"{what}: {n} levels; one launch takes 1 to "
                         f"{MAX_LEVELS}")
    if len(flows) != n or (cts is not None and len(cts) != n):
        raise ValueError(f"{what}: {n} images, {len(flows)} flows"
                         + ("" if cts is None else f", {len(cts)} cotangents"))
    dev = images[0].device
    for k in range(n):
        named = {"image": images[k], "flow": flows[k]}
        if cts is not None:
            named["ct"] = cts[k]
        for name, t in named.items():
            if t.device.type != "cuda":
                raise ValueError(f"{what}: level {k} {name} is on {t.device}")
            if t.device != dev:
                raise ValueError(f"{what}: level {k} {name} is on "
                                 f"{t.device}, not {dev}")
            if t.dtype != torch.float32:
                raise TypeError(f"{what}: level {k} {name} is {t.dtype}; "
                                "this kernel takes float32 only")
            if t.dim() != 4 or t.numel() == 0:
                raise ValueError(f"{what}: level {k} {name} must be a "
                                 f"non-empty 4-D tensor, got "
                                 f"{tuple(t.shape)}")
            span = sum((d - 1) * s for d, s in zip(t.shape, t.stride()))
            if span >= 2 ** 31:
                raise ValueError(f"{what}: level {k} {name} spans {span + 1} "
                                 "elements; its offsets must fit in 32 bits")
        b, c, h, w = images[k].shape
        if (b, c) != tuple(images[0].shape[:2]):
            raise ValueError(f"{what}: level {k} image {tuple(images[k].shape)}"
                             f" does not share (B, C) = "
                             f"{tuple(images[0].shape[:2])} with level 0")
        if flows[k].shape[1] != 2:
            raise ValueError(f"{what}: level {k} flow must have 2 channels, "
                             f"got {tuple(flows[k].shape)}")
        if flows[k].shape != (b, 2, h, w):
            raise ValueError(f"{what}: level {k} flow "
                             f"{tuple(flows[k].shape)} does not match "
                             f"(B, H, W) = {(b, h, w)}")
        if cts is not None and cts[k].shape != images[k].shape:
            raise ValueError(f"{what}: level {k} cotangent "
                             f"{tuple(cts[k].shape)} vs image "
                             f"{tuple(images[k].shape)}")


def _launch(what: str, fn: str, counter: LaunchCounter,
            images: Sequence[torch.Tensor], flows: Sequence[torch.Tensor],
            cts: Sequence[torch.Tensor] | None,
            outs: list[torch.Tensor]) -> list[torch.Tensor]:
    for k, o in enumerate(outs):
        if _overlapping(o):
            raise ValueError(f"{what}: level {k} output {tuple(o.shape)} with "
                             f"strides {o.stride()} overlaps itself")
    tiles, blocks = plan([(i.shape[0], i.shape[2], i.shape[3])
                          for i in images])
    table = _Table(n_levels=len(images), C=images[0].shape[1])
    for k, (tiles_x, tiles_y, first) in enumerate(tiles):
        table.lv[k] = _Level(
            image=_view(images[k]), flow=_view(flows[k]),
            ct=_view(cts[k]) if cts is not None else _View(),
            out=_view(outs[k]), H=images[k].shape[2], W=images[k].shape[3],
            tiles_x=tiles_x, tiles_y=tiles_y, first_block=first)
    lib = _lib()
    with torch.cuda.device(images[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, fn)(ctypes.addressof(table), blocks, stream)
    check(lib, rc, f"{what} launch")
    counter.add()
    return outs


def warp_fwd_levels_cuda(images: Sequence[torch.Tensor],
                         flows: Sequence[torch.Tensor],
                         site: str = "loss") -> list[torch.Tensor]:
    """images [(B, C, H_k, W_k)], flows [(B, 2, H_k, W_k)], float32 on one
    CUDA device, any strides, 1 to 8 levels -> each image warped backward
    by its flow, in the image's layout. One launch, counted on
    `SITE_COUNTERS[site]`."""
    _check("warp_fwd_levels_cuda", images, flows)
    return _launch("warp forward kernel", "deepof_warp_fwd_levels_f32",
                   SITE_COUNTERS[site], images, flows, None,
                   [torch.empty_like(i) for i in images])


def warp_flow_grad_levels_cuda(images: Sequence[torch.Tensor],
                               flows: Sequence[torch.Tensor],
                               cts: Sequence[torch.Tensor]
                               ) -> list[torch.Tensor]:
    """The flow cotangents of `warp_fwd_levels_cuda`: images, flows as
    there, output cotangents cts [(B, C, H_k, W_k)] -> [(B, 2, H_k, W_k)]
    float32 = (dL/du, dL/dv) summed over channels, in the flow's layout.
    One launch."""
    _check("warp_flow_grad_levels_cuda", images, flows, cts)
    return _launch("warp flow-gradient kernel",
                   "deepof_warp_flow_grad_levels_f32", grad_launches, images,
                   flows, cts, [torch.empty_like(f) for f in flows])


def warp_fwd_cuda(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """One level of `warp_fwd_levels_cuda`: image (B, C, H, W), flow
    (B, 2, H, W) -> (B, C, H, W)."""
    return warp_fwd_levels_cuda([image], [flow])[0]


def warp_flow_grad_cuda(image: torch.Tensor, flow: torch.Tensor,
                        ct: torch.Tensor) -> torch.Tensor:
    """One level of `warp_flow_grad_levels_cuda` -> (B, 2, H, W)."""
    return warp_flow_grad_levels_cuda([image], [flow], [ct])[0]
