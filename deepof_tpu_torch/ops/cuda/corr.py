"""Wrappers of the CUDA correlation kernels: the forward (`csrc/corr.cu`)
and its two backward kernels (`csrc/corr_bwd.cu`).

`correlation_cuda` replaces `deepof_tpu/ops/pallas/corr.py::_corr_kernel`.
The kernel is bound by float32 FMA throughput: each thread keeps a tile
of 8 columns x 7 displacements in registers and does 56 FMAs for every 28
values it reads from shared memory (see the note in the source). Each
output sums the channels ascending with fused multiply-adds and is
scaled by 1/C once, as `correlation_reference` does: the same bits.
`correlation_bwd_cuda` replaces the custom VJP `_bwd` of the same file
(an XLA scan): one gather kernel for each feature map's gradient, on the
forward's recipe. A block stages, for each displacement row, the feature
row of 64 channels over its 64 columns plus the halo, and the g values
its columns read, in shared memory; a thread keeps 8 columns x 8
channels of sums in registers and does 448 FMAs for every 14 float4 g
loads and 160 feature loads it makes from shared memory (see the note in
the source). Each output is summed by one thread over the displacements
in the plain version's order, with no atomics: two calls give the same
bits, and for a power-of-two channel count the plain backward's bits.

`correlation_cuda` returns a tensor without a gradient: autograd goes
through `ops/corr.py::Correlation`, which calls both wrappers, and
`correlation_cuda` raises when it is handed a tensor that requires grad
with grad mode on, so no caller can drop the gradient silently.

Each kernel takes float32 or bf16, with every tensor of a call of one
type, and returns that type: the JAX kernel accumulates in float32 and
returns the input dtype (`ops/pallas/corr.py:104-106`). Training under
`train.compute_dtype="bfloat16"` hands them bf16 feature maps. A bf16
instance stages bf16 into the same float32 tiles and rounds its float32
result once, so it gives the float32 kernel's bits on the upcast inputs,
rounded to bf16. Each (kernel, dtype) has its own launch counter:
`corr`, `corr_bwd_f1`, `corr_bwd_f2` and `corr_bf16`,
`corr_bwd_f1_bf16`, `corr_bwd_f2_bf16`. Mixed dtypes raise.

The wrapper never falls back to the plain version: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LaunchCounter, check, load

launches = LaunchCounter("corr", "corr")
bwd_f1_launches = LaunchCounter("corr_bwd_f1", "corr_bwd")
bwd_f2_launches = LaunchCounter("corr_bwd_f2", "corr_bwd")
bf16_launches = LaunchCounter("corr_bf16", "corr")
bwd_f1_bf16_launches = LaunchCounter("corr_bwd_f1_bf16", "corr_bwd")
bwd_f2_bf16_launches = LaunchCounter("corr_bwd_f2_bf16", "corr_bwd")

#: dtype -> (entry-point suffix, forward, corr_bwd_f1, corr_bwd_f2 counters)
_BY_DTYPE = {
    torch.float32: ("f32", launches, bwd_f1_launches, bwd_f2_launches),
    torch.bfloat16: ("bf16", bf16_launches, bwd_f1_bf16_launches,
                     bwd_f2_bf16_launches),
}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib(name: str, fns: tuple[str, ...]) -> ctypes.CDLL:
    lib = load(name)
    for fn_name in fns:
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
    return lib


def _check(what: str, max_disp: int, stride: int,
           tensors: tuple[tuple[str, torch.Tensor], ...]) -> tuple:
    """Contiguous (B, C, H, W) tensors of one dtype, float32 or
    bfloat16, on one CUDA device and a valid geometry, or raise. Returns
    that dtype's `_BY_DTYPE` entry."""
    dtype = tensors[0][1].dtype
    for name, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}")
        if t.dtype not in _BY_DTYPE:
            raise TypeError(f"{what}: {name} is {t.dtype}; these kernels "
                            "take float32 or bfloat16")
        if t.dtype != dtype:
            raise TypeError(f"{what}: mixed dtypes: " + ", ".join(
                f"{n} {x.dtype}" for n, x in tensors))
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"(B, C, H, W) tensor, got {tuple(t.shape)}")
    f1, f2 = tensors[0][1], tensors[1][1]
    if f1.shape != f2.shape or any(t.device != f1.device
                                   for _, t in tensors):
        raise ValueError(f"{what}: " + " vs ".join(
            f"{n} {tuple(t.shape)} on {t.device}" for n, t in tensors))
    if stride <= 0 or max_disp < 0:
        raise ValueError(f"{what}: max_disp={max_disp}, stride={stride}")
    return _BY_DTYPE[dtype]


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
                     stride: int) -> torch.Tensor:
    """(B, C, H, W) x2, float32 or bfloat16, on one CUDA device ->
    (B, (2K+1)**2, H, W) of their dtype, K = max_disp // stride. The result has
    no gradient: with grad mode on, an input that requires grad raises
    (call `ops/corr.py::correlation_nchw`, which differentiates)."""
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        raise RuntimeError(
            "correlation_cuda: an input requires grad, and this kernel's "
            "result has none; differentiate through "
            "ops/corr.py::correlation_nchw (the Correlation Function)")
    suffix, counter, _, _ = _check("correlation_cuda", max_disp, stride,
                                   (("f1", f1), ("f2", f2)))
    b, c, h, w = f1.shape
    n = 2 * (max_disp // stride) + 1
    out = torch.empty((b, n * n, h, w), device=f1.device, dtype=f1.dtype)
    lib = _lib("corr", ("deepof_corr_fwd_f32", "deepof_corr_fwd_bf16"))
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"deepof_corr_fwd_{suffix}")(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w,
            max_disp, stride, stream)
    check(lib, rc, f"{counter.name} kernel launch")
    counter.add(lambda: (b, c, h, w, max_disp, stride))
    return out


def correlation_bwd_cuda(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                         max_disp: int, stride: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients (df1, df2) of `correlation_cuda(f1, f2, max_disp,
    stride)` for its cotangent g (B, (2K+1)**2, H, W): one launch of
    `corr_bwd_f1` and one of `corr_bwd_f2`. All contiguous, on one CUDA
    device, and of one dtype, float32 or bfloat16, which the gradients
    take too."""
    suffix, _, f1_counter, f2_counter = _check(
        "correlation_bwd_cuda", max_disp, stride,
        (("f1", f1), ("f2", f2), ("g", g)))
    b, c, h, w = f1.shape
    n = 2 * (max_disp // stride) + 1
    if g.shape != (b, n * n, h, w):
        raise ValueError(f"correlation_bwd_cuda: g {tuple(g.shape)}; want "
                         f"{(b, n * n, h, w)} for max_disp={max_disp}, "
                         f"stride={stride}")
    df1, df2 = torch.empty_like(f1), torch.empty_like(f2)
    lib = _lib("corr_bwd", tuple(f"deepof_corr_bwd_{k}_{t}"
                                 for k in ("f1", "f2")
                                 for t in ("f32", "bf16")))
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        for which, feat, out, counter in (("f1", f2, df1, f1_counter),
                                          ("f2", f1, df2, f2_counter)):
            rc = getattr(lib, f"deepof_corr_bwd_{which}_{suffix}")(
                feat.data_ptr(), g.data_ptr(), out.data_ptr(), b, c, h, w,
                max_disp, stride, stream)
            check(lib, rc, f"{counter.name} kernel launch")
            counter.add(lambda: (b, c, h, w, max_disp, stride))
    return df1, df2
