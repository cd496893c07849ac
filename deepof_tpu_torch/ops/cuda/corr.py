"""Wrapper of the CUDA correlation kernel (`csrc/corr.cu`).

Replaces `deepof_tpu/ops/pallas/corr.py::_corr_kernel`. The kernel is
bound by float32 FMA throughput: each thread keeps a tile of 8 columns x
7 displacements in registers and does 56 FMAs for every 28 values it
reads from shared memory (see the note in the source).

This slice's kernel takes float32 only. The JAX kernel also takes bf16
(accumulating in f32 and returning bf16, `ops/pallas/corr.py:104-106`);
that path comes with the bf16 serving tier. Until then a bf16 CUDA
tensor raises here rather than being converted.

The wrapper never falls back to the plain version: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LaunchCounter, check, load

launches = LaunchCounter("corr")

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = load("corr")
    fn = lib.deepof_corr_fwd_f32
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor, max_disp: int,
                     stride: int) -> torch.Tensor:
    """(B, C, H, W) float32 x2 on one CUDA device ->
    (B, (2K+1)**2, H, W) float32, K = max_disp // stride."""
    for name, t in (("f1", f1), ("f2", f2)):
        if t.device.type != "cuda":
            raise ValueError(f"correlation_cuda: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"correlation_cuda: {name} is {t.dtype}; this "
                            "kernel takes float32 only")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"correlation_cuda: {name} must be a contiguous "
                             f"(B, C, H, W) tensor, got {tuple(t.shape)}")
    if f1.shape != f2.shape or f1.device != f2.device:
        raise ValueError(f"correlation_cuda: f1 {tuple(f1.shape)} on "
                         f"{f1.device} vs f2 {tuple(f2.shape)} on {f2.device}")
    if stride <= 0 or max_disp < 0:
        raise ValueError(f"correlation_cuda: max_disp={max_disp}, "
                         f"stride={stride}")
    b, c, h, w = f1.shape
    n = 2 * (max_disp // stride) + 1
    out = torch.empty((b, n * n, h, w), device=f1.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(f1.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deepof_corr_fwd_f32(f1.data_ptr(), f2.data_ptr(),
                                     out.data_ptr(), b, c, h, w, max_disp,
                                     stride, stream)
    check(lib, rc, "corr kernel launch")
    launches.add()
    return out
