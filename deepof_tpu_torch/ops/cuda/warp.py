"""Wrappers of the CUDA warp kernels (`csrc/warp.cu`).

`warp_fwd_cuda` replaces `deepof_tpu/ops/pallas/warp.py::_warp_kernel`
and `warp_flow_grad_cuda` replaces `::_warp_flow_grad_kernel`. Both are
bound by bytes at the finest pyramid level and by launch latency at the
coarse ones (see the note in the source).

They take float32 only. The JAX package also warps a bf16 image
(`loss.gather_dtype="bfloat16"`); that path comes with the bf16 work, and
until then a bf16 CUDA tensor raises here rather than being converted.

The wrappers never fall back to the plain version: a failed build or
launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from .build import LaunchCounter, check, load

fwd_launches = LaunchCounter("warp_fwd")
grad_launches = LaunchCounter("warp_flow_grad")

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "deepof_warp_fwd_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "deepof_warp_flow_grad_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _lib() -> ctypes.CDLL:
    lib = load("warp")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _check(what: str, channels: int | None, **tensors: torch.Tensor
           ) -> tuple[int, int, int]:
    """Device, dtype, layout and shape checks; returns (B, H, W)."""
    dev = None
    bhw = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}; this kernel "
                            "takes float32 only")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous NCHW "
                             f"tensor, got {tuple(t.shape)}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, not {dev}")
        shape = (t.shape[0], t.shape[2], t.shape[3])
        if bhw is not None and shape != bhw:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} does not "
                             f"match (B, H, W) = {bhw}")
        dev, bhw = t.device, shape
    if tensors["flow"].shape[1] != 2:
        raise ValueError(f"{what}: flow must have 2 channels, got "
                         f"{tuple(tensors['flow'].shape)}")
    if channels is not None and tensors["ct"].shape[1] != channels:
        raise ValueError(f"{what}: cotangent {tuple(tensors['ct'].shape)} "
                         f"vs image channels {channels}")
    return bhw


def warp_fwd_cuda(image: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """image (B, C, H, W), flow (B, 2, H, W), float32 on one CUDA device
    -> the image warped backward by the flow, (B, C, H, W) float32."""
    b, h, w = _check("warp_fwd_cuda", None, image=image, flow=flow)
    c = image.shape[1]
    out = torch.empty_like(image)
    lib = _lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deepof_warp_fwd_f32(image.data_ptr(), flow.data_ptr(),
                                     out.data_ptr(), b, c, h, w, stream)
    check(lib, rc, "warp forward kernel launch")
    fwd_launches.add()
    return out


def warp_flow_grad_cuda(image: torch.Tensor, flow: torch.Tensor,
                        ct: torch.Tensor) -> torch.Tensor:
    """The flow cotangent of `warp_fwd_cuda`: image (B, C, H, W), flow
    (B, 2, H, W), output cotangent ct (B, C, H, W) -> (B, 2, H, W)
    float32 = (dL/du, dL/dv), summed over channels."""
    b, h, w = _check("warp_flow_grad_cuda", image.shape[1], image=image,
                     flow=flow, ct=ct)
    out = torch.empty_like(flow)
    lib = _lib()
    with torch.cuda.device(image.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.deepof_warp_flow_grad_f32(
            image.data_ptr(), flow.data_ptr(), ct.data_ptr(),
            out.data_ptr(), b, image.shape[1], h, w, stream)
    check(lib, rc, "warp flow-gradient kernel launch")
    grad_launches.add()
    return out
