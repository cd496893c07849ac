// Element access shared by the correlation kernels (corr.cu, corr_bwd.cu),
// which are templates on the element type T of their tensors in device
// memory: float or __nv_bfloat16. Values are converted to float where
// they are staged and rounded back where they are stored, to nearest
// even as torch's .to(torch.bfloat16) rounds, so a kernel's float32
// tiles and arithmetic do not depend on T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace deepof {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

// Two bf16 values, rounded to nearest even, packed as one __nv_bfloat162
// (a at the lower address).
__device__ __forceinline__ unsigned pack_bf16x2(float a, float b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(a)))
         | static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(b)))
               << 16;
}

// Four consecutive outputs, o 4-element aligned: one float4 store, or
// two bf16 pairs in one 8-byte store.
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b,
                                       float c, float d) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16x2(a, b),
                                            pack_bf16x2(c, d));
}

}  // namespace deepof
