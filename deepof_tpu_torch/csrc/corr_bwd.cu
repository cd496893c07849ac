// FlowNet-C correlation backward, float32, for sm_90a: the gradients of
// the cost volume with respect to both feature maps.
//
// Replaces the custom VJP of deepof_tpu/ops/pallas/corr.py::_bwd, an XLA
// scan over the (2K+1)^2 displacements (the TPU kernel's backward; it is
// not Pallas). Same function, with s = stride, K = max_disp / stride,
// n = 2K+1 and d_i = (i - K) * s:
//
//   df1[b,c,y,x] = (1/C) sum_{i,j} g[b,i*n+j,y,x] * f2[b,c,y+d_i,x+d_j]
//   df2[b,c,y,x] = (1/C) sum_{i,j} g[b,i*n+j,y-d_i,x-d_j]
//                                  * f1[b,c,y-d_i,x-d_j]
//
// where f2 contributes zero outside its bounds (df1), and only the
// (y-d_i, x-d_j) inside the image contribute (df2). Layout: NCHW feature
// maps, g in the forward's (B, n*n, H, W).
//
// What bounds it: each kernel does the forward's work, 2*B*H*W*n*n*C
// float32 operations (2.77 G at 4x256x48x64, n = 21) on g and two
// feature maps (47 MB there): about 59 operations per byte, so float32
// FMA throughput bounds it (0.041 ms at 67 TFLOP/s), not device memory.
//
// Design: both are gathers, each output written once by one thread; no
// atomics, and the sum runs over i, then j, in a fixed order, so two
// runs give the same bits. A thread owns one output pixel (b, y, x) and
// a tile of CT channels. For each displacement it reads one g value and
// uses it for all CT channels, so the n*n loads of g are spread over the
// tile; the CT feature-map loads per displacement are the rest. A warp
// covers 32 consecutive columns of one row: every load is coalesced.
// Nothing is staged in shared memory: the feature-map window of a block
// is reread from L1/L2 once per displacement, which leaves the kernel
// bound by load instructions (about 9 per 8 FMAs), far off the FMA bound.
// The stride is a template argument (1 to 4, and a generic instance).

#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // columns per block: one warp across a row
constexpr int BY = 8;   // rows per block
constexpr int CT = 8;   // channels per thread

struct Geometry {
  int C, H, W, n, stride, pad;
  int ctiles;  // channel tiles of CT per batch row
};

// df1 (WRT_F1) or df2 (!WRT_F1) at this thread's pixel and channel
// tile. `feat` is f2 for df1 and f1 for df2.
template <int S, bool WRT_F1>
__device__ __forceinline__ void corr_bwd(const float* __restrict__ feat,
                                         const float* __restrict__ g,
                                         float* __restrict__ out,
                                         const Geometry& geo) {
  const int s = S > 0 ? S : geo.stride;
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= geo.W || y >= geo.H) return;
  const int b = blockIdx.z / geo.ctiles;
  const int c0 = (blockIdx.z - b * geo.ctiles) * CT;
  const int nc = min(CT, geo.C - c0);
  const size_t plane = static_cast<size_t>(geo.H) * geo.W;
  const float* fb = feat + (static_cast<size_t>(b) * geo.C + c0) * plane;
  const float* gb = g + static_cast<size_t>(b) * geo.n * geo.n * plane;

  float acc[CT];
#pragma unroll
  for (int k = 0; k < CT; ++k) acc[k] = 0.f;

  for (int i = 0; i < geo.n; ++i) {
    const int di = i * s - geo.pad;
    // df1 reads f2 at y + d_i; df2 reads g and f1 at y - d_i
    const int yy = WRT_F1 ? y + di : y - di;
    if (yy < 0 || yy >= geo.H) continue;
    const int grow = WRT_F1 ? y : yy;
    const float* gi = gb + static_cast<size_t>(i) * geo.n * plane
                      + static_cast<size_t>(grow) * geo.W;
    const float* fr = fb + static_cast<size_t>(yy) * geo.W;
    for (int j = 0; j < geo.n; ++j) {
      const int dj = j * s - geo.pad;
      const int xx = WRT_F1 ? x + dj : x - dj;
      if (xx < 0 || xx >= geo.W) continue;
      const float gv = gi[static_cast<size_t>(j) * plane + (WRT_F1 ? x : xx)];
      const float* fp = fr + xx;
#pragma unroll
      for (int k = 0; k < CT; ++k)
        if (k < nc) acc[k] = fmaf(gv, fp[k * plane], acc[k]);
    }
  }

  const float inv_c = 1.f / static_cast<float>(geo.C);
  float* o = out + (static_cast<size_t>(b) * geo.C + c0) * plane
             + static_cast<size_t>(y) * geo.W + x;
#pragma unroll
  for (int k = 0; k < CT; ++k)
    if (k < nc) o[k * plane] = acc[k] * inv_c;
}

template <int S>
__global__ void __launch_bounds__(BX * BY)
corr_bwd_f1_kernel(const float* __restrict__ f2, const float* __restrict__ g,
                   float* __restrict__ df1, const Geometry geo) {
  corr_bwd<S, true>(f2, g, df1, geo);
}

template <int S>
__global__ void __launch_bounds__(BX * BY)
corr_bwd_f2_kernel(const float* __restrict__ f1, const float* __restrict__ g,
                   float* __restrict__ df2, const Geometry geo) {
  corr_bwd<S, false>(f1, g, df2, geo);
}

template <int S>
void launch_stride(bool wrt_f1, dim3 grid, dim3 block, cudaStream_t st,
                   const float* f, const float* g, float* o,
                   const Geometry& geo) {
  if (wrt_f1)
    corr_bwd_f1_kernel<S><<<grid, block, 0, st>>>(f, g, o, geo);
  else
    corr_bwd_f2_kernel<S><<<grid, block, 0, st>>>(f, g, o, geo);
}

int launch(bool wrt_f1, const void* feat, const void* g, void* out, int B,
           int C, int H, int W, int max_disp, int stride, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || stride <= 0 || max_disp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Geometry geo{};
  geo.C = C;
  geo.H = H;
  geo.W = W;
  geo.stride = stride;
  const int k = max_disp / stride;
  geo.n = 2 * k + 1;
  geo.pad = k * stride;
  geo.ctiles = (C + CT - 1) / CT;
  const long long zdim = static_cast<long long>(B) * geo.ctiles;
  const long long ydim = (H + BY - 1) / BY;
  if (zdim > 65535 || ydim > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((W + BX - 1) / BX, static_cast<unsigned>(ydim),
                  static_cast<unsigned>(zdim));
  const dim3 block(BX, BY);
  const float* f = static_cast<const float*>(feat);
  const float* gg = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stride) {
    case 1: launch_stride<1>(wrt_f1, grid, block, st, f, gg, o, geo); break;
    case 2: launch_stride<2>(wrt_f1, grid, block, st, f, gg, o, geo); break;
    case 3: launch_stride<3>(wrt_f1, grid, block, st, f, gg, o, geo); break;
    case 4: launch_stride<4>(wrt_f1, grid, block, st, f, gg, o, geo); break;
    default: launch_stride<0>(wrt_f1, grid, block, st, f, gg, o, geo); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f2, g -> df1 and f1, g -> df2. Feature maps and gradients (B, C, H, W),
// g (B, n*n, H, W), all float32 contiguous on the current device. Each
// launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success); neither synchronises.
int deepof_corr_bwd_f1_f32(const void* f2, const void* g, void* df1, int B,
                           int C, int H, int W, int max_disp, int stride,
                           void* stream) {
  return launch(true, f2, g, df1, B, C, H, W, max_disp, stride, stream);
}

int deepof_corr_bwd_f2_f32(const void* f1, const void* g, void* df2, int B,
                           int C, int H, int W, int max_disp, int stride,
                           void* stream) {
  return launch(false, f1, g, df2, B, C, H, W, max_disp, stride, stream);
}

const char* deepof_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
