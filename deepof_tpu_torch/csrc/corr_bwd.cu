// FlowNet-C correlation backward, float32 or bf16, for sm_90a: the
// gradients of the cost volume with respect to both feature maps.
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
// FMA throughput bounds it, not device memory. As in the forward, the
// limit in practice is the rate at which an SM reads shared memory (32
// floats a clock against 128 FMAs), so the operands sit in registers.
//
// Design (the forward's recipe applied to the gathers): one block per
// (b, output row y, TX columns, CB channels). For each displacement row
// i whose feature row lies inside the image (df1: y+d_i; df2: y-d_i) the
// block stages in shared memory, zero outside the image:
//   - the feature row (f2 for df1, f1 for df2) of its CB channels over
//     the TX columns plus the halo of the displacement columns;
//   - the g values its columns use, one row of TX for each displacement
//     column j: g[i*n+j, y, x] for df1, g[i*n+j, y-d_i, x-d_j] for df2,
//     so both kernels read g at the output's own column.
// Displacement columns are staged JB at a time (one block of them for
// n <= 21), so the shared memory a block needs does not grow with n.
// A thread owns RX consecutive columns x CT channels of accumulators and
// walks the staged displacement columns in chunks of RJ. Per chunk it
// loads the RX*RJ g values (float4 loads, shared by its CT channels and
// broadcast to the lanes of the other channel groups), then for each
// channel the RX+(RJ-1)*s feature values its window covers, and does
// RX*RJ FMAs from them: 448 FMAs for 14 float4 g loads and 160 feature
// loads at stride 2, against the 8 FMAs for 9 global loads of a thread
// that owns one pixel. The window is indexed with compile-time offsets
// (df2's runs backwards in j), so the kernel is a template on the stride
// (1 to 4); other strides take a generic instance that reads each
// feature value from shared memory. A warp holds 4 threads across x and
// 8 channel groups; a thread's channels are 8 rows apart and a staged
// row is 1 (mod 8) floats long, so the 32 lanes of a feature load hit 32
// banks. Staging is not pipelined: a block stages a row between two
// __syncthreads and then computes on it, and a lane issues the loads of
// RB rows before its first store, so a row costs a few L2 round trips;
// with ~160 registers a thread, 6 blocks (12 warps) share an SM, and
// those round trips, not the shared-memory or FMA rate, set the time.
//
// Same bits as the plain backward (ops/corr.py::
// correlation_backward_reference): each output is summed by one thread
// over i, then j, ascending, with fmaf(g, f, acc), and multiplied by 1/C
// once at the end. No atomics, and the sum over offsets is never split
// across threads or blocks, so two runs give the same bits; a staged zero
// outside the image adds g*0 (df1) or 0*0 (df2), as the plain version's
// zero padding does, and a displacement column past n adds nothing. For
// a power-of-two C, scaling by 1/C at the end is exact, and the result
// equals the plain version's (g/C first) bit for bit.
//
// Element type: both kernels are also templates on the type T of the
// feature maps, g and the gradients in device memory, float or
// __nv_bfloat16. Staging converts T to float into the same float32
// shared-memory rows, so the tiles, the FMA order and the 1/C scaling do
// not depend on T, and a bf16 gradient is the float32 one rounded once
// to nearest even: bf16(x) == f32(x.float()).bfloat16(), bit for bit.

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

using deepof::store1;
using deepof::store4;
using deepof::to_float;

constexpr int TX = 64;            // output columns per block
constexpr int RX = 8;             // consecutive columns per thread
constexpr int XT = TX / RX;       // threads across a tile, 4 a warp
constexpr int CT = 8;             // channels per thread
constexpr int NCG = 8;            // channel groups: a warp's lanes >> 2
constexpr int CB = NCG * CT;      // channels per block
constexpr int THREADS = XT * NCG; // XT / 4 warps
constexpr int RJ = 7;             // displacement columns per register chunk
constexpr int JB = 3 * RJ;        // displacement columns staged at once
constexpr int RB = 8;             // rows a warp stages at once

struct Geometry {
  int C, H, W, n, stride, pad;
  int ctiles;  // blocks over the channels
  int jbe;     // displacement columns staged at once: a multiple of RJ
  int ww;      // staged feature columns: TX + (jbe - 1) * stride
  int wp;      // their row stride in shared memory, 1 (mod 8)
};

// Columns a lane stages per row for stride S, 0 (any width) for the
// generic instance.
__host__ __device__ constexpr int stage_cols(int S) {
  return S > 0 ? (TX + (JB - 1) * S + 31) / 32 : 0;
}

// Stages one displacement row (and block of jbe displacement columns):
// jbe g rows of TX columns into gs, then CB feature rows of ww columns
// into fs, zero outside the image (and past the last channel and the
// last displacement column). Rows go over warps, columns over lanes
// (coalesced); with NC > 0 a lane issues the loads of RB rows x NC
// columns before its first store.
template <int NC, bool WRT_F1, typename T>
__device__ __forceinline__ void stage(const T* fb, const T* gb,
                                      float* gs, float* fs,
                                      const Geometry& g, size_t plane,
                                      int cb0, int i, int j0, int nj, int y,
                                      int yy, int x0, int xf0, int s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nrows = g.jbe + CB;
  const int grow = WRT_F1 ? y : yy;  // the row of g the outputs read
  for (int r0 = warp * RB; r0 < nrows; r0 += (THREADS / 32) * RB) {
    const T* src[RB];  // null: a row of zeros
    float* dst[RB];
    int xb[RB], width[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = r0 + k;
      src[k] = nullptr;
      dst[k] = gs;
      xb[k] = 0;
      width[k] = 0;
      if (r < g.jbe) {
        const int j = j0 + r;
        if (r < nj)
          src[k] = gb + (static_cast<size_t>(i) * g.n + j) * plane
                   + static_cast<size_t>(grow) * g.W;
        dst[k] = gs + r * TX;
        // df2 reads g at the shifted column x - d_j
        xb[k] = WRT_F1 ? x0 : x0 - (j * s - g.pad);
        width[k] = TX;
      } else if (r < nrows) {
        const int c = r - g.jbe;
        if (cb0 + c < g.C)
          src[k] = fb + static_cast<size_t>(c) * plane
                   + static_cast<size_t>(yy) * g.W;
        dst[k] = fs + c * g.wp;
        xb[k] = xf0;
        width[k] = g.ww;
      }
    }
    if constexpr (NC > 0) {
      float val[RB][NC];
#pragma unroll
      for (int k = 0; k < RB; ++k)
#pragma unroll
        for (int m = 0; m < NC; ++m) {
          const int col = lane + 32 * m, xx = xb[k] + col;
          val[k][m] = src[k] && col < width[k] && xx >= 0 && xx < g.W
                          ? to_float(src[k][xx]) : 0.f;
        }
#pragma unroll
      for (int k = 0; k < RB; ++k)
#pragma unroll
        for (int m = 0; m < NC; ++m)
          if (lane + 32 * m < width[k]) dst[k][lane + 32 * m] = val[k][m];
    } else {
#pragma unroll
      for (int k = 0; k < RB; ++k)
        for (int col = lane; col < width[k]; col += 32) {
          const int xx = xb[k] + col;
          dst[k][col] = src[k] && xx >= 0 && xx < g.W ? to_float(src[k][xx])
                                                      : 0.f;
        }
    }
  }
}

// df1 (WRT_F1) or df2 (!WRT_F1) at this thread's RX columns and CT
// channels. `feat` is f2 for df1 and f1 for df2.
template <int S, bool WRT_F1, typename T>
__device__ __forceinline__ void corr_bwd(const T* __restrict__ feat,
                                         const T* __restrict__ g,
                                         T* __restrict__ out,
                                         const Geometry& geo) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                  // [jbe][TX]
  float* fs = smem + geo.jbe * TX;   // [CB][wp]
  const int s = S > 0 ? S : geo.stride;
  const int x0 = blockIdx.x * TX;
  const int y = blockIdx.y;
  const int b = blockIdx.z / geo.ctiles;
  const int cb0 = (blockIdx.z - b * geo.ctiles) * CB;
  const int lane = threadIdx.x & 31;
  const int xr = (lane & 3) + 4 * (threadIdx.x >> 5);  // column thread
  const int cg = lane >> 2;  // channel group: channels cg + NCG * k
  const size_t plane = static_cast<size_t>(geo.H) * geo.W;
  const T* fb = feat + (static_cast<size_t>(b) * geo.C + cb0) * plane;
  const T* gb = g + static_cast<size_t>(b) * geo.n * geo.n * plane;

  float acc[CT][RX];
#pragma unroll
  for (int k = 0; k < CT; ++k)
#pragma unroll
    for (int r = 0; r < RX; ++r) acc[k][r] = 0.f;

  const float* gp = gs + xr * RX;
  const float* fp = fs + cg * geo.wp + xr * RX;
  for (int i = 0; i < geo.n; ++i) {
    const int di = i * s - geo.pad;
    const int yy = WRT_F1 ? y + di : y - di;  // the feature row
    if (yy < 0 || yy >= geo.H) continue;  // uniform over the block
    for (int j0 = 0; j0 < geo.n; j0 += geo.jbe) {
      const int nj = min(geo.jbe, geo.n - j0);
      // image column of staged feature column 0: x0 + d_j0 for df1,
      // x0 - d_(j0+jbe-1) for df2 (its window runs backwards in j)
      const int xf0 = WRT_F1 ? x0 + j0 * s - geo.pad
                             : x0 - ((j0 + geo.jbe - 1) * s - geo.pad);
      __syncthreads();  // the previous block of columns is read
      stage<stage_cols(S), WRT_F1>(fb, gb, gs, fs, geo, plane, cb0, i, j0,
                                   nj, y, yy, x0, xf0, s);
      __syncthreads();
      for (int jq = 0; jq < nj; jq += RJ) {
        float gv[RJ][RX];
#pragma unroll
        for (int q = 0; q < RJ; ++q)
#pragma unroll
          for (int h = 0; h < RX / 4; ++h) {
            const float4 a = *reinterpret_cast<const float4*>(
                gp + (jq + q) * TX + 4 * h);
            gv[q][4 * h] = a.x;
            gv[q][4 * h + 1] = a.y;
            gv[q][4 * h + 2] = a.z;
            gv[q][4 * h + 3] = a.w;
          }
        bool live[RJ];  // displacement columns past n add nothing
#pragma unroll
        for (int q = 0; q < RJ; ++q) live[q] = jq + q < nj;
        // the chunk's window: column r of displacement q is at
        // r + q*s (df1) or r + (RJ-1-q)*s (df2)
        const int wofs = (WRT_F1 ? jq : geo.jbe - jq - RJ) * s;
#pragma unroll
        for (int k = 0; k < CT; ++k) {
          const float* vp = fp + k * NCG * geo.wp + wofs;
          if constexpr (S > 0) {
            constexpr int NV = RX + (RJ - 1) * S;
            float v[NV];
#pragma unroll
            for (int t = 0; t < NV; ++t) v[t] = vp[t];
#pragma unroll
            for (int q = 0; q < RJ; ++q) {
              if (!live[q]) continue;
#pragma unroll
              for (int r = 0; r < RX; ++r)
                acc[k][r] = fmaf(gv[q][r],
                                 v[r + (WRT_F1 ? q : RJ - 1 - q) * S],
                                 acc[k][r]);
            }
          } else {
#pragma unroll
            for (int q = 0; q < RJ; ++q) {
              if (!live[q]) continue;
              const float* vq = vp + (WRT_F1 ? q : RJ - 1 - q) * s;
#pragma unroll
              for (int r = 0; r < RX; ++r)
                acc[k][r] = fmaf(gv[q][r], vq[r], acc[k][r]);
            }
          }
        }
      }
    }
  }

  const int xs = x0 + xr * RX;
  if (xs >= geo.W) return;
  const float inv_c = 1.f / static_cast<float>(geo.C);
  // W % 4 == 0 makes every row start and xs 4-element aligned
  const bool vec = geo.W % 4 == 0 && xs + RX <= geo.W;
#pragma unroll
  for (int k = 0; k < CT; ++k) {
    const int c = cb0 + cg + NCG * k;
    if (c >= geo.C) continue;
    T* o = out + (static_cast<size_t>(b) * geo.C + c) * plane
           + static_cast<size_t>(y) * geo.W + xs;
    if (vec) {
#pragma unroll
      for (int h = 0; h < RX / 4; ++h)
        store4(o + 4 * h, acc[k][4 * h] * inv_c, acc[k][4 * h + 1] * inv_c,
               acc[k][4 * h + 2] * inv_c, acc[k][4 * h + 3] * inv_c);
    } else {
#pragma unroll
      for (int r = 0; r < RX; ++r)
        if (xs + r < geo.W) store1(o + r, acc[k][r] * inv_c);
    }
  }
}

template <int S, typename T>
__global__ void __launch_bounds__(THREADS)
corr_bwd_f1_kernel(const T* __restrict__ f2, const T* __restrict__ g,
                   T* __restrict__ df1, const Geometry geo) {
  corr_bwd<S, true>(f2, g, df1, geo);
}

template <int S, typename T>
__global__ void __launch_bounds__(THREADS)
corr_bwd_f2_kernel(const T* __restrict__ f1, const T* __restrict__ g,
                   T* __restrict__ df2, const Geometry geo) {
  corr_bwd<S, false>(f1, g, df2, geo);
}

template <typename K, typename T>
cudaError_t launch_kernel(K kernel, dim3 grid, size_t smem, cudaStream_t st,
                          const T* f, const T* g, T* o,
                          const Geometry& geo) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, THREADS, smem, st>>>(f, g, o, geo);
  return cudaGetLastError();
}

template <int S, typename T>
cudaError_t launch_stride(bool wrt_f1, dim3 grid, size_t smem,
                          cudaStream_t st, const T* f, const T* g, T* o,
                          const Geometry& geo) {
  return wrt_f1
      ? launch_kernel(corr_bwd_f1_kernel<S, T>, grid, smem, st, f, g, o, geo)
      : launch_kernel(corr_bwd_f2_kernel<S, T>, grid, smem, st, f, g, o, geo);
}

template <typename T>
int launch(bool wrt_f1, const void* feat, const void* g, void* out, int B,
           int C, int H, int W, int max_disp, int stride, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || stride <= 0 || max_disp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);

  Geometry geo{};
  geo.C = C;
  geo.H = H;
  geo.W = W;
  geo.stride = stride;
  const int k = max_disp / stride;
  geo.n = 2 * k + 1;
  geo.pad = k * stride;
  geo.ctiles = (C + CB - 1) / CB;
  const int jround = (geo.n + RJ - 1) / RJ * RJ;
  geo.jbe = jround < JB ? jround : JB;
  const long long ww = TX + (static_cast<long long>(geo.jbe) - 1) * stride;
  const long long wp = ww + (9 - ww % 8) % 8;  // == 1 (mod 8)
  const long long smem_ll =
      static_cast<long long>(sizeof(float)) * (geo.jbe * TX + CB * wp);
  if (smem_ll > smem_max) return static_cast<int>(cudaErrorInvalidValue);
  geo.ww = static_cast<int>(ww);
  geo.wp = static_cast<int>(wp);
  const long long zdim = static_cast<long long>(B) * geo.ctiles;
  if (zdim > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid((W + TX - 1) / TX, H, static_cast<unsigned>(zdim));
  const size_t smem = static_cast<size_t>(smem_ll);
  const T* f = static_cast<const T*>(feat);
  const T* gg = static_cast<const T*>(g);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (stride) {
    case 1: e = launch_stride<1>(wrt_f1, grid, smem, st, f, gg, o, geo); break;
    case 2: e = launch_stride<2>(wrt_f1, grid, smem, st, f, gg, o, geo); break;
    case 3: e = launch_stride<3>(wrt_f1, grid, smem, st, f, gg, o, geo); break;
    case 4: e = launch_stride<4>(wrt_f1, grid, smem, st, f, gg, o, geo); break;
    default: e = launch_stride<0>(wrt_f1, grid, smem, st, f, gg, o, geo); break;
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// f2, g -> df1 and f1, g -> df2. Feature maps and gradients (B, C, H, W),
// g (B, n*n, H, W), all contiguous on the current device and of one
// type: float32 (_f32) or bf16 (_bf16). Each launches one kernel on
// `stream` and returns cudaGetLastError() (0 on success); neither
// synchronises.
int deepof_corr_bwd_f1_f32(const void* f2, const void* g, void* df1, int B,
                           int C, int H, int W, int max_disp, int stride,
                           void* stream) {
  return launch<float>(true, f2, g, df1, B, C, H, W, max_disp, stride,
                       stream);
}

int deepof_corr_bwd_f2_f32(const void* f1, const void* g, void* df2, int B,
                           int C, int H, int W, int max_disp, int stride,
                           void* stream) {
  return launch<float>(false, f1, g, df2, B, C, H, W, max_disp, stride,
                       stream);
}

int deepof_corr_bwd_f1_bf16(const void* f2, const void* g, void* df1, int B,
                            int C, int H, int W, int max_disp, int stride,
                            void* stream) {
  return launch<__nv_bfloat16>(true, f2, g, df1, B, C, H, W, max_disp,
                               stride, stream);
}

int deepof_corr_bwd_f2_bf16(const void* f1, const void* g, void* df2, int B,
                            int C, int H, int W, int max_disp, int stride,
                            void* stream) {
  return launch<__nv_bfloat16>(false, f1, g, df2, B, C, H, W, max_disp,
                               stride, stream);
}

const char* deepof_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
