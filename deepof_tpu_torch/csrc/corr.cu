// FlowNet-C correlation (cost volume) forward, float32 or bf16, for
// sm_90a.
//
// Replaces deepof_tpu/ops/pallas/corr.py::_corr_kernel (the Pallas TPU
// kernel behind correlation_pallas). Same function:
//
//   out[b, i*n+j, y, x] = (1/C) * sum_c f1[b,c,y,x] * f2[b,c,y+dy_i,x+dx_j]
//   dy_i = i*stride - pad, dx_j = j*stride - pad, pad = K*stride,
//   K = max_disp / stride, n = 2K+1, f2 is zero outside its bounds.
//
// Layout: NCHW inputs (the convolutions' output) and a (B, n*n, H, W)
// output, the TPU kernel's own output layout and the one the following
// channel concat wants.
//
// What bounds it: at the FlowNet-C serving shape (8x256x48x64, n=21) one
// call is 2.77 G multiply-adds on 94 MB of inputs and output, about 30
// FMAs per byte, so it is bound by float32 FMA throughput (exact f32: no
// tensor cores), not by device memory. The limit in practice is the rate
// at which an SM reads shared memory (32 floats a clock against 128 FMAs),
// so the design keeps the operands in registers.
//
// Design: one block per (batch row b, output row y, tile of TX columns,
// group of GI displacement rows, group of displacement columns). Channels
// are walked in chunks of CC: the block stages the f1 row tile and the GI
// f2 rows y+dy_i, with the halo its displacement columns need, zero-filled
// outside the image, in shared memory. Each thread owns one displacement
// row i, RJ consecutive displacement columns j and RX consecutive columns
// x, and for each channel loads its RX f1 values and the RX+(RJ-1)*stride
// f2 values its window covers into registers and does RX*RJ FMAs from
// them: 28 shared-memory loads for 56 FMAs at stride 2. The window is
// indexed with compile-time offsets, so the kernel is a template on the
// stride (1 to 4); other strides take a generic instance that reads each
// f2 value from shared memory. f2 is read from device memory once per
// block, not once per displacement chunk, and each lane issues a batch of
// staging loads before it stores any: with one load at a time the kernel
// waits on L2 latency, not bandwidth.
//
// Element type: the kernel is also a template on the type T of the
// inputs and output in device memory, float or __nv_bfloat16. Staging
// converts T to float on its way into the same float32 shared-memory
// tiles, so the tiles, the register tile, the FMA order and the 1/C
// scaling do not depend on T; a bf16 output is the float32 result
// rounded once to nearest even (torch's .to(torch.bfloat16)). So
// bf16(x) == f32(x.float()).bfloat16(), bit for bit, at every shape. The
// JAX kernel does the same: it upcasts, accumulates in float32 and
// returns the input dtype.

#include <cuda_runtime.h>

#include "elem.cuh"

namespace {

using deepof::store1;
using deepof::store4;
using deepof::to_float;

constexpr int TX = 64;        // output columns per block
constexpr int RX = 8;         // consecutive columns per thread
constexpr int RJ = 7;         // consecutive displacement columns per thread
constexpr int XT = TX / RX;   // threads across one tile
constexpr int GI = 7;         // displacement rows per block, at most
constexpr int CC = 16;        // channels staged per chunk, at most
constexpr int MAX_THREADS = 256;
constexpr int SMEM_TARGET = 64 * 1024;  // CC is lowered to stay under this

struct Geometry {
  int C, H, W, n, stride, pad;
  int gi_n;     // displacement rows per block
  int jcb;      // chunks of RJ displacement columns per block
  int igroups;  // blocks over the displacement rows
  int jgroups;  // blocks over the displacement columns
  int ww;       // staged f2 columns per row
  int wwp;      // their row stride in shared memory, 1 mod 8: the four
                // (row, column chunk) pairs of a warp read other banks
  int cc;       // channels per staged chunk
  int ncompute; // threads that own outputs: XT * gi_n * jcb
};

// The widest f2 window a block stages: at most MAX_THREADS / (XT * GI)
// chunks of RJ displacement columns (fewer rows per block only come with
// a single chunk).
constexpr int MAX_JCB = MAX_THREADS / (XT * GI);
constexpr int RB = 4;  // rows a warp stages at once

// Columns a lane stages per row for stride S, 0 (any width) for the
// generic instance.
__host__ __device__ constexpr int stage_cols(int S) {
  return S > 0 ? (TX + (MAX_JCB * RJ - 1) * S + 31) / 32 : 0;
}

// Stages one chunk of cc channels: cc f1 rows of TX columns into f1s,
// then cc * gi_n f2 rows of ww columns into f2s, zero outside the image.
// Rows go over warps and columns over lanes (coalesced). With NC > 0 a
// lane issues the loads of RB rows x NC columns before its first store,
// so a chunk costs a few L2 round trips, not one per row and column.
template <int NC, typename T>
__device__ __forceinline__ void stage_chunk(
    const T* f1b, const T* f2b, float* f1s, float* f2s,
    const Geometry& g, size_t plane, int c0, int cc, int y, int x0, int xw0,
    int i0, int s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int nrows = cc * (1 + g.gi_n);
  for (int r0 = warp * RB; r0 < nrows; r0 += nwarps * RB) {
    const T* src[RB];  // null: a row of zeros
    float* dst[RB];
    int xb[RB], width[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      const int r = r0 + k;
      src[k] = nullptr;
      dst[k] = f1s;
      xb[k] = 0;
      width[k] = 0;
      if (r < cc) {
        src[k] = f1b + static_cast<size_t>(c0 + r) * plane;
        dst[k] = f1s + r * TX;
        xb[k] = x0;
        width[k] = TX;
      } else if (r < nrows) {
        const int rr = r - cc;
        const int c = rr / g.gi_n;
        const int i = i0 + rr - c * g.gi_n;
        const int yy = y + i * s - g.pad;
        if (i < g.n && yy >= 0 && yy < g.H)
          src[k] = f2b + static_cast<size_t>(c0 + c) * plane
                   + static_cast<size_t>(yy) * g.W;
        dst[k] = f2s + rr * g.wwp;
        xb[k] = xw0;
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

// S: the stride; 0: any stride, read from the geometry. T: the element
// type of f1, f2 and out.
template <int S, typename T>
__global__ void __launch_bounds__(MAX_THREADS)
corr_fwd_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                T* __restrict__ out, const Geometry g) {
  extern __shared__ __align__(16) float smem[];
  const int s = S > 0 ? S : g.stride;
  float* f1s = smem;              // [cc][TX]
  float* f2s = smem + g.cc * TX;  // [cc][gi_n][wwp]

  int z = blockIdx.z;
  const int jg = z % g.jgroups;
  z /= g.jgroups;
  const int ig = z % g.igroups;
  const int b = z / g.igroups;
  const int y = blockIdx.y;
  const int x0 = blockIdx.x * TX;
  const int i0 = ig * g.gi_n;
  const int jb = jg * g.jcb * RJ;        // the block's first column j
  const int xw0 = x0 + jb * s - g.pad;   // image column of staged column 0

  const int tid = threadIdx.x;
  // threads over x fastest, then displacement-column chunk, then row
  const bool owns = tid < g.ncompute;
  const int xr = tid % XT;
  const int jc = (tid / XT) % g.jcb;
  const int gi = tid / XT / g.jcb;

  // rows of the group inside the image; none: the outputs are all zero
  bool any_row = false;
  for (int k = 0; k < g.gi_n; ++k) {
    const int i = i0 + k, yy = y + i * s - g.pad;
    any_row |= i < g.n && yy >= 0 && yy < g.H;
  }

  const size_t plane = static_cast<size_t>(g.H) * g.W;
  float acc[RX][RJ];
#pragma unroll
  for (int r = 0; r < RX; ++r)
#pragma unroll
    for (int q = 0; q < RJ; ++q) acc[r][q] = 0.f;

  if (any_row) {  // uniform over the block: __syncthreads is safe
    const T* f1b = f1 + static_cast<size_t>(b) * g.C * plane
                   + static_cast<size_t>(y) * g.W;
    const T* f2b = f2 + static_cast<size_t>(b) * g.C * plane;
    const int vstep = g.gi_n * g.wwp;
    for (int c0 = 0; c0 < g.C; c0 += g.cc) {
      const int cc = min(g.cc, g.C - c0);
      __syncthreads();  // the previous chunk's reads are done
      stage_chunk<stage_cols(S)>(f1b, f2b, f1s, f2s, g, plane, c0, cc, y,
                                 x0, xw0, i0, s);
      __syncthreads();
      if (owns) {
        const float* ap = f1s + xr * RX;
        const float* vp = f2s + gi * g.wwp + xr * RX + jc * RJ * s;
        for (int c = 0; c < cc; ++c, ap += TX, vp += vstep) {
          const float4 a0 = *reinterpret_cast<const float4*>(ap);
          const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
          const float a[RX] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
          if constexpr (S > 0) {
            constexpr int NV = RX + (RJ - 1) * S;
            float v[NV];
#pragma unroll
            for (int t = 0; t < NV; ++t) v[t] = vp[t];
#pragma unroll
            for (int r = 0; r < RX; ++r)
#pragma unroll
              for (int q = 0; q < RJ; ++q)
                acc[r][q] = fmaf(a[r], v[r + q * S], acc[r][q]);
          } else {
#pragma unroll
            for (int q = 0; q < RJ; ++q) {
              const float* vq = vp + q * s;
#pragma unroll
              for (int r = 0; r < RX; ++r)
                acc[r][q] = fmaf(a[r], vq[r], acc[r][q]);
            }
          }
        }
      }
    }
  }

  const int i = i0 + gi;
  const int xs = x0 + xr * RX;
  if (!owns || i >= g.n || xs >= g.W) return;
  const float inv_c = 1.f / static_cast<float>(g.C);
  T* ob = out + (static_cast<size_t>(b) * g.n + i) * g.n * plane
          + static_cast<size_t>(y) * g.W + xs;
  // W % 4 == 0 makes every row start and xs 4-element aligned
  const bool vec = g.W % 4 == 0 && xs + RX <= g.W;
#pragma unroll
  for (int q = 0; q < RJ; ++q) {
    const int j = jb + jc * RJ + q;
    if (j >= g.n) continue;
    T* o = ob + static_cast<size_t>(j) * plane;
    if (vec) {
      store4(o, acc[0][q] * inv_c, acc[1][q] * inv_c, acc[2][q] * inv_c,
             acc[3][q] * inv_c);
      store4(o + 4, acc[4][q] * inv_c, acc[5][q] * inv_c, acc[6][q] * inv_c,
             acc[7][q] * inv_c);
    } else {
#pragma unroll
      for (int r = 0; r < RX; ++r)
        if (xs + r < g.W) store1(o + r, acc[r][q] * inv_c);
    }
  }
}

template <int S, typename T>
cudaError_t launch(const T* f1, const T* f2, T* out, int B,
                   const Geometry& g, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_fwd_kernel<S, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((g.W + TX - 1) / TX, g.H,
                  static_cast<unsigned>(B * g.igroups * g.jgroups));
  const int threads = (g.ncompute + 31) / 32 * 32;
  corr_fwd_kernel<S, T><<<grid, threads, smem, stream>>>(f1, f2, out, g);
  return cudaGetLastError();
}

template <typename T>
int corr_fwd(const void* f1, const void* f2, void* out, int B, int C, int H,
             int W, int max_disp, int stride, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || stride <= 0 || max_disp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);

  Geometry g{};
  g.C = C;
  g.H = H;
  g.W = W;
  g.stride = stride;
  const int k = max_disp / stride;
  g.n = 2 * k + 1;
  g.pad = k * stride;
  const int jchunks = (g.n + RJ - 1) / RJ;
  g.gi_n = g.n < GI ? g.n : GI;
  g.jcb = jchunks < MAX_THREADS / (XT * g.gi_n) ? jchunks
                                                : MAX_THREADS / (XT * g.gi_n);
  // channels per chunk from the window's width: CC, fewer for a wide
  // window, and one channel with fewer rows or columns per block if even
  // that does not fit
  long long per_c = 0;
  for (;;) {
    const long long ww = TX + (static_cast<long long>(g.jcb) * RJ - 1) *
                                  stride;
    const long long wwp = ww + (9 - ww % 8) % 8;  // == 1 (mod 8)
    per_c = static_cast<long long>(sizeof(float)) * (TX + g.gi_n * wwp);
    if (per_c <= smem_max) {
      g.ww = static_cast<int>(ww);
      g.wwp = static_cast<int>(wwp);
      const long long fit = SMEM_TARGET / per_c;
      g.cc = static_cast<int>(fit < 1 ? 1 : fit < CC ? fit : CC);
      if (g.cc > C) g.cc = C;
      break;
    }
    if (g.jcb > 1) {
      --g.jcb;
    } else if (g.gi_n > 1) {
      --g.gi_n;
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  g.igroups = (g.n + g.gi_n - 1) / g.gi_n;
  g.jgroups = (jchunks + g.jcb - 1) / g.jcb;
  g.ncompute = XT * g.gi_n * g.jcb;
  const long long zdim = static_cast<long long>(B) * g.igroups * g.jgroups;
  if (zdim > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = static_cast<size_t>(per_c) * g.cc;

  const T* a = static_cast<const T*>(f1);
  const T* v = static_cast<const T*>(f2);
  T* o = static_cast<T*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int instance =
      stride <= 4 && g.ww <= 32 * stage_cols(stride) ? stride : 0;
  switch (instance) {
    case 1: e = launch<1>(a, v, o, B, g, smem, st); break;
    case 2: e = launch<2>(a, v, o, B, g, smem, st); break;
    case 3: e = launch<3>(a, v, o, B, g, smem, st); break;
    case 4: e = launch<4>(a, v, o, B, g, smem, st); break;
    default: e = launch<0>(a, v, o, B, g, smem, st); break;
  }
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

// f1, f2: (B, C, H, W) contiguous on the current device; out: (B, n*n,
// H, W) of the same type, float32 (_f32) or bf16 (_bf16). Launches on
// `stream` and returns cudaGetLastError() (0 on success); it does not
// synchronise.
int deepof_corr_fwd_f32(const void* f1, const void* f2, void* out, int B,
                        int C, int H, int W, int max_disp, int stride,
                        void* stream) {
  return corr_fwd<float>(f1, f2, out, B, C, H, W, max_disp, stride, stream);
}

int deepof_corr_fwd_bf16(const void* f1, const void* f2, void* out, int B,
                         int C, int H, int W, int max_disp, int stride,
                         void* stream) {
  return corr_fwd<__nv_bfloat16>(f1, f2, out, B, C, H, W, max_disp, stride,
                                 stream);
}

const char* deepof_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
