// FlowNet-C correlation (cost volume) forward, float32, for sm_90a.
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
// FMAs per byte, so it is bound by float32 FMA throughput (exact f32:
// no tensor cores), not by memory.
//
// Design: one block per (batch row b, output row y, tile of TILE_X
// columns, chunk of G displacement rows x JT displacement columns).
// Threads run over x, so every global load of a channel plane is
// coalesced. Channels are walked in chunks of CC: the block stages the
// f1 row tile and the G f2 rows y+dy_i (with the halo the JT column
// offsets need, zero-filled out of bounds) in shared memory, then every
// thread accumulates its G*JT displacements in float32 registers. So f2
// is read from device memory once per chunk of displacements, from
// shared memory for each displacement, and never once per displacement
// from device memory. Speed (register tiling over x, wgmma, TMA) is later
// work: this is the simple, correct form.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 64;  // threads per block, one output column each
constexpr int CC = 16;      // channels staged per shared-memory chunk
constexpr int G = 3;        // displacement rows per block
constexpr int JT = 7;       // displacement columns per block

__global__ void __launch_bounds__(TILE_X)
corr_fwd_f32_kernel(const float* __restrict__ f1,
                    const float* __restrict__ f2,
                    float* __restrict__ out,
                    int C, int H, int W, int n, int stride, int pad,
                    int ichunks, int jchunks) {
  extern __shared__ float smem[];
  const int txw = TILE_X + (JT - 1) * stride;  // f2 window width
  float* f1s = smem;                // [CC][TILE_X]
  float* f2s = smem + CC * TILE_X;  // [CC][G][txw]

  const int tx = threadIdx.x;
  const int x0 = blockIdx.x * TILE_X;
  const int x = x0 + tx;
  const int y = blockIdx.y;
  int z = blockIdx.z;
  const int jc = z % jchunks;
  z /= jchunks;
  const int ic = z % ichunks;
  const int b = z / ichunks;
  const int i0 = ic * G;
  const int j0 = jc * JT;
  const int xw0 = x0 + j0 * stride - pad;  // column of f2s[.][.][0]

  const size_t plane = static_cast<size_t>(H) * W;
  const float* f1b = f1 + static_cast<size_t>(b) * C * plane;
  const float* f2b = f2 + static_cast<size_t>(b) * C * plane;

  float acc[G][JT];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) acc[gi][jj] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    const int cc = min(CC, C - c0);
    __syncthreads();  // the previous chunk's reads are done
    for (int idx = tx; idx < cc * TILE_X; idx += TILE_X) {
      const int c = idx / TILE_X;
      const int xx = x0 + idx % TILE_X;
      f1s[idx] = xx < W ? f1b[(c0 + c) * plane + static_cast<size_t>(y) * W + xx]
                        : 0.f;
    }
    for (int idx = tx; idx < cc * G * txw; idx += TILE_X) {
      const int c = idx / (G * txw);
      const int r = idx % (G * txw);
      const int i = i0 + r / txw;
      const int yy = y + i * stride - pad;
      const int xx = xw0 + r % txw;
      const bool ok = i < n && yy >= 0 && yy < H && xx >= 0 && xx < W;
      f2s[idx] = ok ? f2b[(c0 + c) * plane + static_cast<size_t>(yy) * W + xx]
                    : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < cc; ++c) {
      const float a = f1s[c * TILE_X + tx];
      const float* row = f2s + c * G * txw + tx;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int jj = 0; jj < JT; ++jj)
          acc[gi][jj] = fmaf(a, row[gi * txw + jj * stride], acc[gi][jj]);
    }
  }

  if (x >= W) return;
  const float inv_c = 1.f / static_cast<float>(C);
  float* outb = out + static_cast<size_t>(b) * n * n * plane
                + static_cast<size_t>(y) * W + x;
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int jj = 0; jj < JT; ++jj) {
      const int i = i0 + gi, j = j0 + jj;
      if (i < n && j < n) outb[(i * n + j) * plane] = acc[gi][jj] * inv_c;
    }
}

}  // namespace

extern "C" {

// f1, f2: (B, C, H, W) float32 contiguous on the current device; out:
// (B, n*n, H, W) float32. Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
int deepof_corr_fwd_f32(const void* f1, const void* f2, void* out, int B,
                        int C, int H, int W, int max_disp, int stride,
                        void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || stride <= 0 || max_disp < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = max_disp / stride;
  const int n = 2 * k + 1;
  const int pad = k * stride;
  const int ichunks = (n + G - 1) / G;
  const int jchunks = (n + JT - 1) / JT;
  const long long zdim = static_cast<long long>(B) * ichunks * jchunks;
  if (zdim > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const int txw = TILE_X + (JT - 1) * stride;
  const size_t smem = sizeof(float) * CC * (TILE_X + G * txw);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((W + TILE_X - 1) / TILE_X, H, static_cast<unsigned>(zdim));
  corr_fwd_f32_kernel<<<grid, TILE_X, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<float*>(out), C, H, W, n, stride, pad, ichunks, jchunks);
  return static_cast<int>(cudaGetLastError());
}

const char* deepof_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
