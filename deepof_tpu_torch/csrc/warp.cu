// Bilinear backward warp and its flow gradient, float32, for sm_90a,
// over up to eight pyramid levels in one launch.
//
// Replaces deepof_tpu/ops/pallas/warp.py::_warp_kernel (the forward,
// behind backward_warp_pallas) and ::_warp_flow_grad_kernel (the flow
// cotangent of its custom VJP). Same functions, per pixel (b, y, x) of
// each level:
//
//   u, v = flow[b, 0, y, x], flow[b, 1, y, x]   (already scaled)
//   fx, fy = floor(u), floor(v);  wx, wy = u - fx, v - fy
//   x0 = clip(x+fx, 0, W-1)   x1 = clip(x+fx+1, 0, W-1)
//   y0 = clip(y+fy, 0, H-1)   y1 = clip(y+fy+1, 0, H-1)
//   (each clipped on its own; wx = 0 where x+fx < 0, wy = 0 where
//   y+fy < 0, as the JAX package's XLA path does: there x1 == x0 and
//   y1 == y0, so the value is unchanged and the flow gradient on that
//   side is exactly zero)
//
// Naming of the four neighbours, as in the Pallas docstring
// (ops/pallas/warp.py:117-121), NOT as in the numpy golden of
// tests/test_warp.py, which swaps b and c:
//   Ia = (y0, x0)   Ib = (y0, x1)   Ic = (y1, x0)   Id = (y1, x1)
//
//   out[b,c,y,x] = (1-wy)[(1-wx) Ia + wx Ib] + wy[(1-wx) Ic + wx Id]
//   du = sum_c g_c ((1-wy)(Ib-Ia) + wy(Id-Ic))
//   dv = sum_c g_c ((1-wx)(Ic-Ia) + wx(Id-Ib))
//
// The gradient is zero through floor and through the clipped indices,
// the a.e. derivative XLA's autodiff gives; it needs no scatter.
//
// Both kernels round every product and sum where their plain PyTorch
// versions (ops/warp.py::backward_warp_reference and
// ::warp_flow_grad_reference, channels summed in ascending order) do, in
// the same order, and contract nothing into a fused multiply-add, so
// each agrees with its plain version bitwise. That matters: the loss's Charbonnier gradient goes as
// |x|^-0.5 of x = 255 (warped - source), a difference of nearly equal
// numbers at some pixels, and amplifies any rounding difference of the
// warped image into the model's gradients.
//
// Any flow value stays in bounds: the floored flow is clamped in float
// to [-(W+1), W+1] (and [-(H+1), H+1]) before the conversion to int, so
// x + (int)fx never overflows for huge or infinite flows. A NaN floor
// maps to 0 first, as in the plain version: its weight stays NaN, so a
// NaN flow gives a NaN output and gradient there, as the JAX package's
// XLA path does. The clamp changes neither the clipped index nor the
// saturation test.
//
// Layout: every tensor is read and written through its own element
// strides (b, c, y, x), so the loss's NHWC views and channels-last
// cotangents arrive without a copy. Image and cotangent are (B, C, H, W)
// views, the flow and the flow cotangent (B, 2, H, W) views; the host
// checks that every offset fits in 32 bits.
//
// What bounds it: bytes, and at these sizes latency. Each input read
// once and each output written once is 32 B per pixel forward (image
// 12, flow 8, out 12 at C = 3) and 40 B per pixel for the gradient,
// against some 30-50 float operations per pixel. The six levels of the
// training loss at batch 4 (192x256 down to 6x8) hold 262,080 pixels:
// 8.4 MB forward, 2.5 us at 3.35 TB/s. That is less than one wave of the
// card, so one launch per direction covers all levels, and what is left
// is latency: a flow load, then the gathers that depend on it.
//
// Design (the TPU kernel sweeps all 2H-1 row offsets with a roll and a
// lane gather, because Mosaic cannot gather across lanes, and takes
// W <= 128 only; here each output pixel gathers its four neighbours
// directly, for any H and W):
//   - one launch over a table of levels, passed by value as a
//     __grid_constant__ parameter; blocks are numbered finest level
//     first, and a block finds its level by a scan of at most 8 entries;
//   - a block is kRows rows (one warp each) of one kTileW-column tile of
//     one (level, b); lane l of a warp owns columns l and l + 32 of the
//     tile, so every load and store of the warp covers 32 neighbouring
//     pixels, and each thread has both pixels' loads in flight at once:
//     all flow loads, then all gathers, then the blend;
//   - 32-bit index math, no 64-bit division;
//   - an instance for C = 3 (the training loss) holds a thread's gathers
//     in registers; the generic instance takes any C, pixel by pixel.
// On the H100 the six training levels take one launch of 6.3 us each way
// with the benchmark's uncorrelated flows of +-5 px, and 3.8 / 4.5 us
// with a smooth flow: where each lane of a warp gathers from its own
// rows, the cache lines a load touches, not the bytes, set the time.
// Giving each thread 4 consecutive pixels (float4 flow loads) made a
// warp's gathers span 128 pixels, and took 7.9 us; 4 pixels 32 apart in
// 4-row blocks, 7.1 us (PERF.md, Findings).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreadsX = 32;  // threads along x in a block: one warp
constexpr int kRows = 8;       // rows in a block: one warp each
constexpr int kPix = 2;        // pixels per thread, kThreadsX apart
constexpr int kTileW = kThreadsX * kPix;

struct View {
  float* p;
  int sb, sc, sy, sx;  // element strides
};

struct Level {
  View image, flow, ct, out;
  int H, W;
  int tiles_x, tiles_y;  // kTileW-column tiles per row, kRows-row tiles
  int first_block;       // blocks of earlier (finer) levels
};

struct Table {
  Level lv[kMaxLevels];
  int n_levels;
  int C;
};

struct Tap {
  int x0, x1, y0, y1;  // clipped coordinates of Ia, Ib, Ic, Id
  float wx, wy;
  bool left, top;  // x + fx < 0, y + fy < 0: saturated, weight zeroed
};

__device__ __forceinline__ Tap bilinear_tap(float u, float v, int x, int y,
                                            int H, int W) {
  float fu = floorf(u);
  float fv = floorf(v);
  Tap t;
  t.wx = __fsub_rn(u, fu);
  t.wy = __fsub_rn(v, fv);
  // a NaN floor maps to 0 before the clamp, as the plain version's
  // nan_to_num does: the index is x (or y), not saturated, so the NaN
  // weight is kept and carries into the output and the gradient
  if (isnan(fu)) fu = 0.f;
  if (isnan(fv)) fv = 0.f;
  const int ix = x + static_cast<int>(
      fminf(fmaxf(fu, -static_cast<float>(W + 1)), static_cast<float>(W + 1)));
  const int iy = y + static_cast<int>(
      fminf(fmaxf(fv, -static_cast<float>(H + 1)), static_cast<float>(H + 1)));
  t.left = ix < 0;
  t.top = iy < 0;
  if (t.left) t.wx = 0.f;
  if (t.top) t.wy = 0.f;
  t.x0 = min(max(ix, 0), W - 1);
  t.x1 = min(max(ix + 1, 0), W - 1);
  t.y0 = min(max(iy, 0), H - 1);
  t.y1 = min(max(iy + 1, 0), H - 1);
  return t;
}

// This thread's level, batch row, image row and first column, and how
// many of its kPix columns (x, x + 32, ...) lie inside the row; false if
// none does.
struct Where {
  int l, b, y, x, n;
};

__device__ __forceinline__ bool locate(const Table& t, Where& w) {
  const int bid = static_cast<int>(blockIdx.x);
  int l = 0;
#pragma unroll
  for (int k = 1; k < kMaxLevels; ++k)
    if (k < t.n_levels && bid >= t.lv[k].first_block) l = k;
  const Level& L = t.lv[l];
  int r = bid - L.first_block;
  const int tx = r % L.tiles_x;
  r /= L.tiles_x;
  w.l = l;
  w.y = (r % L.tiles_y) * kRows + static_cast<int>(threadIdx.y);
  w.b = r / L.tiles_y;
  w.x = tx * kTileW + static_cast<int>(threadIdx.x);
  w.n = min(kPix, (L.W - w.x + kThreadsX - 1) / kThreadsX);
  return w.y < L.H && w.x < L.W;
}

// The taps of this thread's pixels, from their flow; a pixel past the
// row's end gets flow 0 (its clipped taps stay inside the image, and it
// is never stored).
__device__ __forceinline__ void taps(const Level& L, const Where& w,
                                     Tap (&tp)[kPix]) {
  const View& F = L.flow;
  const float* fl = F.p + w.b * F.sb + w.y * F.sy + w.x * F.sx;
  float u[kPix], v[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    u[i] = i < w.n ? __ldg(fl + i * kThreadsX * F.sx) : 0.f;
    v[i] = i < w.n ? __ldg(fl + F.sc + i * kThreadsX * F.sx) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kPix; ++i)
    tp[i] = bilinear_tap(u[i], v[i], w.x + i * kThreadsX, w.y, L.H, L.W);
}

// Ia, Ib, Ic, Id of channel 0 of the image, as offsets from (b, 0, 0, 0)
__device__ __forceinline__ void corners(const View& I, const Tap& tp,
                                        int (&o)[4]) {
  o[0] = tp.y0 * I.sy + tp.x0 * I.sx;
  o[1] = tp.y0 * I.sy + tp.x1 * I.sx;
  o[2] = tp.y1 * I.sy + tp.x0 * I.sx;
  o[3] = tp.y1 * I.sy + tp.x1 * I.sx;
}

// out = (Ia(1-wx))(1-wy) + (Ic(1-wx))wy + (Ib wx)(1-wy) + (Id wx)wy,
// left to right, each product and sum rounded on its own (no fused
// multiply-add), as the plain version computes it
__device__ __forceinline__ float blend(const float (&q)[4], const Tap& tp) {
  const float omx = __fsub_rn(1.f, tp.wx), omy = __fsub_rn(1.f, tp.wy);
  const float s = __fadd_rn(__fmul_rn(__fmul_rn(q[0], omx), omy),
                            __fmul_rn(__fmul_rn(q[2], omx), tp.wy));
  return __fadd_rn(__fadd_rn(s, __fmul_rn(__fmul_rn(q[1], tp.wx), omy)),
                   __fmul_rn(__fmul_rn(q[3], tp.wx), tp.wy));
}

// the flow cotangent's terms of one channel, added to du and dv; each
// product and sum rounded on its own (no fused multiply-add), in the
// order of the plain version (ops/warp.py::warp_flow_grad_reference)
__device__ __forceinline__ void accumulate(const float (&q)[4], float g,
                                           const Tap& tp, float& du,
                                           float& dv) {
  const float omx = __fsub_rn(1.f, tp.wx), omy = __fsub_rn(1.f, tp.wy);
  du = __fadd_rn(du, __fmul_rn(g, __fadd_rn(
                         __fmul_rn(omy, __fsub_rn(q[1], q[0])),
                         __fmul_rn(tp.wy, __fsub_rn(q[3], q[2])))));
  dv = __fadd_rn(dv, __fmul_rn(g, __fadd_rn(
                         __fmul_rn(omx, __fsub_rn(q[2], q[0])),
                         __fmul_rn(tp.wx, __fsub_rn(q[3], q[1])))));
}

// kC = 3: the training loss's images, every gather of the thread loaded
// before the first blend; kC = 0: any channel count, pixel by pixel
template <int kC>
__global__ void __launch_bounds__(kThreadsX * kRows)
warp_fwd_levels_kernel(const __grid_constant__ Table t) {
  Where w;
  if (!locate(t, w)) return;
  const Level& L = t.lv[w.l];
  Tap tp[kPix];
  taps(L, w, tp);
  const View& I = L.image;
  const View& O = L.out;
  const float* img = I.p + w.b * I.sb;
  float* out = O.p + w.b * O.sb + w.y * O.sy + w.x * O.sx;
  if constexpr (kC > 0) {
    float q[kPix][kC][4];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      int o[4];
      corners(I, tp[i], o);
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int k = 0; k < 4; ++k) q[i][c][k] = __ldg(img + c * I.sc + o[k]);
    }
#pragma unroll
    for (int i = 0; i < kPix; ++i)
      if (i < w.n) {
#pragma unroll
        for (int c = 0; c < kC; ++c)
          out[i * kThreadsX * O.sx + c * O.sc] = blend(q[i][c], tp[i]);
      }
  } else {
    for (int i = 0; i < w.n; ++i) {
      int o[4];
      corners(I, tp[i], o);
      for (int c = 0; c < t.C; ++c) {
        const float* p = img + c * I.sc;
        const float q[4] = {__ldg(p + o[0]), __ldg(p + o[1]), __ldg(p + o[2]),
                            __ldg(p + o[3])};
        out[i * kThreadsX * O.sx + c * O.sc] = blend(q, tp[i]);
      }
    }
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreadsX * kRows)
warp_flow_grad_levels_kernel(const __grid_constant__ Table t) {
  Where w;
  if (!locate(t, w)) return;
  const Level& L = t.lv[w.l];
  Tap tp[kPix];
  taps(L, w, tp);
  const View& I = L.image;
  const View& G = L.ct;
  const View& O = L.out;
  const float* img = I.p + w.b * I.sb;
  const float* ct = G.p + w.b * G.sb + w.y * G.sy + w.x * G.sx;
  float du[kPix], dv[kPix];
  if constexpr (kC > 0) {
    float q[kPix][kC][4], g[kPix][kC];
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      int o[4];
      corners(I, tp[i], o);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        g[i][c] = i < w.n ? __ldg(ct + i * kThreadsX * G.sx + c * G.sc) : 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) q[i][c][k] = __ldg(img + c * I.sc + o[k]);
      }
    }
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      du[i] = dv[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        accumulate(q[i][c], g[i][c], tp[i], du[i], dv[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      du[i] = dv[i] = 0.f;
      if (i >= w.n) continue;
      int o[4];
      corners(I, tp[i], o);
      for (int c = 0; c < t.C; ++c) {
        const float* p = img + c * I.sc;
        const float q[4] = {__ldg(p + o[0]), __ldg(p + o[1]), __ldg(p + o[2]),
                            __ldg(p + o[3])};
        accumulate(q, __ldg(ct + i * kThreadsX * G.sx + c * G.sc), tp[i],
                   du[i], dv[i]);
      }
    }
  }
  float* out = O.p + w.b * O.sb + w.y * O.sy + w.x * O.sx;
#pragma unroll
  for (int i = 0; i < kPix; ++i)
    if (i < w.n) {
      // the zeroed weight passes no gradient, as in the plain version's
      // where(): exactly 0 on a saturated side even where the other
      // weight is NaN (for a finite flow the sum there is 0 already)
      out[i * kThreadsX * O.sx] = tp[i].left ? 0.f : du[i];
      out[i * kThreadsX * O.sx + O.sc] = tp[i].top ? 0.f : dv[i];
    }
}

int launch(const void* table, int blocks, void* stream, bool grad) {
  const Table& t = *static_cast<const Table*>(table);
  if (t.n_levels < 1 || t.n_levels > kMaxLevels || t.C < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (grad) {
    if (t.C == 3)
      warp_flow_grad_levels_kernel<3><<<blocks, block, 0, s>>>(t);
    else
      warp_flow_grad_levels_kernel<0><<<blocks, block, 0, s>>>(t);
  } else {
    if (t.C == 3)
      warp_fwd_levels_kernel<3><<<blocks, block, 0, s>>>(t);
    else
      warp_fwd_levels_kernel<0><<<blocks, block, 0, s>>>(t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The tile geometry and the table's size, so that the host's launch plan
// (ops/cuda/warp.py) can check that it matches this build:
// {kThreadsX, kRows, kPix, kMaxLevels, sizeof(Table)}.
void deepof_warp_geometry(int* out) {
  out[0] = kThreadsX;
  out[1] = kRows;
  out[2] = kPix;
  out[3] = kMaxLevels;
  out[4] = static_cast<int>(sizeof(Table));
}

// `table`: a Table filled by the host (views of image, flow and out per
// level; ct unused), `blocks`: the sum over levels of B * tiles_y *
// tiles_x. Launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise.
int deepof_warp_fwd_levels_f32(const void* table, int blocks, void* stream) {
  return launch(table, blocks, stream, false);
}

// As above, with ct (the output cotangent, shaped as the image) and out
// (the flow cotangent, shaped as the flow) = (dL/du, dL/dv).
int deepof_warp_flow_grad_levels_f32(const void* table, int blocks,
                                     void* stream) {
  return launch(table, blocks, stream, true);
}

const char* deepof_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
