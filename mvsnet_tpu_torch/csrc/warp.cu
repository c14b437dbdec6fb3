// All-depth homography warp (K2) and its adjoint, the transposed warp (K3).
//
// K2 replaces the Pallas warp kernels of mvsnet_tpu/ops/pallas/sweep.py
// (_sweep_kernel via pallas_warp_all_depths at sweep.py:1599, and
// _make_warp_kernel_preload_group via _pallas_warp_all_depths_preload at
// :1538): out[d, y, x, c] = img sampled bilinearly, zero fill per tap, at
// H_d (x + 0.5, y + 0.5, 1) - 0.5; float32 blend, one cast to img's type.
// K3 replaces _transpose_kernel via _pallas_warp_transpose (sweep.py:1701):
// the exact adjoint in img, out[tap(d, y, x)] += weight * g[d, y, x, c],
// summed in float32. Both take their taps from common.cuh, as the cost
// volume K1 does, so the three sample identically.
//
// Bound on the H100: bytes. K2 writes D maps for one it reads (192x the
// input at the training point) at a dozen operations per output element,
// so as K1 it writes each output element once in 16-byte vectors: one
// thread owns 8 channels of one (d, y, x), and the taps are 16-byte reads
// that neighbouring threads share through L1/L2.
// K3 reads D cotangent maps and writes one: a scatter. This first kernel
// adds into the float32 output with atomicAdd, so the order of its sums is
// not fixed from run to run. To cut the atomics, a thread owns 8 channels
// of one reference pixel over a segment of depths, walks the depths in
// order and keeps the four taps' sums in registers while the top-left tap
// stays on the same source pixel (neighbouring planes move the projection
// by less than a pixel), flushing them only when it moves.
#include <climits>

#include "common.cuh"

namespace {

using mvs::bf16;

constexpr int kBlock = 256;

template <typename T>
__global__ void __launch_bounds__(kBlock)
warp_kernel(const T* __restrict__ img, const float* __restrict__ homs,
            T* __restrict__ out, int D, int H, int W, int C) {
  const int G = C / 8;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)D * H * W * G) return;
  const int g = (int)(i % G);
  int64_t p = i / G;
  const int x = (int)(p % W);
  p /= W;
  const int y = (int)(p % H);
  const int d = (int)(p / H);
  const mvs::Taps t = mvs::project(homs + (int64_t)d * 9, x, y, H, W);
  float val[8];
  mvs::sample8(img + g * 8, t, W, C, val);
  mvs::store8(out + (((int64_t)d * H + y) * W + x) * C + g * 8, val);
}

// Adds the four taps' sums acc[tap][j] at top-left tap (x0, y0) into out.
__device__ __forceinline__ void flush(float* __restrict__ out, const float acc[4][8],
                                      int x0, int y0, int H, int W, int C) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = y0 + (k >> 1), xx = x0 + (k & 1);
    if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
    float* dst = out + ((int64_t)yy * W + xx) * C;
#pragma unroll
    for (int j = 0; j < 8; ++j) atomicAdd(dst + j, acc[k][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock)
warp_transpose_kernel(const T* __restrict__ g, const float* __restrict__ homs,
                      float* __restrict__ out, int D, int H, int W, int C,
                      int dseg) {
  const int G = C / 8;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)H * W * G) return;
  const int cg = (int)(i % G);
  const int64_t p = i / G;
  const int x = (int)(p % W);
  const int y = (int)(p / W);
  const int d0 = blockIdx.y * dseg;
  const int d1 = min(D, d0 + dseg);
  float* dst = out + cg * 8;

  float acc[4][8];
  int cx = INT_MIN, cy = INT_MIN;
  for (int d = d0; d < d1; ++d) {
    const mvs::Taps t = mvs::project(homs + (int64_t)d * 9, x, y, H, W);
    if (!((t.x0in || t.x1in) && (t.y0in || t.y1in))) continue;   // all taps outside
    if (t.x0 != cx || t.y0 != cy) {
      if (cx != INT_MIN) flush(dst, acc, cx, cy, H, W, C);
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[k][j] = 0.f;
      cx = t.x0;
      cy = t.y0;
    }
    float gv[8];
    mvs::load8(g + (((int64_t)d * H + y) * W + x) * C + cg * 8, gv);
    const float w[4] = {(1.f - t.fy) * (1.f - t.fx), (1.f - t.fy) * t.fx,
                        t.fy * (1.f - t.fx), t.fy * t.fx};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[k][j] = fmaf(w[k], gv[j], acc[k][j]);
  }
  if (cx != INT_MIN) flush(dst, acc, cx, cy, H, W, C);
}

int grid_of(int64_t total, unsigned* grid) {
  const int64_t n = (total + kBlock - 1) / kBlock;
  if (n > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  *grid = (unsigned)(n > 0 ? n : 1);
  return 0;
}

}  // namespace

// img (H, W, C), homs (D, 3, 3) float32, out (D, H, W, C) in img's type;
// C % 8 == 0, all contiguous. Returns cudaGetLastError().
extern "C" int warp_launch(int dtype, const void* img, const void* homs, void* out,
                           int D, int H, int W, int C, void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  unsigned grid;
  if (int e = grid_of((int64_t)D * H * W * (C / 8), &grid)) return e;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(homs);
  if (dtype == mvs::kFloat32) {
    warp_kernel<float><<<grid, kBlock, 0, s>>>(static_cast<const float*>(img), h,
                                               static_cast<float*>(out), D, H, W, C);
  } else if (dtype == mvs::kBFloat16) {
    warp_kernel<bf16><<<grid, kBlock, 0, s>>>(static_cast<const bf16*>(img), h,
                                              static_cast<bf16*>(out), D, H, W, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// g (D, H, W, C) in float32 or bfloat16, homs (D, 3, 3) float32, out
// (H, W, C) float32, zeroed by the caller; the depths are split into
// segments of dseg, one grid row each. C % 8 == 0, all contiguous.
// Returns cudaGetLastError().
extern "C" int warp_transpose_launch(int dtype, const void* g, const void* homs,
                                     void* out, int D, int H, int W, int C, int dseg,
                                     void* stream) {
  if (C % 8 != 0 || dseg < 1) return (int)cudaErrorInvalidValue;
  unsigned gx;
  if (int e = grid_of((int64_t)H * W * (C / 8), &gx)) return e;
  const dim3 grid(gx, (unsigned)((D + dseg - 1) / dseg));
  if (grid.y == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(homs);
  float* o = static_cast<float*>(out);
  if (dtype == mvs::kFloat32) {
    warp_transpose_kernel<float><<<grid, kBlock, 0, s>>>(static_cast<const float*>(g), h,
                                                         o, D, H, W, C, dseg);
  } else if (dtype == mvs::kBFloat16) {
    warp_transpose_kernel<bf16><<<grid, kBlock, 0, s>>>(static_cast<const bf16*>(g), h,
                                                        o, D, H, W, C, dseg);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
