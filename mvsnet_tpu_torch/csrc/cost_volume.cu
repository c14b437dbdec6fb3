// Fused plane-sweep warp + variance cost volume for one batch element.
//
// Replaces the Pallas cost kernels of mvsnet_tpu/ops/pallas/sweep.py
// (_make_cost_kernel_preload_group, _make_cost_kernel_preload and
// _make_cost_kernel, launched at sweep.py:1094, :1322 and :1888), which
// compute one function in three editions.
//
// out[d, y, x, c] = mean_v(f_v^2) - mean_v(f_v)^2 over the reference view
// and the V-1 source views, where f_v is source map v sampled bilinearly,
// with zero fill per tap, at H_vd (x + 0.5, y + 0.5, 1) - 0.5 (the taps of
// common.cuh, which the warp kernels K2 and K3 share). Coordinates,
// weights and the running sums are float32; the output is written once, in
// the input's type. No warped volume of any view ever reaches device memory.
//
// Bound on the H100: bytes. The output (D, h, w, C) is D/V times the size
// of the inputs (64 times at the operating point), and the arithmetic is a few dozen operations per
// output element. The design therefore writes every output element exactly
// once, in 16-byte vectors: one thread owns 8 channels of one (d, y, x), so
// a warp stores 512 (bf16) contiguous bytes, and the four taps of every view
// are 16-byte reads that neighbouring threads share through L1/L2 (the
// source maps, about 8 MB at the operating point, stay resident in L2).
#include "common.cuh"

namespace {

using mvs::bf16;

template <typename T>
__global__ void __launch_bounds__(256)
cost_volume_kernel(const T* __restrict__ ref, const T* __restrict__ views,
                   const float* __restrict__ homs, T* __restrict__ out,
                   int V1, int D, int H, int W, int C) {
  const int G = C / 8;
  const int64_t total = (int64_t)D * H * W * G;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int g = (int)(i % G);
  int64_t p = i / G;
  const int x = (int)(p % W);
  p /= W;
  const int y = (int)(p % H);
  const int d = (int)(p / H);
  const int64_t plane = (int64_t)H * W * C;
  const int64_t off = ((int64_t)y * W + x) * C + g * 8;

  float s[8], s2[8];
  mvs::load8(ref + off, s);
#pragma unroll
  for (int j = 0; j < 8; ++j) s2[j] = s[j] * s[j];

  for (int v = 0; v < V1; ++v) {
    const mvs::Taps t = mvs::project(homs + ((int64_t)v * D + d) * 9, x, y, H, W);
    float val[8];
    mvs::sample8(views + (int64_t)v * plane + g * 8, t, W, C, val);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j] += val[j];
      s2[j] += val[j] * val[j];
    }
  }

  const float nv = (float)(V1 + 1);
  float r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float mean = s[j] / nv;
    r[j] = s2[j] / nv - mean * mean;
  }
  mvs::store8(out + (int64_t)d * plane + off, r);
}

}  // namespace

// ref (H, W, C), views (V1, H, W, C), homs (V1, D, 3, 3) float32,
// out (D, H, W, C); C % 8 == 0, all contiguous. Returns cudaGetLastError().
extern "C" int cost_volume_launch(int dtype, const void* ref, const void* views,
                                  const void* homs, void* out, int V1, int D,
                                  int H, int W, int C, void* stream) {
  if (C % 8 != 0 || V1 < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)D * H * W * (C / 8);
  const int block = 256;
  const int64_t grid = (total + block - 1) / block;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == mvs::kFloat32) {
    cost_volume_kernel<float><<<(unsigned)grid, block, 0, s>>>(
        static_cast<const float*>(ref), static_cast<const float*>(views),
        static_cast<const float*>(homs), static_cast<float*>(out), V1, D, H, W, C);
  } else if (dtype == mvs::kBFloat16) {
    cost_volume_kernel<bf16><<<(unsigned)grid, block, 0, s>>>(
        static_cast<const bf16*>(ref), static_cast<const bf16*>(views),
        static_cast<const float*>(homs), static_cast<bf16*>(out), V1, D, H, W, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cost_volume_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
