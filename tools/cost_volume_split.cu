// The cost-volume kernel's first design (one thread per (depth, row,
// pixel, 8-channel group), each projecting its own taps, depth the slowest
// index), in three
// modes, for tools/cost_volume_split.py: 0 as it was, 1 store-only (no
// projection, no source-map load), 2 loads-only (every projection and load,
// but a store that never happens). Not part of the port: a measurement of
// where the old design's time went.
#include "../mvsnet_tpu_torch/csrc/common.cuh"

using mvs::bf16;

template <int MODE>
__global__ void __launch_bounds__(256)
first_cost_kernel(const bf16* __restrict__ ref, const bf16* __restrict__ views,
                const float* __restrict__ homs, bf16* __restrict__ out, int V1, int D, int H,
                int W, int C) {
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
  for (int j = 0; j < 8; ++j) s2[j] = s[j] * s[j];
  if (MODE != 1) {
    for (int v = 0; v < V1; ++v) {
      const mvs::Taps t = mvs::project(homs + ((int64_t)v * D + d) * 9, x, y, H, W);
      float val[8];
      mvs::sample8(views + (int64_t)v * plane + g * 8, t, W, C, val);
      for (int j = 0; j < 8; ++j) {
        s[j] += val[j];
        s2[j] += val[j] * val[j];
      }
    }
  }
  const float nv = (float)(V1 + 1);
  float r[8];
  for (int j = 0; j < 8; ++j) {
    const float mean = s[j] / nv;
    r[j] = s2[j] / nv - mean * mean;
  }
  if (MODE == 2 && !(r[0] == 1234.5f && r[1] == -1234.5f)) return;
  mvs::store8(out + (int64_t)d * plane + off, r);
}

// bf16 ref (H, W, C), views (V1, H, W, C), homs (V1, D, 3, 3), out (D, H, W, C)
extern "C" int first_cost(int mode, const void* ref, const void* views, const void* homs,
                        void* out, int V1, int D, int H, int W, int C, void* stream) {
  const int64_t total = (int64_t)D * H * W * (C / 8);
  const unsigned grid = (unsigned)((total + 255) / 256);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto r = static_cast<const bf16*>(ref);
  auto v = static_cast<const bf16*>(views);
  auto h = static_cast<const float*>(homs);
  auto o = static_cast<bf16*>(out);
  if (mode == 0) first_cost_kernel<0><<<grid, 256, 0, s>>>(r, v, h, o, V1, D, H, W, C);
  else if (mode == 1) first_cost_kernel<1><<<grid, 256, 0, s>>>(r, v, h, o, V1, D, H, W, C);
  else if (mode == 2) first_cost_kernel<2><<<grid, 256, 0, s>>>(r, v, h, o, V1, D, H, W, C);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
