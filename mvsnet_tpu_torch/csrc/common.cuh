// Shared helpers for the port's kernels: 8-wide channel loads and stores of
// float32 or bfloat16 data, converted to and from float32 registers (and
// the cache-hinted loads and streaming stores of the sampling kernels), the
// pieces the direct and transposed convs share (weights staged in shared
// memory, the per-tap multiply-add, the bias + ReLU epilogue), and the
// homography projection, bilinear taps and tap-table entries of the cost
// volume and warp kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mvs {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Eight consecutive elements; p must be 16-byte aligned (bf16) or 32-byte
// aligned (float32), which holds for channel offsets that are multiples of 8.
__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* __restrict__ p, float v[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// An L2 cache policy that keeps the lines it loads ahead of evict-normal and
// evict-first data (the createpolicy instruction, sm_80 and later).
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// 16 bytes through the read-only path under an L2 cache policy where
// `pred` holds, else 16 zero bytes: one predicated load, no branch (p need
// not be a valid address where pred is false).
__device__ __forceinline__ uint4 ldg_policy_if(const void* p, bool pred, uint64_t policy) {
  uint4 r;
  asm("{\n"
      "  .reg .pred q;\n"
      "  setp.ne.b32 q, %5, 0;\n"
      "  mov.b32 %0, 0;\n"
      "  mov.b32 %1, 0;\n"
      "  mov.b32 %2, 0;\n"
      "  mov.b32 %3, 0;\n"
      "  @q ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %6;\n"
      "}\n"
      : "=&r"(r.x), "=&r"(r.y), "=&r"(r.z), "=&r"(r.w)
      : "l"(p), "r"((int)pred), "l"(policy));
  return r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies (cp.async, sm_80 and later): 16 bytes global ->
// shared; bytes = 0 writes 16 zero bytes instead.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// store8 with the streaming (evict-first) hint: data written once and not
// read again by this kernel.
__device__ __forceinline__ void store8_streaming(float* p, const float v[8]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcs(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void store8_streaming(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  __stcs(reinterpret_cast<uint4*>(p), u);
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(bf16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// acc[c] += xv * wrow[c] for c < COT; wrow is a float32 row in shared
// memory that every thread of the block reads at once (a broadcast).
template <int COT>
__device__ __forceinline__ void fma_row(float acc[COT], float xv,
                                        const float* __restrict__ wrow) {
  if constexpr (COT % 4 == 0) {
#pragma unroll
    for (int c = 0; c < COT; c += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(wrow + c);
      acc[c] = fmaf(xv, w4.x, acc[c]);
      acc[c + 1] = fmaf(xv, w4.y, acc[c + 1]);
      acc[c + 2] = fmaf(xv, w4.z, acc[c + 2]);
      acc[c + 3] = fmaf(xv, w4.w, acc[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < COT; ++c) acc[c] = fmaf(xv, wrow[c], acc[c]);
  }
}

// Stage w[r, co0:co0+COT] for r < rows (w is (rows, Cout) in T) into
// shared memory as float32 rows of COT, then wait for the whole block.
template <typename T, int COT>
__device__ __forceinline__ void stage_weights(const T* __restrict__ w, float* wsm,
                                              int rows, int Cout, int co0) {
  for (int i = threadIdx.x; i < rows * COT; i += blockDim.x) {
    const int r = i / COT, c = i - r * COT;
    wsm[i] = to_float(w[(int64_t)r * Cout + co0 + c]);
  }
  __syncthreads();
}

// One kernel tap: acc += x[ci] * wtap[ci, :] over the Cin channels at xp,
// in 16-byte vectors of 8 channels when Cin allows it.
template <typename T, int COT>
__device__ __forceinline__ void accumulate_tap(float acc[COT], const T* __restrict__ xp,
                                               const float* __restrict__ wtap, int Cin) {
  if ((Cin & 7) == 0) {
    for (int ci = 0; ci < Cin; ci += 8) {
      float xv[8];
      load8(xp + ci, xv);
#pragma unroll
      for (int j = 0; j < 8; ++j) fma_row<COT>(acc, xv[j], wtap + (ci + j) * COT);
    }
  } else {
    for (int ci = 0; ci < Cin; ++ci) fma_row<COT>(acc, to_float(xp[ci]), wtap + ci * COT);
  }
}

// Epilogue on the float32 sums: + bias[co0 + c] (bias may be null), ReLU
// when relu != 0, one cast, COT channels stored at dst.
template <typename T, int COT>
__device__ __forceinline__ void epilogue(float acc[COT], const float* __restrict__ bias,
                                         int co0, int relu, T* __restrict__ dst) {
#pragma unroll
  for (int c = 0; c < COT; ++c) {
    const float v = acc[c] + (bias != nullptr ? bias[co0 + c] : 0.f);
    acc[c] = relu ? fmaxf(v, 0.f) : v;
  }
  if constexpr (COT == 8) {
    store8(dst, acc);
  } else {
#pragma unroll
    for (int c = 0; c < COT; ++c) dst[c] = from_float<T>(acc[c]);
  }
}

// The four bilinear taps of reference pixel (x, y) in a source map of H x W
// pixels, shared by the cost volume (K1), the warp (K2) and its adjoint
// (K3) so that all three sample identically: the homography h (row-major
// 3x3, float32) acts on image coordinates (pixel centres at +0.5), |w| <
// 1e-7 is pushed out to +-1e-7, and the tap index is clamped to [-2, W]
// (resp. H) before the int conversion, which keeps far-off projections
// defined: every tap the clamp moves was outside the map and stays there.
struct Taps {
  int x0, y0;     // top-left tap
  float fx, fy;   // weights of the right and lower taps
  bool x0in, x1in, y0in, y1in;
};

// The taps of the homogeneous source point (u, q, w).
__device__ __forceinline__ Taps taps_at(float u, float q, float w, int H, int W) {
  if (fabsf(w) < 1e-7f) w = (w < 0.f) ? -1e-7f : 1e-7f;
  const float sx = u / w - 0.5f;
  const float sy = q / w - 0.5f;
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  Taps t;
  t.fx = sx - x0f;
  t.fy = sy - y0f;
  t.x0 = (int)fminf(fmaxf(x0f, -2.f), (float)W);
  t.y0 = (int)fminf(fmaxf(y0f, -2.f), (float)H);
  t.x0in = t.x0 >= 0 && t.x0 < W;
  t.x1in = t.x0 + 1 >= 0 && t.x0 + 1 < W;
  t.y0in = t.y0 >= 0 && t.y0 < H;
  t.y1in = t.y0 + 1 >= 0 && t.y0 + 1 < H;
  return t;
}

__device__ __forceinline__ Taps project(const float* __restrict__ h, int x, int y,
                                        int H, int W) {
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const float u = h[0] * px + h[1] * py + h[2];
  const float q = h[3] * px + h[4] * py + h[5];
  const float w = h[6] * px + h[7] * py + h[8];
  return taps_at(u, q, w, H, W);
}

// The taps of reference pixel (x, y) on the plane of depth d under a
// projection [M | b] (row-major 3x4, float32; the per-pixel cost volume's):
// (u, q, w) = d M (x + 0.5, y + 0.5, 1) + b, sampled as `project` samples.
__device__ __forceinline__ Taps project_depth(const float* __restrict__ mb, float d, int x,
                                              int y, int H, int W) {
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const float u = d * (mb[0] * px + mb[1] * py + mb[2]) + mb[3];
  const float q = d * (mb[4] * px + mb[5] * py + mb[6]) + mb[7];
  const float w = d * (mb[8] * px + mb[9] * py + mb[10]) + mb[11];
  return taps_at(u, q, w, H, W);
}

// The bilinear blend of the four taps' values (zero where a tap is outside
// the map), float32: the one arithmetic of every sampling kernel.
__device__ __forceinline__ void blend8(const Taps& t, const float v00[8], const float v01[8],
                                       const float v10[8], const float v11[8], float val[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float top = (1.f - t.fx) * v00[j] + t.fx * v01[j];
    const float bot = (1.f - t.fx) * v10[j] + t.fx * v11[j];
    val[j] = (1.f - t.fy) * top + t.fy * bot;
  }
}

// Bilinear sample of 8 channels at the taps, zero fill per tap, float32:
// img points at channel 0 of the group in an (H, W, C) map.
template <typename T>
__device__ __forceinline__ void sample8(const T* __restrict__ img, const Taps& t, int W,
                                        int C, float val[8]) {
  float v00[8], v01[8], v10[8], v11[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v00[j] = v01[j] = v10[j] = v11[j] = 0.f;
  if (t.y0in && t.x0in) load8(img + ((int64_t)t.y0 * W + t.x0) * C, v00);
  if (t.y0in && t.x1in) load8(img + ((int64_t)t.y0 * W + t.x0 + 1) * C, v01);
  if (t.y1in && t.x0in) load8(img + ((int64_t)(t.y0 + 1) * W + t.x0) * C, v10);
  if (t.y1in && t.x1in) load8(img + ((int64_t)(t.y0 + 1) * W + t.x0 + 1) * C, v11);
  blend8(t, v00, v01, v10, v11, val);
}

// Eight elements as raw 16-byte vectors, loaded where `in` holds under an
// L2 cache policy (zero where it does not: `ldg_policy_if`) and converted
// to float32 only where they are blended, so that a pixel's four taps are
// in flight in few registers.
template <typename T> struct Raw8;
template <> struct Raw8<bf16> {
  uint4 v;
  __device__ __forceinline__ void load_if(const bf16* p, bool in, uint64_t pol) {
    v = ldg_policy_if(p, in, pol);
  }
  __device__ __forceinline__ void to_float(float f[8]) const {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Raw8<float> {
  uint4 v[2];
  __device__ __forceinline__ void load_if(const float* p, bool in, uint64_t pol) {
    v[0] = ldg_policy_if(p, in, pol);
    v[1] = ldg_policy_if(p + 4, in, pol);
  }
  __device__ __forceinline__ void to_float(float f[8]) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      f[4 * i] = __uint_as_float(v[i].x);
      f[4 * i + 1] = __uint_as_float(v[i].y);
      f[4 * i + 2] = __uint_as_float(v[i].z);
      f[4 * i + 3] = __uint_as_float(v[i].w);
    }
  }
};

// One entry of a sampling kernel's tap table (K1, K2): reference pixel
// (x, y) projected once by `project`, as the offset of its top-left tap in
// an (H, W, C) map plus `base`, which of the four taps lie inside the map
// (bits 00, 01, 10, 11), and fx, fy as bits. 32-bit offsets: the launchers
// check that the maps they index stay under 2^31 elements.
__device__ __forceinline__ int4 tap_entry(const Taps& t, int W, int C, int base) {
  const int in = (t.y0in && t.x0in) | (t.y0in && t.x1in) << 1 | (t.y1in && t.x0in) << 2 |
                 (t.y1in && t.x1in) << 3;
  return make_int4(base + (t.y0 * W + t.x0) * C, in, __float_as_int(t.fx),
                   __float_as_int(t.fy));
}

__device__ __forceinline__ int4 tap_record(const float* __restrict__ h, int x, int y, int H,
                                           int W, int C, int base) {
  return tap_entry(project(h, x, y, H, W), W, C, base);
}

// The same entry for pixel (x, y) at depth d under [M | b] (`project_depth`).
__device__ __forceinline__ int4 pixel_tap_record(const float* __restrict__ mb, float d, int x,
                                                 int y, int H, int W, int C, int base) {
  return tap_entry(project_depth(mb, d, x, y, H, W), W, C, base);
}

// The blend of a table entry's four taps, 8 channels: img points at the
// channel group in the maps the entry's offset indexes; each tap is a
// predicated 16-byte load (zero fill without a branch) under `pol`.
template <typename T>
__device__ __forceinline__ void sample_record(const T* __restrict__ img, int4 rec, int W, int C,
                                              uint64_t pol, float val[8]) {
  const T* p = img + rec.x;
  Raw8<T> tap[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    tap[k].load_if(p + (k >> 1) * W * C + (k & 1) * C, rec.y >> k & 1, pol);
  Taps t;
  t.fx = __int_as_float(rec.z);
  t.fy = __int_as_float(rec.w);
  float v00[8], v01[8], v10[8], v11[8];
  tap[0].to_float(v00);
  tap[1].to_float(v01);
  tap[2].to_float(v10);
  tap[3].to_float(v11);
  blend8(t, v00, v01, v10, v11, val);
}

// Data types as the Python wrappers number them.
enum DType { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace mvs
