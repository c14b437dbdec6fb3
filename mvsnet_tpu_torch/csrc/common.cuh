// Shared helpers for the port's kernels: 8-wide channel loads and stores of
// float32 or bfloat16 data, converted to and from float32 registers, and
// the pieces the direct and transposed convs share (weights staged in
// shared memory, the per-tap multiply-add, the bias + ReLU epilogue).
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

// Data types as the Python wrappers number them.
enum DType { kFloat32 = 0, kBFloat16 = 1 };

}  // namespace mvs
