// Group norm of a half-precision map in two kernels: the per-channel
// float64 sums of x and x^2 (stats_kernel), then the normalisation with its
// affine and the ReLU of the layer that follows it (apply_kernel).
//
// Replaces no TPU kernel: the JAX package leaves its group norm
// (mvsnet_tpu/models/layers.py, group_norm_core) to XLA, which fuses it.
// On the card the plain PyTorch version of the port's norm
// (models/layers.py, group_norm_core) makes about ten full passes over
// the map, each a kernel that writes a new tensor (a cast to float32, two
// float64 sums, four float32 elementwise passes, the cast back, the ReLU):
// some 64 bytes of traffic an element and ~20 launches a norm. These two
// kernels compute its half-precision branch bit for bit:
//
//   sums[0, n, c] = sum over the pixels of double(x),
//   sums[1, n, c] = sum over the pixels of double(x * x) (the float32
//                   product of two bf16 or f16 values is exact);
//   per (n, g): S, Q = the sums of the group's C / G channels, in channel
//   order; mean = S / (count * C/G), e2 = Q / (count * C/G) in float64,
//   where a count given on the host is a product with its reciprocal
//   (computed on the host), as PyTorch divides by a host number;
//   var = e2 - mean * mean; both cast to float32;
//   y = ((x - mean) * rsqrtf(var + eps)) * gamma + beta in float32, each
//   operation rounded on its own (no fused multiply-add: PyTorch makes them
//   separate passes), rounded to x's type, then max(y, 0) where relu.
//
// The sums' order differs from PyTorch's reductions, but float64 holds
// such sums far below float32's rounding, so mean and var come out the same
// float32 values (layers.group_norm_core's note); a block of rows whose
// sums are added to the other blocks' between the two kernels gets the
// whole map's statistics.
//
// Bound on the H100: bytes. x is read twice (the sums, then the
// normalisation) and y written once: 6 bytes an element, 942.5 M elements
// in the tower's 31 norms at 5 x 1600x1184, 1.69 ms at 3.35 TB/s. The
// arithmetic is a few float64 adds and float32 operations an element. The
// design:
//  1. Both kernels give a block a run of pixels of one image (grid (B, N),
//     B * N about the blocks the card holds at once: one wave, and no
//     part-filled last wave) and its threads lanes x rows: lane l holds
//     the same VEC channels at every pixel (VEC = 8 where C % 8 == 0:
//     16-byte loads), the rows of a block stride over the run's pixels, so
//     a warp reads and writes contiguous memory and every thread keeps its
//     channels' constants (or sums) in registers. Four pixels' loads are
//     issued before their use.
//  2. The sums spread over many blocks (the first level has N * G = 5
//     groups of 15 M elements): each thread sums into VEC float64
//     registers a sum, the block's rows combine in a fixed tree in shared
//     memory, each block writes its partial sums, and the last block to
//     finish (an integer ticket; no floating-point atomics) adds every
//     block's partials in block order. The ticket resets itself for the
//     next launch. Every order is fixed: two calls are equal bit for bit.
//  3. The normalisation's block first works out the mean and rstd of its
//     image's G groups into shared memory from the float64 sums; the
//     elementwise pass is then four float32 operations and two casts.
#include <cuda_fp16.h>

#include <type_traits>

#include "common.cuh"

namespace {

using mvs::bf16;
using f16 = __half;

constexpr int kThreads = 256;
constexpr int kUnroll = 4;              // pixels a thread loads before it uses them
constexpr int kMaxGroups = 2048;        // C <= kThreads * 8
enum DType { kBFloat16 = 1, kFloat16 = 2 };

template <typename T> struct Bits;
template <> struct Bits<bf16> {
  static __device__ __forceinline__ float load(unsigned short u) {
    return __bfloat162float(__ushort_as_bfloat16(u));
  }
  static __device__ __forceinline__ unsigned short bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
template <> struct Bits<f16> {
  static __device__ __forceinline__ float load(unsigned short u) {
    return __half2float(__ushort_as_half(u));
  }
  static __device__ __forceinline__ unsigned short bits(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// VEC 16-bit values moved as one load or store
template <int VEC> struct Raw;
template <> struct Raw<8> { using type = uint4; };
template <> struct Raw<4> { using type = uint2; };
template <> struct Raw<2> { using type = unsigned int; };
template <> struct Raw<1> { using type = unsigned short; };

template <int VEC> union Pack {
  typename Raw<VEC>::type raw;
  unsigned short h[VEC];
};

template <int VEC, typename T>
__device__ __forceinline__ typename Raw<VEC>::type load_raw(const T* p) {
  return __ldg(reinterpret_cast<const typename Raw<VEC>::type*>(p));
}

// x: N images of P pixels of C channels; grid (B, N), blockDim.x = lanes *
// rows with lanes = C / VEC; block b of image n sums the pixels
// [b * span, min(P, (b + 1) * span)). part (2, N, B, C) and sums (2, N, C)
// float64; ticket one counter, 0 between launches.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, double* __restrict__ part, double* __restrict__ sums,
             unsigned int* __restrict__ ticket, int64_t P, int C, int64_t span) {
  __shared__ double red[2][kThreads * VEC];
  __shared__ bool last;
  const int lanes = C / VEC, rows = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, row = threadIdx.x / lanes;
  const int n = blockIdx.y, N = gridDim.y, b = blockIdx.x, B = gridDim.x;
  const int64_t end = (int64_t)(b + 1) * span, p1 = end < P ? end : P;
  const T* xn = x + (int64_t)n * P * C + lane * VEC;

  // x^2 as a fused multiply-add of the float64 value: its product is exact,
  // so it rounds once, as the sum of the exact float32 square does
  double s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.0;
  for (int64_t p = (int64_t)b * span + row; p < p1; p += (int64_t)kUnroll * rows) {
    Pack<VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * rows < p1)
        v[u].raw = load_raw<VEC>(xn + (p + u * rows) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * rows < p1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const double d = (double)Bits<T>::load(v[u].h[i]);
          s[i] += d;
          q[i] = fma(d, d, q[i]);
        }
      }
  }

  // the block's rows, added in a fixed tree: row r takes row r + h
  const int t = threadIdx.x * VEC;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[0][t + i] = s[i];
    red[1][t + i] = q[i];
  }
  __syncthreads();
  int h = 1;
  while (2 * h < rows) h *= 2;
  for (; h > 0; h >>= 1) {
    if (row < h && row + h < rows) {
      const int o = t + h * lanes * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += red[0][o + i];
        q[i] += red[1][o + i];
        red[0][t + i] = s[i];
        red[1][t + i] = q[i];
      }
    }
    __syncthreads();
  }
  if (row == 0) {
    double* ps = part + ((int64_t)n * B + b) * C + lane * VEC;
    double* pq = ps + (int64_t)N * B * C;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ps[i] = s[i];
      pq[i] = q[i];
    }
  }

  // the last block adds every block's partials, in block order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == (unsigned int)(B * N - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < 2 * N * C; o += blockDim.x) {
    const double* src = part + (int64_t)(o / C) * B * C + o % C;   // o = (k * N + n) * C + c
    double a = __ldcg(src);
#pragma unroll 8
    for (int j = 1; j < B; ++j) a += __ldcg(src + (int64_t)j * C);
    sums[o] = a;
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// x, y: N images of P pixels of C channels; grid (B, N), block shape as
// stats_kernel's. sums (2, N, C) float64; count one float64 on the device,
// or null and inv_count = 1 / (pixels * C / G); gamma, beta (C) float32.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const double* __restrict__ sums,
             const double* __restrict__ count, double inv_count,
             const float* __restrict__ gamma, const float* __restrict__ beta,
             T* __restrict__ y, int64_t P, int C, int G, float eps, int relu, int64_t span) {
  __shared__ float mean_s[kMaxGroups], rstd_s[kMaxGroups];
  const int n = blockIdx.y, N = gridDim.y, cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    const double* s = sums + (int64_t)n * C + g * cg;
    const double* q = s + (int64_t)N * C;
    double S = s[0], Q = q[0];
    for (int j = 1; j < cg; ++j) {
      S += s[j];
      Q += q[j];
    }
    double mean, e2;
    if (count != nullptr) {
      const double d = __dmul_rn(count[0], (double)cg);
      mean = __ddiv_rn(S, d);
      e2 = __ddiv_rn(Q, d);
    } else {
      mean = __dmul_rn(S, inv_count);
      e2 = __dmul_rn(Q, inv_count);
    }
    mean_s[g] = __double2float_rn(mean);
    rstd_s[g] = rsqrtf(__fadd_rn(__double2float_rn(__dsub_rn(e2, __dmul_rn(mean, mean))), eps));
  }
  __syncthreads();

  const int lanes = C / VEC, rows = blockDim.x / lanes;
  const int lane = threadIdx.x % lanes, row = threadIdx.x / lanes, c0 = lane * VEC;
  float mu[VEC], rs[VEC], ga[VEC], be[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    mu[i] = mean_s[(c0 + i) / cg];
    rs[i] = rstd_s[(c0 + i) / cg];
    ga[i] = __ldg(gamma + c0 + i);
    be[i] = __ldg(beta + c0 + i);
  }
  const int64_t off = (int64_t)n * P * C + c0;
  const int64_t end = (int64_t)(blockIdx.x + 1) * span, p1 = end < P ? end : P;
  for (int64_t p = (int64_t)blockIdx.x * span + row; p < p1; p += (int64_t)kUnroll * rows) {
    Pack<VEC> v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * rows < p1) v[u].raw = load_raw<VEC>(x + off + (p + u * rows) * C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * rows < p1) {
        Pack<VEC> o;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float xi = Bits<T>::load(v[u].h[i]);
          const float r = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xi, mu[i]), rs[i]), ga[i]),
                                    be[i]);
          unsigned short h = Bits<T>::bits(r);
          if (relu) {
            const float f = Bits<T>::load(h);
            if (!(f != f)) h = Bits<T>::bits(fmaxf(f, 0.0f));   // NaN stays, as PyTorch's
          }
          o.h[i] = h;
        }
        *reinterpret_cast<typename Raw<VEC>::type*>(y + off + (p + u * rows) * C) = o.raw;
      }
  }
}

template <typename T, int VEC>
int launch_stats(const void* x, void* part, void* sums, void* ticket, int N, int64_t P, int C,
                 int B, int64_t span, cudaStream_t s) {
  const int lanes = C / VEC;
  stats_kernel<T, VEC><<<dim3((unsigned)B, (unsigned)N), lanes * (kThreads / lanes), 0, s>>>(
      static_cast<const T*>(x), static_cast<double*>(part), static_cast<double*>(sums),
      static_cast<unsigned int*>(ticket), P, C, span);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_apply(const void* x, const void* sums, const void* count, double inv_count,
                 const void* gamma, const void* beta, void* y, int N, int64_t P, int C, int G,
                 float eps, int relu, int B, int64_t span, cudaStream_t s) {
  const int lanes = C / VEC;
  apply_kernel<T, VEC><<<dim3((unsigned)B, (unsigned)N), lanes * (kThreads / lanes), 0, s>>>(
      static_cast<const T*>(x), static_cast<const double*>(sums),
      static_cast<const double*>(count), inv_count, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), P, C, G, eps, relu, span);
  return (int)cudaGetLastError();
}

// Blocks of each kernel that the device holds at once for C channels read
// VEC at a time: its SMs times the blocks an SM takes at that block size.
template <typename T, int VEC>
int capacity(int C, int* stats_blocks, int* apply_blocks) {
  const int lanes = C / VEC, threads = lanes * (kThreads / lanes);
  int dev = 0, sms = 0, a = 0, b = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, stats_kernel<T, VEC>, threads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, apply_kernel<T, VEC>, threads, 0);
  *stats_blocks = a * sms;
  *apply_blocks = b * sms;
  return (int)e;
}

// The sizes both kernels take: VEC one of 8, 4, 2, 1 dividing C, C / VEC
// lanes within a block, G dividing C, a run of at least one pixel.
bool sizes_ok(int vec, int N, int64_t P, int C, int B, int64_t span) {
  return (vec == 8 || vec == 4 || vec == 2 || vec == 1) && C >= 1 && C % vec == 0 &&
         C / vec <= kThreads && N >= 1 && N <= 65535 && P >= 1 && B >= 1 && span >= 1 &&
         (int64_t)B * span >= P;
}

template <typename F>
int by_vec(int vec, F&& f) {
  switch (vec) {
    case 8: return f(std::integral_constant<int, 8>());
    case 4: return f(std::integral_constant<int, 4>());
    case 2: return f(std::integral_constant<int, 2>());
    default: return f(std::integral_constant<int, 1>());
  }
}

}  // namespace

// x (N, P, C) bf16 (dtype 1) or f16 (dtype 2), 2 * vec-byte aligned; part
// (2, N, B, C) and sums (2, N, C) float64; ticket one zeroed unsigned int
// kept for this stream. Returns cudaGetLastError().
extern "C" int group_norm_stats_launch(int dtype, int vec, const void* x, void* part, void* sums,
                                       void* ticket, int N, int64_t P, int C, int B,
                                       int64_t span, void* stream) {
  if (!sizes_ok(vec, N, P, C, B, span) || (int64_t)B * N >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto go = [&](auto v) {
    constexpr int V = decltype(v)::value;
    return dtype == kBFloat16 ? launch_stats<bf16, V>(x, part, sums, ticket, N, P, C, B, span, s)
                              : launch_stats<f16, V>(x, part, sums, ticket, N, P, C, B, span, s);
  };
  if (dtype != kBFloat16 && dtype != kFloat16) return (int)cudaErrorInvalidValue;
  return by_vec(vec, go);
}

// x, y (N, P, C) bf16 or f16; sums (2, N, C) float64; count one float64 on
// the device or null (then inv_count); gamma, beta (C) float32; G divides C.
extern "C" int group_norm_apply_launch(int dtype, int vec, const void* x, const void* sums,
                                       const void* count, double inv_count, const void* gamma,
                                       const void* beta, void* y, int N, int64_t P, int C, int G,
                                       float eps, int relu, int B, int64_t span, void* stream) {
  if (!sizes_ok(vec, N, P, C, B, span) || G < 1 || G > kMaxGroups || C % G != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto go = [&](auto v) {
    constexpr int V = decltype(v)::value;
    return dtype == kBFloat16
               ? launch_apply<bf16, V>(x, sums, count, inv_count, gamma, beta, y, N, P, C, G, eps,
                                       relu, B, span, s)
               : launch_apply<f16, V>(x, sums, count, inv_count, gamma, beta, y, N, P, C, G, eps,
                                      relu, B, span, s);
  };
  if (dtype != kBFloat16 && dtype != kFloat16) return (int)cudaErrorInvalidValue;
  return by_vec(vec, go);
}

// The blocks of each kernel the current device holds at once (`capacity`).
extern "C" int group_norm_capacity(int dtype, int vec, int C, int* stats_blocks,
                                   int* apply_blocks) {
  if ((dtype != kBFloat16 && dtype != kFloat16) || !sizes_ok(vec, 1, 1, C, 1, 1))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto v) {
    constexpr int V = decltype(v)::value;
    return dtype == kBFloat16 ? capacity<bf16, V>(C, stats_blocks, apply_blocks)
                              : capacity<f16, V>(C, stats_blocks, apply_blocks);
  };
  return by_vec(vec, go);
}

extern "C" const char* group_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
