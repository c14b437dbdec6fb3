// Weight gradient of a channels-last "SAME" convolution of rank 2 or 3 (K4w).
//
// Replaces the Pallas weight-gradient kernels of
// mvsnet_tpu/ops/pallas/conv3d.py (_make_kernel_dks1 via _pallas_wgrad_s1
// at conv3d.py:1185, _make_kernel_dks2 via _pallas_wgrad_s2 at :1318), and
// also serves the weight gradients the JAX package leaves to XLA: the 2D
// convs (the KD = 1 case over a depth of 1) and, with the roles of input
// and cotangent swapped, the transposed convs.
//
//   dk[t, ci, co] = sum_{b, out} x[b, in(out, t), ci] * g[b, out, co],
//   in(out, t) = out * stride - pad_lo + t per axis, zero outside the input,
//
// float32 products and sums; dk is (KD, KH, KW, Cin, Cout) float32.
//
// Bound on the H100: at the training point's largest layer (3dconv0_1:
// 3.7 M output voxels, 27 taps, 32 -> 8 channels) operations on the
// tensor cores' rate and bytes are close; on the CUDA cores, where this
// first kernel runs, operations. Each tap's gradient is a matrix product
// (Cin x N) x (N x Cout) with N, the output voxels, in the millions and
// Cin, Cout at most 128: a split-K product. Pass 1 gives every block one
// tap and one contiguous range of output voxels; it stages P rows of the
// tap's input (gathered) and of g in shared memory as float32, and each
// thread keeps a TI x TO tile of dk (up to kMaxTiles of them) in registers;
// when dk has fewer tiles than the block has threads, the rows are split
// among groups of threads too, and the groups' sums are added in shared
// memory in a fixed order. Every block writes its partial dk to a float32
// workspace; pass 2 adds the partials over the ranges, in order. No
// atomics: the result is the same from run to run.
#include "common.cuh"

namespace {

using mvs::bf16;

constexpr int kThreads = 256;
constexpr int kMaxTiles = 4;

template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, const int64_t* offs,
                                           float* dst, int P, int C) {
  // dst[r, c] = src[offs[r] + c] for r < P (0 where offs[r] < 0)
  if ((C & 7) == 0) {
    const int G = C / 8;
    for (int e = threadIdx.x; e < P * G; e += kThreads) {
      const int r = e / G, c = (e - r * G) * 8;
      float v[8];
      if (offs[r] >= 0) {
        mvs::load8(src + offs[r] + c, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      mvs::store8(dst + r * C + c, v);
    }
  } else {
    for (int e = threadIdx.x; e < P * C; e += kThreads) {
      const int r = e / C, c = e - r * C;
      dst[e] = offs[r] >= 0 ? mvs::to_float(src[offs[r] + c]) : 0.f;
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float v[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

template <typename T, int TI, int TO>
__global__ void __launch_bounds__(kThreads)
wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     float* __restrict__ ws, int B, int Di, int Hi, int Wi, int Cin,
                     int Do, int Ho, int Wo, int Cout, int KH, int KW, int sd, int sh,
                     int sw, int pd, int ph, int pw, int P, int64_t per_split) {
  extern __shared__ float4 smem4[];
  int64_t* xoff = reinterpret_cast<int64_t*>(smem4);   // [P] input row offsets
  int64_t* goff = xoff + P;                             // [P] cotangent row offsets
  float* xs = reinterpret_cast<float*>(goff + P);       // [P][Cin]
  float* gs = xs + P * Cin;                             // [P][Cout]

  const int tap = blockIdx.y;
  const int kd = tap / (KH * KW), kh = (tap / KW) % KH, kw = tap % KW;
  const int64_t N = (int64_t)B * Do * Ho * Wo;
  const int64_t r0 = (int64_t)blockIdx.x * per_split;
  const int64_t r1 = r0 + per_split < N ? r0 + per_split : N;

  const int NTO = Cout / TO, NT = (Cin / TI) * NTO;
  const int L = NT < kThreads ? NT : kThreads;
  const int S = kThreads / L;
  const int lane = threadIdx.x % L, rs = threadIdx.x / L;
  const bool active = rs < S;

  float acc[kMaxTiles][TI][TO];
#pragma unroll
  for (int m = 0; m < kMaxTiles; ++m)
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int o = 0; o < TO; ++o) acc[m][i][o] = 0.f;

  for (int64_t base = r0; base < r1; base += P) {
    const int n = (int)(r1 - base < P ? r1 - base : P);
    __syncthreads();   // the previous rows are consumed
    for (int r = threadIdx.x; r < P; r += kThreads) {
      int64_t xo = -1, go = -1;
      if (r < n) {
        int64_t q = base + r;
        go = q * Cout;
        const int ox = (int)(q % Wo);
        q /= Wo;
        const int oy = (int)(q % Ho);
        q /= Ho;
        const int oz = (int)(q % Do);
        const int b = (int)(q / Do);
        const int iz = oz * sd - pd + kd, iy = oy * sh - ph + kh, ix = ox * sw - pw + kw;
        if (iz >= 0 && iz < Di && iy >= 0 && iy < Hi && ix >= 0 && ix < Wi)
          xo = ((((int64_t)b * Di + iz) * Hi + iy) * Wi + ix) * Cin;
      }
      xoff[r] = xo;
      goff[r] = go;
    }
    __syncthreads();
    stage_rows<T>(x, xoff, xs, P, Cin);
    stage_rows<T>(g, goff, gs, P, Cout);
    __syncthreads();
    if (active) {
      for (int r = rs; r < n; r += S) {
        const float* xr = xs + r * Cin;
        const float* gr = gs + r * Cout;
#pragma unroll
        for (int m = 0; m < kMaxTiles; ++m) {
          const int tile = lane + m * L;
          if (tile < NT) {
            float xv[TI], gv[TO];
            load_row<TI>(xr + (tile / NTO) * TI, xv);
            load_row<TO>(gr + (tile % NTO) * TO, gv);
#pragma unroll
            for (int i = 0; i < TI; ++i)
#pragma unroll
              for (int o = 0; o < TO; ++o) acc[m][i][o] = fmaf(xv[i], gv[o], acc[m][i][o]);
          }
        }
      }
    }
  }

  // the row groups' sums, added in a fixed order
  const int E = Cin * Cout;
  float* red = reinterpret_cast<float*>(smem4);   // [S][E]
  __syncthreads();
  if (active) {
#pragma unroll
    for (int m = 0; m < kMaxTiles; ++m) {
      const int tile = lane + m * L;
      if (tile < NT) {
        const int ci0 = (tile / NTO) * TI, co0 = (tile % NTO) * TO;
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
          for (int o = 0; o < TO; ++o) red[rs * E + (ci0 + i) * Cout + co0 + o] = acc[m][i][o];
      }
    }
  }
  __syncthreads();
  float* dst = ws + ((int64_t)blockIdx.x * gridDim.y + tap) * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += red[k * E + e];
    dst[e] = s;
  }
}

__global__ void wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                    int nsplit, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += ws[k * n + i];
  out[i] = s;
}

template <typename T, int TI, int TO>
int launch(const void* x, const void* g, float* ws, float* out, int KD, int KH, int KW,
           int B, int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo, int Cout, int sd,
           int sh, int sw, int pd, int ph, int pw, int P, int nsplit, cudaStream_t s) {
  const int NT = (Cin / TI) * (Cout / TO);
  if (NT > kThreads * kMaxTiles) return (int)cudaErrorInvalidValue;
  const int L = NT < kThreads ? NT : kThreads;
  const size_t stage = sizeof(int64_t) * 2 * P + sizeof(float) * (size_t)P * (Cin + Cout);
  const size_t reduce = sizeof(float) * (size_t)(kThreads / L) * Cin * Cout;
  const size_t smem = stage > reduce ? stage : reduce;
  auto kern = wgrad_partial_kernel<T, TI, TO>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int KT = KD * KH * KW;
  const int64_t N = (int64_t)B * Do * Ho * Wo;
  const int64_t per = (N + nsplit - 1) / nsplit;
  kern<<<dim3((unsigned)nsplit, (unsigned)KT), kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ws, B, Di, Hi, Wi, Cin, Do, Ho, Wo,
      Cout, KH, KW, sd, sh, sw, pd, ph, pw, P, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)KT * Cin * Cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, out, nsplit, n);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int ti, int to, const void* x, const void* g, float* ws, float* out, int KD,
             int KH, int KW, int B, int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo,
             int Cout, int sd, int sh, int sw, int pd, int ph, int pw, int P, int nsplit,
             cudaStream_t s) {
#define MVS_WGRAD_ARGS x, g, ws, out, KD, KH, KW, B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, sd, sh, sw, pd, ph, pw, P, nsplit, s
  if (ti == 4 && to == 4) return launch<T, 4, 4>(MVS_WGRAD_ARGS);
  if (ti == 4 && to == 1) return launch<T, 4, 1>(MVS_WGRAD_ARGS);
  if (ti == 1 && to == 4) return launch<T, 1, 4>(MVS_WGRAD_ARGS);
  if (ti == 1 && to == 1) return launch<T, 1, 1>(MVS_WGRAD_ARGS);
#undef MVS_WGRAD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, Di, Hi, Wi, Cin) and g (B, Do, Ho, Wo, Cout) in one type; ws
// (nsplit, KD*KH*KW, Cin, Cout) float32 workspace; out (KD, KH, KW, Cin,
// Cout) float32; all contiguous. ti, to (4 or 1) divide Cin, Cout; rows
// (a multiple of 4) is the number of output voxels staged at a time.
// Launches the partial pass and the reduction on the stream; returns
// cudaGetLastError().
extern "C" int wgrad_launch(int dtype, int kd, int kh, int kw, int ti, int to, const void* x,
                            const void* g, void* ws, void* out, int B, int Di, int Hi, int Wi,
                            int Cin, int Do, int Ho, int Wo, int Cout, int sd, int sh, int sw,
                            int pd, int ph, int pw, int rows, int nsplit, void* stream) {
  if (Cin % ti != 0 || Cout % to != 0 || rows % 4 != 0 || rows <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
  if (dtype == mvs::kFloat32)
    return dispatch<float>(ti, to, x, g, w, o, kd, kh, kw, B, Di, Hi, Wi, Cin, Do, Ho, Wo,
                           Cout, sd, sh, sw, pd, ph, pw, rows, nsplit, s);
  if (dtype == mvs::kBFloat16)
    return dispatch<bf16>(ti, to, x, g, w, o, kd, kh, kw, B, Di, Hi, Wi, Cin, Do, Ho, Wo,
                          Cout, sd, sh, sw, pd, ph, pw, rows, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* wgrad_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
