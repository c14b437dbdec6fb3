// The ConvGRU's depth step between its convs (R-MVSNet's serving sweep):
// for each cell a gates kernel after its gates conv and an output kernel
// after its output conv, and a tail kernel after prob_conv.
//
// Replaces no TPU kernel: the JAX package's scan of the depth step leaves
// these elementwise and reduction passes to XLA, which fuses them. On the
// card the plain PyTorch cell (models/gru.py, ConvGRUCell, with its layer
// norms in models/layers.py, GroupNormFlexible at G = 1) makes some 70
// launches a depth step besides the 7 convs: each of the 9 norms a float32
// cast, two means and about eight elementwise passes over the map, then the
// sigmoids and tanh, two concatenations a cell, r * h, the state update,
// the winner-take-all and the copies into the captured step's buffers.
// These three kernels compute the same arithmetic in 7 launches a step:
//
// Each cell keeps one channels-last bf16 input [x | slot] of in + F
// channels (B, P, cin), which both its convs read.
//  gates kernel: g = the gates conv's output (B, P, 2F) bf16, reset the
//    first F channels, update the last F. Each half takes a layer norm over
//    (pixels, F) of each image: S = sum x, mean = float(S * inv_n); Q =
//    sum (x - mean)^2 with the difference and the square in float32, var =
//    float(Q * inv_n) (inv_n = 1 / (P * F), computed on the host in
//    float64, as PyTorch's means divide by a host number); then
//    ((x - mean) / sqrt(var + eps)) * scale + bias in float32, rounded to
//    bf16, and the sigmoid 1 / (1 + exp(-v)) in float32, rounded to bf16.
//    It writes (float(r) * h).bf16 into the slot, for the output conv, and
//    u into `update`.
//  output kernel: y = the output conv's output (B, P, F) bf16, the same
//    layer norm, tanh rounded to bf16, then h' = u * h + bf16(bf16(1 - u) *
//    y) in float32, as PyTorch promotes `update * h + (1 - update) * y`. It
//    writes h' in float32 in place of h, and h'.bf16 into the slot (for
//    the next plane's gates conv) and into the first F channels of `nxt`
//    (the next cell's input, or prob_conv's).
//  tail kernel: the reg's float32 value out, and with a carry the
//    winner-take-all update of ops/depth.winner_take_all_update in place:
//    prob = exp(reg); prob > max_prob takes the pixel (max_prob, depth);
//    exp_sum += prob.
// Every float32 operation is rounded on its own, as PyTorch's card kernels
// compute it (no fused multiply-add, IEEE division and square root; expf
// and tanhf as PyTorch's sigmoid, tanh and exp call them).
//
// The sums are float64 over the float32 values, in an order fixed by the
// image's size alone: an image's pixels split into chunks of kChunk, a
// thread sums its kPix pixels' channels in order, a block its chunk's
// threads in a fixed tree, and every block the chunks' partial sums, lane l
// of a warp chunks l, l + 32, ... in order, then the lanes in a butterfly. So
// two calls give the same bits, an image's statistics do not depend on the
// batch it is in or the grid, and they equal float64 sums in any other
// order after the cast to float32 but where a sum falls within float64's
// rounding of a float32 tie.
//
// Bound on the H100: bytes. At R-MVSNet's serving point (features 300x400,
// F = 16, 4, 2) a depth step reads the conv outputs and the float32 states
// and writes the states, the slots and the next inputs: about 18 MB for
// cell 1, 5 µs at 3.35 TB/s. The design:
//  1. The norm's two passes need the whole map's sums. The gates and output
//     kernels run one wave (the grid is at most the blocks the card holds
//     at once, launched cooperatively) and cross two grid barriers: the chunks' sums, a barrier, the
//     statistics, the centred squares, a barrier, the normalisation. The
//     barrier is an arrival counter in `bar` that the last block to leave
//     the second barrier resets: every launch finds it at 0. The re-reads
//     of the conv output after each barrier are served from the 50 MB L2.
//  2. Few partial sums to add after a barrier: the sums' chunk is kChunk =
//     1024 pixels (118 at 300x400), one block's work in the two sums'
//     passes, a thread kPix = 4 pixels of it, 256 apart (coalesced), with
//     all their channels (F is a template parameter), the four pixels'
//     loads issued before their sums. The grid holds up to a thread a
//     pixel (one wave at most), and the normalisation's pass, which sums
//     nothing, spreads the pixels over all of it: its sigmoids and tanh
//     need the threads to hide their latency. 16-byte loads where the
//     channels allow; stores into the strided slots in the widest unit
//     their alignment takes.
//  3. The norms' parameters are loaded at the start and staged in shared
//     memory before the first barrier, so that their latency hides behind
//     the first pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;           // a block
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;                 // pixels a thread takes in a chunk
constexpr int kChunk = kThreads * kPix; // pixels of a chunk
constexpr int kGen = 32;                // bar[kGen]: the departures, 128 bytes on
constexpr int kMaxPairs = 256;          // (image, norm) pairs a launch takes

__device__ __forceinline__ float bf(unsigned int u) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)u));
}
__device__ __forceinline__ unsigned short bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_bf(float v) { return bf(bits(v)); }

// N consecutive bf16 values at p, aligned to min(16, 2N) bytes
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* __restrict__ p, float v[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + j);
      const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[8 * j + 2 * i] = bf(w[i] & 0xffffu);
        v[8 * j + 2 * i + 1] = bf(w[i] >> 16);
      }
    }
  } else if constexpr (N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    v[0] = bf(u.x & 0xffffu);
    v[1] = bf(u.x >> 16);
    v[2] = bf(u.y & 0xffffu);
    v[3] = bf(u.y >> 16);
  } else if constexpr (N == 2) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf(u & 0xffffu);
    v[1] = bf(u >> 16);
  } else {
    v[0] = bf(__ldg(reinterpret_cast<const unsigned short*>(p)));
  }
}

// N consecutive bf16 values kept packed, two a word (one where N = 1)
template <int N> struct Row {
  unsigned int w[N >= 2 ? N / 2 : 1];
  __device__ __forceinline__ float operator[](int i) const {
    return bf(N == 1 ? w[0] : (i & 1 ? w[i / 2] >> 16 : w[i / 2] & 0xffffu));
  }
};

// N consecutive bf16 values at p, aligned to min(16, 2N) bytes, packed
template <int N>
__device__ __forceinline__ Row<N> load_row(const bf16* __restrict__ p) {
  Row<N> r;
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + j);
      r.w[4 * j] = u.x;
      r.w[4 * j + 1] = u.y;
      r.w[4 * j + 2] = u.z;
      r.w[4 * j + 3] = u.w;
    }
  } else if constexpr (N == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else if constexpr (N == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return r;
}

// N float32 values at p, aligned to min(16, 4N) bytes (plain loads: the
// output kernel writes the state it reads)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float v[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 a = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = a.x;
      v[4 * j + 1] = a.y;
      v[4 * j + 2] = a.z;
      v[4 * j + 3] = a.w;
    }
  } else if constexpr (N == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  } else {
    v[0] = p[0];
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float v[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      reinterpret_cast<float4*>(p)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

__device__ __forceinline__ unsigned int pair(unsigned short lo, unsigned short hi) {
  return (unsigned int)lo | ((unsigned int)hi << 16);
}

// N bf16 bit patterns to p in units of sv values (8, 4, 2 or 1: what p's
// alignment and the destination's channel stride allow)
template <int N>
__device__ __forceinline__ void store_bf16(bf16* p, const unsigned short o[N], int sv) {
  if constexpr (N % 8 == 0) {
    if (sv == 8) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
        reinterpret_cast<uint4*>(p)[j] =
            make_uint4(pair(o[8 * j], o[8 * j + 1]), pair(o[8 * j + 2], o[8 * j + 3]),
                       pair(o[8 * j + 4], o[8 * j + 5]), pair(o[8 * j + 6], o[8 * j + 7]));
      return;
    }
  }
  if constexpr (N % 4 == 0) {
    if (sv >= 4) {
#pragma unroll
      for (int j = 0; j < N / 4; ++j)
        reinterpret_cast<uint2*>(p)[j] =
            make_uint2(pair(o[4 * j], o[4 * j + 1]), pair(o[4 * j + 2], o[4 * j + 3]));
      return;
    }
  }
  if constexpr (N % 2 == 0) {
    if (sv >= 2) {
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        reinterpret_cast<unsigned int*>(p)[j] = pair(o[2 * j], o[2 * j + 1]);
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) reinterpret_cast<unsigned short*>(p)[i] = o[i];
}

// The block's sum of each thread's G values, in a fixed tree (lane i takes
// lane i + o for o = 16 .. 1, then thread 0 the warps in order); thread 0
// holds it. The caller syncs before `red` is written again.
template <int G>
__device__ __forceinline__ void block_sum(double v[G], double (*red)[kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[g] += __shfl_down_sync(0xffffffffu, v[g], o);
    if (lane == 0) red[g][warp] = v[g];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      double s = red[g][0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += red[g][w];
      v[g] = s;
    }
  }
}

// Every block of the grid arrives before any leaves: the launch's k-th
// barrier waits for bar[0] to reach k * gridDim.x (an arrival is a release
// add, the wait an acquire load, as cooperative groups' grid barrier does).
// Needs every block resident at once, which the cooperative launch
// (launch_one_wave) guarantees or refuses. `depart` after the launch's last
// barrier: the last block to leave it resets bar[0] and bar[kGen] (the
// departures, another line), so every launch finds them at 0.
__device__ __forceinline__ void grid_sync(unsigned int* bar, unsigned int k, bool depart) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int target = k * gridDim.x;
    unsigned int v;
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(bar) : "memory");
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
    if (depart && atomicAdd(bar + kGen, 1u) == gridDim.x - 1) {
      bar[0] = 0;
      bar[kGen] = 0;
    }
  }
  __syncthreads();
}

// tot[q] = the sum over the chunks of part[q * chunks ...] for q < pairs:
// warp w takes pairs w, w + kWarps, ...; lane l sums chunks l, l + 32, ...
// in order (eight loads in flight), then the lanes combine in a butterfly,
// which leaves every lane the same bits. The same in every block.
__device__ __forceinline__ void totals(const double* part, int pairs, int chunks, double* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = warp; q < pairs; q += kWarps) {
    const double* src = part + (int64_t)q * chunks;
    double s = 0.0;
    for (int k0 = lane; k0 < chunks; k0 += 32 * 8) {
      double v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = k0 + 32 * j;
        v[j] = k < chunks ? __ldcg(src + k) : 0.0;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) s += v[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) tot[q] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ float normed(float x, float mean, float den, float scale, float bias) {
  return round_bf(__fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(x, mean), den), scale), bias));
}

__device__ __forceinline__ float sigmoid_bf(float v) {
  return round_bf(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v))));
}

// The two-pass statistics of G norms of each image, a norm's channel c of
// pixel p being x[((n * P + p) * G + g) * F + c] (gates: G = 2, reset then
// update; output: G = 1): mean and den = sqrt(var + eps) of pair n * G + g
// into shared memory, after two grid barriers. part: two (B, G, chunks)
// float64 areas. `param`, this thread's norm parameter (thread t < 2 G F
// holds scale then bias of norm g = t / 2F, channel t % F), is staged into
// param_s before the first barrier.
template <int F, int G>
__device__ __forceinline__ void layer_norm_stats(const bf16* __restrict__ x, double* part,
                                                 unsigned int* bar, int B, int64_t P,
                                                 int chunks, double inv_n, float eps,
                                                 float* mean_s, float* den_s, float param,
                                                 float* param_s) {
  __shared__ double red[G][kWarps];
  __shared__ double tot[kMaxPairs];
  const int items = B * chunks;
  for (int pass = 0; pass < 2; ++pass) {
    double* out = part + (int64_t)pass * B * G * chunks;
    for (int it = blockIdx.x; it < items; it += gridDim.x) {
      const int n = it / chunks, k = it % chunks;
      const int64_t p0 = (int64_t)k * kChunk + threadIdx.x;
      double s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) s[g] = 0.0;
      Row<G * F> v[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j)
        if (p0 + j * kThreads < P)
          v[j] = load_row<G * F>(x + ((int64_t)n * P + p0 + j * kThreads) * (G * F));
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        if (p0 + j * kThreads >= P) break;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m = pass ? mean_s[n * G + g] : 0.0f;
#pragma unroll
          for (int c = 0; c < F; ++c) {
            if (pass == 0) {
              s[g] += (double)v[j][g * F + c];
            } else {
              const float d = __fsub_rn(v[j][g * F + c], m);
              s[g] += (double)__fmul_rn(d, d);
            }
          }
        }
      }
      block_sum<G>(s, red);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) out[((int64_t)n * G + g) * chunks + k] = s[g];
      }
      __syncthreads();
    }
    if (pass == 0 && threadIdx.x < 2 * G * F) param_s[threadIdx.x] = param;
    grid_sync(bar, pass + 1, pass == 1);
    totals(out, B * G, chunks, tot);
    for (int q = threadIdx.x; q < B * G; q += blockDim.x) {
      const float m = __double2float_rn(__dmul_rn(tot[q], inv_n));
      if (pass == 0)
        mean_s[q] = m;
      else
        den_s[q] = __fsqrt_rn(__fadd_rn(m, eps));
    }
    __syncthreads();
  }
}

// Thread t < 2 G F's norm parameter: params[t / F][t % F], the scale then
// the bias of the reset norm, then of the update norm (gates), or of the
// output norm
template <int F, int G>
__device__ __forceinline__ float param_of(const float* const* params) {
  return threadIdx.x < 2 * G * F ? __ldg(params[threadIdx.x / F] + threadIdx.x % F) : 0.0f;
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gru_gates_kernel(const bf16* __restrict__ gates, const float* __restrict__ h, bf16* inp, int cin,
                 int sv_slot, bf16* __restrict__ update, int sv_upd, const float* r_scale,
                 const float* r_bias, const float* u_scale, const float* u_bias, double inv_n,
                 float eps, double* part, unsigned int* bar, int B, int64_t P, int chunks) {
  __shared__ float mean_s[kMaxPairs], den_s[kMaxPairs];
  __shared__ float ps[2][2][F];
  const float* params[4] = {r_scale, r_bias, u_scale, u_bias};
  layer_norm_stats<F, 2>(gates, part, bar, B, P, chunks, inv_n, eps, mean_s, den_s,
                         param_of<F, 2>(params), &ps[0][0][0]);
  for (int64_t px = (int64_t)blockIdx.x * kThreads + threadIdx.x; px < (int64_t)B * P;
       px += (int64_t)gridDim.x * kThreads) {
    const int n = (int)(px / P);
    float v[2 * F], hv[F];
    load_bf16<2 * F>(gates + px * 2 * F, v);
    load_f32<F>(h + px * F, hv);
    unsigned short slot[F], up[F];
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float r = sigmoid_bf(normed(v[c], mean_s[2 * n], den_s[2 * n], ps[0][0][c],
                                        ps[0][1][c]));
      const float u = sigmoid_bf(normed(v[F + c], mean_s[2 * n + 1], den_s[2 * n + 1],
                                        ps[1][0][c], ps[1][1][c]));
      slot[c] = bits(__fmul_rn(r, hv[c]));
      up[c] = bits(u);
    }
    store_bf16<F>(inp + px * cin + (cin - F), slot, sv_slot);
    store_bf16<F>(update + px * F, up, sv_upd);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
gru_output_kernel(const bf16* __restrict__ y, const bf16* __restrict__ update, float* h,
                  bf16* inp, int cin, int sv_slot, bf16* nxt, int cn, int sv_nxt,
                  const float* scale, const float* bias, double inv_n, float eps, double* part,
                  unsigned int* bar, int B, int64_t P, int chunks) {
  __shared__ float mean_s[kMaxPairs], den_s[kMaxPairs];
  __shared__ float ps[1][2][F];
  const float* params[2] = {scale, bias};
  layer_norm_stats<F, 1>(y, part, bar, B, P, chunks, inv_n, eps, mean_s, den_s,
                         param_of<F, 1>(params), &ps[0][0][0]);
  for (int64_t px = (int64_t)blockIdx.x * kThreads + threadIdx.x; px < (int64_t)B * P;
       px += (int64_t)gridDim.x * kThreads) {
    const int n = (int)(px / P);
    float v[F], uv[F], hv[F];
    load_bf16<F>(y + px * F, v);
    load_bf16<F>(update + px * F, uv);
    load_f32<F>(h + px * F, hv);
    unsigned short o[F];
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float t = round_bf(tanhf(normed(v[c], mean_s[n], den_s[n], ps[0][0][c],
                                            ps[0][1][c])));
      const float keep = round_bf(__fsub_rn(1.0f, uv[c]));
      hv[c] = __fadd_rn(__fmul_rn(uv[c], hv[c]), round_bf(__fmul_rn(keep, t)));
      o[c] = bits(hv[c]);
    }
    store_f32<F>(h + px * F, hv);
    store_bf16<F>(inp + px * cin + (cin - F), o, sv_slot);
    store_bf16<F>(nxt + px * cn, o, sv_nxt);
  }
}

// reg (B, P) bf16 -> out (B, P) float32; with max_prob (then depth_image,
// exp_sum and depth too) the winner-take-all update in place.
__global__ void __launch_bounds__(kThreads)
gru_tail_kernel(const bf16* __restrict__ reg, float* __restrict__ out, float* max_prob,
                float* depth_image, float* exp_sum, const float* __restrict__ depth, int64_t P,
                int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const float r = bf(__ldg(reinterpret_cast<const unsigned short*>(reg) + i));
    out[i] = r;
    if (max_prob != nullptr) {
      const float prob = expf(r);
      const float m = max_prob[i];
      if (prob > m) {
        max_prob[i] = prob;
        depth_image[i] = __ldg(depth + i / P);
      }
      exp_sum[i] = __fadd_rn(exp_sum[i], prob);
    }
  }
}

template <typename Fn>
int by_filters(int F, Fn&& fn) {
  switch (F) {
    case 1: return fn(std::integral_constant<int, 1>());
    case 2: return fn(std::integral_constant<int, 2>());
    case 4: return fn(std::integral_constant<int, 4>());
    case 8: return fn(std::integral_constant<int, 8>());
    case 16: return fn(std::integral_constant<int, 16>());
    default: return (int)cudaErrorInvalidValue;
  }
}

bool sizes_ok(int G, int B, int64_t P, int chunks, int grid) {
  return B >= 1 && B * G <= kMaxPairs && P >= 1 &&
         (int64_t)chunks == (P + kChunk - 1) / kChunk && grid >= 1 &&
         (int64_t)grid <= ((int64_t)B * P + kThreads - 1) / kThreads;
}

bool sv_ok(int sv) { return sv == 1 || sv == 2 || sv == 4 || sv == 8; }

// A kernel that crosses grid_sync, launched cooperatively: a grid larger
// than the blocks the card can hold at once (another kernel or an SM limit
// taking some of it) fails the launch with cudaErrorCooperativeLaunchTooLarge
// instead of leaving a block unscheduled and the rest spinning. Stream
// capture takes the attribute into the graph's kernel node.
template <typename... Params, typename... Args>
int launch_one_wave(void (*kernel)(Params...), int grid, void* stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<Params>(args)...);
  const cudaError_t last = cudaGetLastError();   // cleared either way
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

// gates (B, P, 2F) bf16; h (B, P, F) float32; inp (B, P, cin) bf16, whose
// last F channels take (r * h).bf16 in units of sv_slot values; update (B,
// P, F) bf16 in units of sv_upd; the four (F) float32 norm parameters;
// inv_n = 1 / (P * F); part 2 * B * 2 * chunks float64 and bar 64
// unsigned ints, 0 before the first launch, kept for one stream; chunks =
// ceil(P / 1024); grid at most the blocks the card holds at once
// (gru_step_capacity) and at most a thread a pixel. Returns the
// cooperative launch's error (cudaErrorCooperativeLaunchTooLarge where the
// card cannot hold the grid at once), else cudaGetLastError().
extern "C" int gru_step_gates_launch(int F, const void* gates, const void* h, void* inp, int cin,
                                     int sv_slot, void* update, int sv_upd, const void* r_scale,
                                     const void* r_bias, const void* u_scale, const void* u_bias,
                                     double inv_n, float eps, void* part, void* bar, int B,
                                     int64_t P, int chunks, int grid, void* stream) {
  if (!sizes_ok(2, B, P, chunks, grid) || cin < F || !sv_ok(sv_slot) || !sv_ok(sv_upd))
    return (int)cudaErrorInvalidValue;
  return by_filters(F, [&](auto f) {
    constexpr int FF = decltype(f)::value;
    return launch_one_wave(
        gru_gates_kernel<FF>, grid, stream, static_cast<const bf16*>(gates),
        static_cast<const float*>(h), static_cast<bf16*>(inp), cin, sv_slot,
        static_cast<bf16*>(update), sv_upd, static_cast<const float*>(r_scale),
        static_cast<const float*>(r_bias), static_cast<const float*>(u_scale),
        static_cast<const float*>(u_bias), inv_n, eps, static_cast<double*>(part),
        static_cast<unsigned int*>(bar), B, P, chunks);
  });
}

// y, update (B, P, F) bf16; h (B, P, F) float32, updated in place; inp (B,
// P, cin) and nxt (B, P, cn) bf16, whose last and first F channels take
// h'.bf16 in units of sv_slot and sv_nxt values; scale, bias (F) float32;
// the rest as for the gates kernel (part 2 * B * chunks float64).
extern "C" int gru_step_output_launch(int F, const void* y, const void* update, void* h,
                                      void* inp, int cin, int sv_slot, void* nxt, int cn,
                                      int sv_nxt, const void* scale, const void* bias,
                                      double inv_n, float eps, void* part, void* bar, int B,
                                      int64_t P, int chunks, int grid, void* stream) {
  if (!sizes_ok(1, B, P, chunks, grid) || cin < F || cn < F || !sv_ok(sv_slot) ||
      !sv_ok(sv_nxt))
    return (int)cudaErrorInvalidValue;
  return by_filters(F, [&](auto f) {
    constexpr int FF = decltype(f)::value;
    return launch_one_wave(
        gru_output_kernel<FF>, grid, stream, static_cast<const bf16*>(y),
        static_cast<const bf16*>(update), static_cast<float*>(h), static_cast<bf16*>(inp), cin,
        sv_slot, static_cast<bf16*>(nxt), cn, sv_nxt, static_cast<const float*>(scale),
        static_cast<const float*>(bias), inv_n, eps, static_cast<double*>(part),
        static_cast<unsigned int*>(bar), B, P, chunks);
  });
}

// reg (B, P) bf16, out (B, P) float32; max_prob, depth_image, exp_sum (B, P)
// float32 and depth (B) float32, or all four null (no winner-take-all).
extern "C" int gru_step_tail_launch(const void* reg, void* out, void* max_prob,
                                    void* depth_image, void* exp_sum, const void* depth, int B,
                                    int64_t P, int grid, void* stream) {
  const bool wta = max_prob != nullptr;
  if (B < 1 || P < 1 || grid < 1 ||
      wta != (depth_image != nullptr && exp_sum != nullptr && depth != nullptr))
    return (int)cudaErrorInvalidValue;
  gru_tail_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(reg), static_cast<float*>(out), static_cast<float*>(max_prob),
      static_cast<float*>(depth_image), static_cast<float*>(exp_sum),
      static_cast<const float*>(depth), P, (int64_t)B * P);
  return (int)cudaGetLastError();
}

// The blocks of the gates and the output kernel for F filters that the
// current device holds at once: its SMs times the blocks an SM takes.
extern "C" int gru_step_capacity(int F, int* gates_blocks, int* output_blocks) {
  return by_filters(F, [&](auto f) {
    constexpr int FF = decltype(f)::value;
    int dev = 0, sms = 0, a = 0, b = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, gru_gates_kernel<FF>, kThreads, 0);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, gru_output_kernel<FF>, kThreads, 0);
    *gates_blocks = a * sms;
    *output_blocks = b * sms;
    return (int)e;
  });
}

extern "C" const char* gru_step_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
