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
// float32 sums of exact products; dk is (KD, KH, KW, Cin, Cout) float32.
// Both editions are split-K products with a deterministic second pass: each
// block writes its partial dk to a float32 workspace, and wgrad_reduce_kernel
// adds the partials in a fixed order. No atomics: the result is the same
// from run to run for a given shape and plan.
//
// The tensor-core edition (wgrad_tc_launch; bf16, Cin % 8 == 0). dk is a
// product with K running over the output voxels: per tap,
// dk_t = X_t^T G, M = taps x Cin (row t * Cin + ci), N = Cout. The Pallas
// kernel folds the same (tap, ci) rows into one MXU dot (conv3d.py:1099).
// Bounds on the H100 at the training point's largest layer (3dconv0_1:
// 3.7 M output voxels, 27 taps, 32 -> 8 channels): bytes 0.088 ms (x 236
// MB, g 59 MB), operations 0.052 ms (51 GFLOP at 989 TFLOP/s), and a third
// that binds first in this design, as in tc_conv.cuh at N = 8: every x
// element is read from shared memory once per tap (27 x Cin x 2 bytes an
// output voxel, 6.4 GB), about 0.22 ms at the SMs' 128 bytes a clock.
// What the design does:
//  1. A block owns a tile of output voxels (TZ x TY x TX, a multiple of 16)
//     and stages, once, its input box (the tile times the stride plus the
//     halo along each axis, every input channel, zero-filled at the SAME
//     pads by the src-size-0 form of cp.async) and its cotangent tile (the
//     block's Cout slice, zero past the output; a Cout that is not a
//     multiple of 8, 3dconv6_2's 1, element by element, zero-padded to 8
//     columns in shared memory). Blocks are persistent: each walks tiles
//     blockIdx.x, + gridDim.x, ..., summing in registers, with two
//     buffers, so that the next tile's 16-byte copies run under this
//     tile's products (tc_conv.cuh's helpers:
//     cp_async16, Swizzle with a stride-2 box's even columns first,
//     FastDiv). The old edition gathered the input once per tap.
//  2. All taps come from that one box: a tap is an address shift. K steps
//     are 16 voxels; both operands are channels-last with the voxel axis as
//     K, so both load with ldmatrix.trans: the cotangent fragment once per
//     k step, reused for every (tap, ci) row tile of the warp. M tiles are
//     pairs of 8-channel units (tap, chunk), so Cin = 8 packs two taps in
//     one row tile.
//  3. Products on mma.sync.m16n8k16 (bf16 in, float32 sums: the same
//     numeric contract as the CUDA-core edition). Not wgmma: A comes per
//     lane from shifted rows of the box, which wgmma too would take from
//     registers loaded by ldmatrix, and N is 8-16 on the large layers, so
//     the shared-memory read of A above binds whichever instruction
//     consumes it.
//  4. The (taps x Cin) x Cout float32 partials stay in registers, split over
//     the warps by row tile (MT tiles of 16 rows each) and, where there are
//     few row tiles, over warp groups that take every KG-th k step. Layers
//     whose partials do not fit one block (3dconv3_1's 64 x 64 x 27,
//     2dconv4_1's 128 x 128 x 9) split row tiles and Cout slices over
//     blockIdx.y; each such block stages only its Cout slice of g.
// The launch plan (tile, box, buffers, splits) is chosen in Python
// (ops/kernels/wgrad.py) and passed as ints (struct Plan).
//
// The CUDA-core edition (wgrad_launch; float32, and the layers outside
// the tensor-core rule: the two convs on the 3-channel images) is the
// first edition of this kernel, bound by operations on the CUDA cores. Pass 1 gives every block
// one tap and one
// contiguous range of output voxels; it stages P rows of the tap's input
// (gathered) and of g in shared memory as float32, and each thread keeps a
// TI x TO tile of dk (up to kMaxTiles of them) in registers; when dk has
// fewer tiles than the block has threads, the rows are split among groups
// of threads too, and the groups' sums are added in shared memory in a
// fixed order. Float32 stays on the CUDA cores because TF32 would not hold
// float32's tolerances.
#include "common.cuh"
#include "tc_conv.cuh"

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

// ---- the tensor-core edition

// Mirrors ops/kernels/wgrad.py `plan_ints`: 39 ints.
struct TcPlan {
  int B, Di, Hi, Wi, Cin;
  int Do, Ho, Wo, Cout;
  int KD, KH, KW;
  int sd, sh, sw;
  int pd, ph, pw;
  int TZ, TY, TX;        // output voxels of a tile
  int BZ, BY, BX;        // its input box
  int tz, ty, tx;        // tiles along each axis
  int n_tiles;           // B * tz * ty * tx
  int ksteps;            // TZ * TY * TX / 16
  int kg, wm;            // warp groups along k; warps along the row tiles (kg * wm = 8)
  int units, m_tiles;    // 8-channel units (taps * Cin / 8); row tiles of 16, ceil(units / 2)
  int m_slices;          // blockIdx.y = n_slice * m_slices + m_slice
  int box_bytes, g_bytes;   // one buffer's box and cotangent tile (two buffers)
  int smem_bytes;
  int grid_x, grid_y;
};
static_assert(sizeof(TcPlan) == 39 * 4, "TcPlan is 39 ints");

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;

// NT column tiles of 8 (the block's Cout slice), MT row tiles of 16 a warp.
template <int NT, int MT>
__global__ void __launch_bounds__(kTcThreads)
wgrad_tc_kernel(const __grid_constant__ TcPlan P, const bf16* __restrict__ x,
                const bf16* __restrict__ g, float* __restrict__ ws) {
  using namespace mvs::tc;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % P.wm, kg = warp / P.wm;
  const int ms = blockIdx.y % P.m_slices, ns = blockIdx.y / P.m_slices;
  const int nch = P.Cin >> 3, gch = (P.Cout + 7) >> 3;
  const int gc0 = ns * NT;   // the block's first 8-channel chunk of g
  const Swizzle swx(nch), swg(NT);
  const FastDiv div_nch(nch), div_bx(P.BX), div_by(P.BY), div_tx(P.TX), div_ty(P.TY);
  const int half_x = (P.BX + 1) >> 1;
  auto xpos = [&](int bx) { return P.sw == 2 ? (bx & 1) * half_x + (bx >> 1) : bx; };
  const uint32_t smem0 = smem_u32(smem);
  const int M = P.TZ * P.TY * P.TX;
  const int buf_bytes = P.box_bytes + P.g_bytes;

  // This warp's row tiles j0 .. j0 + nvalid - 1. In tile j, lanes 0-7 and
  // 16-23 address unit 2j (rows 16 j .. 16 j + 7), lanes 8-15 and 24-31
  // unit 2j + 1; a unit is (tap, 8-channel chunk), row tap * Cin + ci.
  const int j0 = (ms * P.wm + wm) * MT;
  const int nvalid = min(MT, P.m_tiles - j0);
  const int half = (lane >> 3) & 1;
  int uoff[MT], uch[MT];   // the lane's tap offset in the box, its chunk
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int u = 2 * (j0 + mt) + half;
    if (u >= P.units) u = 0;   // a row past the last tap: computed, never stored
    const int tap = div_nch.div(u), c = u - tap * nch;
    const int a = tap / (P.KH * P.KW), rem = tap - a * P.KH * P.KW;
    const int b = rem / P.KW, e = rem - b * P.KW;
    uoff[mt] = (a * P.BY + b) * P.BX + xpos(e);
    uch[mt] = c;
  }

  // the input box and cotangent tile of tile t into buffer buf
  auto stage = [&](int t, int buf) {
    const int per_b = P.tz * P.ty * P.tx;
    const int b = t / per_b;
    t -= b * per_b;
    const int iz = t / (P.ty * P.tx);
    t -= iz * P.ty * P.tx;
    const int iy = t / P.tx, ix = t - iy * P.tx;
    const int oz = iz * P.TZ, oy = iy * P.TY, ox = ix * P.TX;
    const uint32_t xb = smem0 + buf * buf_bytes, gb = xb + P.box_bytes;
    const int iz0 = oz * P.sd - P.pd, iy0 = oy * P.sh - P.ph, ix0 = ox * P.sw - P.pw;
    const bf16* xbat = x + (int64_t)b * P.Di * P.Hi * P.Wi * P.Cin;
    for (int q = tid; q < P.BZ * P.BY * P.BX * nch; q += kTcThreads) {
      const int pix = div_nch.div(q), c = q - pix * nch;
      const int r = div_bx.div(pix), bx = pix - r * P.BX;
      const int bz = div_by.div(r), by = r - bz * P.BY;
      const int zz = iz0 + bz, yy = iy0 + by, xx = ix0 + bx;
      const bool in = (unsigned)zz < (unsigned)P.Di && (unsigned)yy < (unsigned)P.Hi &&
                      (unsigned)xx < (unsigned)P.Wi;
      const bf16* src = in ? xbat + (((int64_t)zz * P.Hi + yy) * P.Wi + xx) * P.Cin + c * 8 : x;
      cp_async16(xb + swx(pix - bx + xpos(bx), c), src, in ? 16 : 0);
    }
    const bf16* gbat = g + (int64_t)b * P.Do * P.Ho * P.Wo * P.Cout;
    for (int q = tid; q < M * NT; q += kTcThreads) {
      const int v = q / NT, c = q - v * NT;
      const int rr = div_tx.div(v), lx = v - rr * P.TX;
      const int lz = div_ty.div(rr), ly = rr - lz * P.TY;
      const int zz = oz + lz, yy = oy + ly, xx = ox + lx, ch = gc0 + c;
      const bool in = zz < P.Do && yy < P.Ho && xx < P.Wo && ch < gch;
      const bf16* src = in ? gbat + (((int64_t)zz * P.Ho + yy) * P.Wo + xx) * P.Cout + ch * 8 : g;
      if ((P.Cout & 7) == 0) {
        cp_async16(gb + swg(v, c), src, in ? 16 : 0);
      } else {
        // a Cout that is not a multiple of 8 (3dconv6_2's 1): element by
        // element, zero-padded to the 16-byte chunk
        __align__(16) bf16 e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          e[i] = in && ch * 8 + i < P.Cout ? src[i] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(smem + buf * buf_bytes + P.box_bytes + swg(v, c)) =
            *reinterpret_cast<const uint4*>(e);
      }
    }
    cp_async_commit();
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  int buf = 0;
  int T = blockIdx.x;
  if (T < P.n_tiles) stage(T, 0);
  for (; T < P.n_tiles; T += gridDim.x) {
    const int Tn = T + gridDim.x;
    if (Tn < P.n_tiles) stage(Tn, buf ^ 1);
    else cp_async_commit();
    cp_async_wait<1>();   // this tile's group; the next one may be in flight
    __syncthreads();
    const uint32_t xb = smem0 + buf * buf_bytes, gb = xb + P.box_bytes;
    if (nvalid > 0) {
      for (int kk = kg; kk < P.ksteps; kk += P.kg) {
        // the cotangent fragments of k step kk: voxels 16 kk + 0..15
        uint32_t bf[NT][2];
        const int vb = 16 * kk + (lane & 7) + (half << 3);
        if constexpr (NT == 1) {
          ldsm_x2_t(gb + swg(vb, 0), bf[0]);
        } else {
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            uint32_t r[4];
            ldsm_x4_t(gb + swg(vb, 2 * p + (lane >> 4)), r);
            bf[2 * p][0] = r[0];
            bf[2 * p][1] = r[1];
            bf[2 * p + 1][0] = r[2];
            bf[2 * p + 1][1] = r[3];
          }
        }
        // the lane's voxel in the input fragments and its box pixel
        const int va = 16 * kk + (lane & 7) + ((lane >> 4) << 3);
        const int rr = div_tx.div(va), lx = va - rr * P.TX;
        const int lz = div_ty.div(rr), ly = rr - lz * P.TY;
        const int rp = (lz * P.sd * P.BY + ly * P.sh) * P.BX + lx;
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt < nvalid) ldsm_x4_t(xb + swx(rp + uoff[mt], uch[mt]), af[mt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          if (mt < nvalid)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
      }
    }
    __syncthreads();   // this buffer is consumed
    buf ^= 1;
  }

  // the partial of (block, warp group): rows 16 j + g and + 8, columns
  // 8 (gc0 + nt) + 2 tq and + 1
  const int rows = P.units * 8;
  float* dst = ws + (int64_t)(blockIdx.x * P.kg + kg) * rows * P.Cout;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if (mt >= nvalid) break;
    const int r0 = 16 * (j0 + mt) + gq;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = (gc0 + nt) * 8 + 2 * tq;
      if (col >= P.Cout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        if (row >= rows) continue;
        float* d = dst + (int64_t)row * P.Cout + col;
        if ((P.Cout & 1) == 0) {
          *reinterpret_cast<float2*>(d) = make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        } else {
          d[0] = acc[mt][nt][2 * h];
          if (col + 1 < P.Cout) d[1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
}

template <int NT, int MT>
int launch_tc(const TcPlan& P, const void* x, const void* g, float* ws, float* out,
              cudaStream_t s) {
  auto kern = wgrad_tc_kernel<NT, MT>;
  if (P.smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)P.grid_x, (unsigned)P.grid_y), kTcThreads, P.smem_bytes, s>>>(
      P, static_cast<const bf16*>(x), static_cast<const bf16*>(g), ws);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int64_t n = (int64_t)P.units * 8 * P.Cout;
  wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, out, P.grid_x * P.kg, n);
  return (int)cudaGetLastError();
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

// x (B, Di, Hi, Wi, Cin % 8 == 0) and g (B, Do, Ho, Wo, Cout) bf16; ws
// (grid_x * kg, taps * Cin, Cout) float32 workspace; out (KD, KH, KW, Cin,
// Cout) float32; all contiguous and 16-byte aligned. plan: the 39 ints of
// TcPlan; (nt, mt) as ops/kernels/wgrad.py TC_TILES allows them. Launches
// the partial pass and the reduction on the stream; returns
// cudaGetLastError().
extern "C" int wgrad_tc_launch(int nt, int mt, const int* plan, const void* x, const void* g,
                               void* ws, void* out, void* stream) {
  TcPlan P;
  memcpy(&P, plan, sizeof(TcPlan));
  if (P.Cin % 8 != 0 || P.Cout < 1 || P.kg * P.wm != kTcWarps || P.grid_x < 1 ||
      P.grid_y < 1 || P.ksteps * 16 != P.TZ * P.TY * P.TX || P.TX % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  float* o = static_cast<float*>(out);
#define MVS_WGRAD_TC(N_, M_) \
  if (nt == N_ && mt == M_) return launch_tc<N_, M_>(P, x, g, w, o, s);
  MVS_WGRAD_TC(1, 1)
  MVS_WGRAD_TC(1, 2)
  MVS_WGRAD_TC(1, 4)
  MVS_WGRAD_TC(1, 7)
  MVS_WGRAD_TC(2, 1)
  MVS_WGRAD_TC(2, 2)
  MVS_WGRAD_TC(2, 4)
  MVS_WGRAD_TC(2, 7)
  MVS_WGRAD_TC(4, 1)
  MVS_WGRAD_TC(4, 2)
  MVS_WGRAD_TC(4, 4)
  MVS_WGRAD_TC(8, 1)
  MVS_WGRAD_TC(8, 2)
#undef MVS_WGRAD_TC
  return (int)cudaErrorInvalidValue;
}
