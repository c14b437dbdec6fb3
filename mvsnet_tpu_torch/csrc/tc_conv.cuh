// The tensor-core edition of the direct and transposed convs (bf16 in,
// float32 sums, bf16 out): one tile engine that conv.cu and deconv.cu both
// instantiate. It is an implicit GEMM: M is a tile of output voxels, N is
// all of Cout rounded up to NT * 8 (zero weight columns), and K runs over
// taps x Cin in 8-channel units, so a Cin = 8 layer fills each k16 step
// with two taps and a Cin = 16..128 layer takes Cin / 16 steps a tap.
//
// Bound on the H100. A 3x3x3 conv of 8-32 channels does 100-300 operations
// per byte of its input and output, under the card's 295 for bf16: bytes
// bound the large layers (3dconv0_1: 0.29 ms). The deep layers (3dconv3_1,
// 2dconv4_1: 64-128 channels on a small grid) are bound by operations, but
// are so small that launch, wave quantisation and the weights' load set
// their time. In this design a third limit binds first at N = 8-16: every
// input element is read from shared memory once per tap (27 x Cin x 2
// bytes an output voxel), which at the SMs' 128 bytes a clock puts
// 3dconv0_1 near 0.7 ms.
//
// What the design does about it:
//  1. The block stages its input box once per tile, not once per tap: the
//     output tile plus its halo ((T - 1) * s + k along each axis), every
//     channel, in shared memory, with 16-byte cp.async copies whose
//     zero-fill predicate (src-size 0) reads the SAME pads, the explicit
//     `pads` of the halo convs and the transposed conv's edges as zeros.
//     cp.async and not the TMA: a box along a stride-2 axis and the
//     per-class boxes of the transposed conv are plain address arithmetic
//     here, and the library needs no cuTensorMapEncodeTiled (no -lcuda,
//     no tensor map per call). Each 16-byte channel chunk is stored XOR-swizzled by its
//     pixel index, and a stride-2 box keeps its even columns before its odd
//     ones, so the 8 rows an ldmatrix reads fall in 8 bank groups.
//  2. Taps are address shifts: each lane passes ldmatrix the address of
//     its own output row shifted by the tap's offset in the box, so the
//     27 (9, 25) taps and stride 2 are pointer offsets into one staged
//     tile. Products run on mma.sync.m16n8k16 (bf16 in, float32 sums), A
//     from ldmatrix, B from ldmatrix.trans on the weights in shared memory;
//     the next k step's fragments load while this step's products run.
//     mma.sync and not wgmma: A must come per lane from shifted rows, which
//     wgmma too would take from registers loaded by ldmatrix, so the
//     shared-memory read of A above bounds the products whichever
//     instruction consumes them; at N = 8 (3dconv0_1, 3dconv6_2, 2dconv8_2)
//     wgmma's 64 x 8 product would only add its 64-row granularity and a
//     descriptor layout for B.
//  3. Blocks are persistent where the planner finds it pays: a block walks
//     tiles, its weights loaded once; with two box buffers the next tile's
//     copies run under this tile's products. The weights stay resident in
//     shared memory when they fit beside the box (3dconv0_1: 13.8 KB);
//     otherwise (3dconv3_1 64x64x27, 2dconv4_1 128x128x9) they stream in
//     slices of one tap or one kd plane through a ring of two cp.async
//     stages, the next slice in flight while this one runs.
//  4. The epilogue adds the bias, applies the ReLU and casts once, in
//     registers; the tile goes through shared memory so that every output
//     row is stored as whole 16-byte channel chunks (a Cout that is not a
//     multiple of 8, such as 3dconv6_2's 1, stores its channels one by
//     one). Every output is written once, each output's sum runs over the
//     taps and channels in one fixed order whatever the tile plan, so
//     results are deterministic and a depth slab with real neighbour
//     planes gives the whole volume's values bit for bit.
//  5. The transposed conv is 2^rank parity classes in one launch: each is
//     a stride-1 conv of the input with a slice of the kernel, stored at
//     out[2 j + r]; the class table comes from the wrapper
//     (ops/kernels/tc.py), and each class reads its kernel slice w[s::2]
//     straight from the flax kernel, so a call launches nothing else.
//
// A block is 4 or 8 warps; a warp owns MT row tiles of 16 and all NT
// column tiles of 8. The launch plan (tile shape, box, buffers, weight
// slices, persistence, classes) is chosen in Python (ops/kernels/tc.py)
// and passed as ints (struct Plan).
#pragma once

#include <string.h>

#include "common.cuh"

namespace mvs {
namespace tc {

constexpr int kMaxClasses = 8;
constexpr int kMaxTaps = 32;

// One stride-s conv over a grid of outputs, stored at out[grid * os + o],
// with the kernel slice w[start::os] along each axis.
struct ClassPlan {
  int kd, kh, kw;   // taps along each axis
  int pd, ph, pw;   // low pads: tap 0 of output g reads input g * s - p
  int Dc, Hc, Wc;   // this class's output grid
  int oz, oy, ox;   // offset of its outputs in the output tensor
  int sz, sy, sx;   // kernel index of its tap 0
  int tz, ty, tx;   // tiles along each axis
  int first;        // index of its first tile among a batch element's
  int unused;
};

// Mirrors ops/kernels/tc.py `plan_ints`: 40 header ints, then the classes.
struct Plan {
  int B, Di, Hi, Wi, Cin;
  int Dout, Hout, Wout, Cout, N;
  int sd, sh, sw;
  int osd, osh, osw;
  int TZ, TY, TX;
  int BZ, BY, BX;
  int stream, relu, nclass;   // stream: taps per streamed weight slice, 0 resident
  int smem_bytes, w_smem_off, zero_off, toff_off, kpad;
  int grid_x, KH, KW;                 // grid_x: tiles in all
  int box_bytes, tiles_per_b;         // a box buffer's bytes; tiles per batch element
  int nbuf;                           // box buffers: 2 double-buffers across tiles
  int persist;                        // blocks walk tiles (else one block a tile)
  int unused[3];
  ClassPlan cls[kMaxClasses];
};
static_assert(sizeof(ClassPlan) == 20 * 4, "ClassPlan is 20 ints");
static_assert(sizeof(Plan) == (40 + 20 * kMaxClasses) * 4, "Plan is 200 ints");

// common.cuh's asynchronous copies, visible to `using namespace mvs::tc`
using mvs::cp_async16;
using mvs::cp_async_commit;
using mvs::cp_async_wait;
using mvs::smem_u32;

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t r[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t addr, uint32_t r[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, float32 sums.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of channel chunk c of box pixel pix: chunks XOR-swizzled by
// the pixel so that 8 neighbouring pixels' chunk c sit in 8 bank groups
// (nch a power of two; other channel counts are stored unswizzled).
struct Swizzle {
  int nch, shift, mask;
  __device__ __forceinline__ explicit Swizzle(int nch_) : nch(nch_), shift(0), mask(0) {
    if ((nch & (nch - 1)) == 0) {
      if (nch >= 8) {
        mask = 7;
      } else if (nch > 1) {
        mask = nch - 1;
        shift = nch == 4 ? 1 : 2;
      }
    }
  }
  __device__ __forceinline__ uint32_t operator()(int pix, int c) const {
    return (uint32_t)(pix * nch + (c ^ ((pix >> shift) & mask))) << 4;
  }
};

// n / d by one multiply-high, exact for n < 2^17 and d < 2^15 (every box,
// tile and chunk count here): m = floor((2^32 - 1) / d) + 1.
struct FastDiv {
  unsigned long long m;
  __device__ __forceinline__ explicit FastDiv(int d) : m(0xFFFFFFFFull / (unsigned)d + 1) {}
  __device__ __forceinline__ int div(int n) const {
    return (int)(((unsigned long long)(unsigned)n * m) >> 32);
  }
};

// A persistent block walks the tiles T = blockIdx.x, + gridDim.x, ... of
// the (batch, class, tile) index space; its weights load once (again only
// where the next tile belongs to another class). For each tile it stages
// one box, (TZ - 1) s + k planes of (TY - 1) s + k rows of (TX - 1) s + k
// pixels, and computes its TZ x TY x TX outputs. With two box buffers
// (P.nbuf, resident weights) the next tile's copies are in flight while
// this tile's products run; with one, the other blocks on the SM overlap
// them.
template <int NT, int MT, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
tc_conv_kernel(const __grid_constant__ Plan P, const bf16* __restrict__ x,
               const bf16* __restrict__ w, const float* __restrict__ bias,
               bf16* __restrict__ out) {
  // weight and stage rows: 16 bytes for N = 8, else N + 8 elements, so
  // that the 8 rows of an ldmatrix fall in 8 bank groups
  constexpr int WS = NT == 1 ? 8 : NT * 8 + 8;
  constexpr int kThreads = 32 * WARPS;
  extern __shared__ __align__(128) unsigned char smem[];
  const int total = P.B * P.tiles_per_b;
  int T = blockIdx.x;
  if (T >= total) return;
  const int tid = threadIdx.x;
  const int Cin = P.Cin, nch = Cin >> 3;
  const int BY = P.BY, BX = P.BX;
  const Swizzle swz(nch);
  const FastDiv div_nch(nch), div_bx(BX), div_by(BY), div_tx(P.TX), div_ty(P.TY),
      div_cin(Cin);
  const uint32_t smem0 = smem_u32(smem);
  const uint32_t w_u32 = smem0 + P.w_smem_off;
  const uint32_t zero_u32 = smem0 + P.zero_off;
  int* toff = reinterpret_cast<int*>(smem + P.toff_off);

  // Along a stride-2 x axis the box keeps its even columns, then its odd
  // ones: the 16 rows an ldmatrix reads (outputs x, x + 1, ...) then sit on
  // neighbouring pixels, in 8 bank groups, as at stride 1.
  const int half_x = (BX + 1) >> 1;
  auto xpos = [&](int bx) { return P.sw == 2 ? (bx & 1) * half_x + (bx >> 1) : bx; };

  // tile T: batch, class and the class-grid origin of its outputs
  struct Tile {
    int b, cls, gz0, gy0, gx0;
  };
  auto tile_of = [&](int t) {
    Tile r;
    r.b = t / P.tiles_per_b;
    t -= r.b * P.tiles_per_b;
    r.cls = 0;
    while (r.cls + 1 < P.nclass && t >= P.cls[r.cls + 1].first) ++r.cls;
    const ClassPlan& cp = P.cls[r.cls];
    t -= cp.first;
    const int txi = t % cp.tx;
    t /= cp.tx;
    r.gx0 = txi * P.TX;
    r.gy0 = (t % cp.ty) * P.TY;
    r.gz0 = (t / cp.ty) * P.TZ;
    return r;
  };
  // the input box of tile tl (zero outside the input) into the buffer at base
  auto stage_box = [&](const Tile& tl, uint32_t base) {
    const ClassPlan& cp = P.cls[tl.cls];
    const int iz0 = tl.gz0 * P.sd - cp.pd, iy0 = tl.gy0 * P.sh - cp.ph,
              ix0 = tl.gx0 * P.sw - cp.pw;
    const bf16* xb = x + (int64_t)tl.b * P.Di * P.Hi * P.Wi * Cin;
    for (int q = tid; q < P.BZ * BY * BX * nch; q += kThreads) {
      const int pix = div_nch.div(q), c = q - pix * nch;
      const int r = div_bx.div(pix), bx = pix - r * BX;
      const int bz = div_by.div(r), by = r - bz * BY;
      const int iz = iz0 + bz, iy = iy0 + by, ix = ix0 + bx;
      const bool in = (unsigned)iz < (unsigned)P.Di && (unsigned)iy < (unsigned)P.Hi &&
                      (unsigned)ix < (unsigned)P.Wi;
      const bf16* src = in ? xb + (((int64_t)iz * P.Hi + iy) * P.Wi + ix) * Cin + c * 8 : x;
      cp_async16(base + swz(pix - bx + xpos(bx), c), src, in ? 16 : 0);
    }
    cp_async_commit();
  };
  // taps [t0, t0 + n) of class cp's kernel slice, (taps * Cin) rows of N
  // columns (zero past Cout), to shared-memory rows from d0; read straight
  // from the (KD, KH, KW, Cin, Cout) kernel
  auto load_weights = [&](const ClassPlan& cp, int t0, int n, int d0) {
    const FastDiv div_khw(cp.kh * cp.kw), div_kw(cp.kw);
    for (int q = tid; q < n * Cin * NT; q += kThreads) {
      const int r = q / NT, co = (q - r * NT) * 8;
      const int dt = div_cin.div(r), ci = r - dt * Cin, t = t0 + dt;
      const int a = div_khw.div(t), rem = t - a * cp.kh * cp.kw;
      const int bb = div_kw.div(rem), e = rem - bb * cp.kw;
      const int64_t krow =
          (((int64_t)(cp.sz + a * P.osd) * P.KH + cp.sy + bb * P.osh) * P.KW + cp.sx + e * P.osw) *
              Cin + ci;
      const uint32_t dst = w_u32 + ((d0 + r) * WS + co) * 2;
      if ((P.Cout & 7) == 0 || co >= P.Cout) {
        cp_async16(dst, co < P.Cout ? w + krow * P.Cout + co : w, co < P.Cout ? 16 : 0);
      } else {
        bf16* d = reinterpret_cast<bf16*>(smem + P.w_smem_off) + (d0 + r) * WS + co;
        for (int i = 0; i < 8; ++i)
          d[i] = co + i < P.Cout ? w[krow * P.Cout + co + i] : __float2bfloat16_rn(0.f);
      }
    }
  };
  // class cp's tap table and resident weights (or, streamed, its first
  // slice of P.stream taps); the caller commits and waits
  auto set_class = [&](const ClassPlan& cp) {
    const int taps = cp.kd * cp.kh * cp.kw;
    if (P.stream) {
      load_weights(cp, 0, min(P.stream, taps), 0);
    } else {
      load_weights(cp, 0, taps, 0);
      // rows past the last tap read as zero (an odd count of 8-channel units)
      uint4* zr = reinterpret_cast<uint4*>(smem + P.w_smem_off + taps * Cin * WS * 2);
      for (int q = tid; q < (P.kpad - taps * Cin) * WS / 8; q += kThreads)
        zr[q] = make_uint4(0, 0, 0, 0);
    }
    if (tid < kMaxTaps) {
      // offset of each tap in the box; -1 (the zero row) past the last one
      int off = -1;
      if (tid < taps) {
        const int a = tid / (cp.kh * cp.kw), rem = tid - a * cp.kh * cp.kw;
        const int bb = rem / cp.kw, e = rem - bb * cp.kw;
        off = (a * BY + bb) * BX + xpos(e);
      }
      toff[tid] = off;
    }
  };

  Tile cur = tile_of(T);
  set_class(P.cls[cur.cls]);
  stage_box(cur, smem0);
  if (tid == 0) *reinterpret_cast<uint4*>(smem + P.zero_off) = make_uint4(0, 0, 0, 0);

  // ---- each lane's output row in each of its MT row tiles
  const int warp = tid >> 5, lane = tid & 31;
  const int khalf = lane >> 4;
  int rowpix[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row = (warp * MT + mt) * 16 + (lane & 15);
    const int rr = div_tx.div(row), lx = row - rr * P.TX;
    const int lz = div_ty.div(rr), ly = rr - lz * P.TY;
    rowpix[mt] = (lz * P.sd * BY + ly * P.sh) * BX + (P.sw == 2 ? lx : lx * P.sw);
  }
  float acc[MT][NT][4];

  // K steps run in 16-channel units of (tap, chunk): step kk of a run
  // takes unit u = 2 kk + khalf (lanes 0-15 the even unit, 16-31 the odd
  // one) and the weight rows wrow0 + 16 kk. The fragments of step kk + 1
  // are loaded before the products of step kk issue, so that the
  // ldmatrix latency hides under the products (the issue order is the
  // program order: the asm is volatile). The B fragments are carried
  // across steps for NT <= 4; wider tiles load them in the product loop,
  // where NT / 2 loads already feed 2 MT products each.
  constexpr bool kPipeB = NT <= 4;
  constexpr int NB = kPipeB ? NT : 1;
  auto load = [&](uint32_t base, int t0, int wrow0, int kk, uint32_t (&a)[MT][4],
                  uint32_t (&b)[NB][2]) {
    const int u = 2 * kk + khalf, tl = div_nch.div(u), c = u - tl * nch;
    const int off = toff[t0 + tl];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(off < 0 ? zero_u32 : base + swz(rowpix[mt] + off, c), a[mt]);
    if constexpr (kPipeB) {
      const uint32_t brow = w_u32 + (wrow0 + 16 * kk + (lane & 15)) * WS * 2;
      if constexpr (NT == 1) {
        ldsm_x2_t(brow, b[0]);
      } else {
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldsm_x4_t(brow + (16 * p + 8 * khalf) * 2, r);
          b[2 * p][0] = r[0];
          b[2 * p][1] = r[1];
          b[2 * p + 1][0] = r[2];
          b[2 * p + 1][1] = r[3];
        }
      }
    }
  };
  auto products = [&](int wrow0, int kk, const uint32_t (&a)[MT][4], const uint32_t (&b)[NB][2]) {
    if constexpr (kPipeB) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    } else {
      const uint32_t brow = w_u32 + (wrow0 + 16 * kk + (lane & 15)) * WS * 2;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t r[4];
        ldsm_x4_t(brow + (16 * p + 8 * khalf) * 2, r);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * p], a[mt], r[0], r[1]);
          mma_bf16(acc[mt][2 * p + 1], a[mt], r[2], r[3]);
        }
      }
    }
  };
  // ksteps >= 1 steps from tap t0 and weight row wrow0, two register sets
  // in turn
  auto run = [&](uint32_t base, int t0, int wrow0, int ksteps) {
    uint32_t a0[MT][4], a1[MT][4], b0[NB][2], b1[NB][2];
    load(base, t0, wrow0, 0, a0, b0);
    int kk = 0;
    for (; kk + 1 < ksteps; kk += 2) {
      load(base, t0, wrow0, kk + 1, a1, b1);
      products(wrow0, kk, a0, b0);
      if (kk + 2 < ksteps) load(base, t0, wrow0, kk + 2, a0, b0);
      products(wrow0, kk + 1, a1, b1);
    }
    if (kk < ksteps) products(wrow0, kk, a0, b0);
  };

  const int g = lane >> 2, tq = lane & 3;
  const int M = P.TZ * P.TY * P.TX;
  int buf = 0;
  for (;;) {
    const ClassPlan& cp = P.cls[cur.cls];
    const int taps = cp.kd * cp.kh * cp.kw;
    const uint32_t box = smem0 + buf * P.box_bytes;
    const int Tn = T + gridDim.x;
    const Tile nxt = tile_of(Tn < total ? Tn : T);
    const bool prefetch = P.nbuf == 2 && Tn < total && nxt.cls == cur.cls;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    if (!P.stream) {
      if (prefetch) stage_box(nxt, smem0 + (buf ^ 1) * P.box_bytes);
      else cp_async_commit();
      cp_async_wait<1>();   // all but a prefetch: this tile's box, the weights
      __syncthreads();
      // an odd unit count ends on the zero row: tap table -1, weights zero
      run(box, 0, 0, (taps * nch + 1) / 2);
    } else {
      // Cin % 16 == 0: the weights of taps [sl G, sl G + G) live in ring
      // stage sl & 1 while the next slice's copies are in flight
      const int G = P.stream, nsl = (taps + G - 1) / G;
      for (int sl = 0; sl < nsl; ++sl) {
        if (sl + 1 < nsl) {
          load_weights(cp, (sl + 1) * G, min(G, taps - (sl + 1) * G), ((sl + 1) & 1) * G * Cin);
          cp_async_commit();
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        run(box, sl * G, (sl & 1) * G * Cin, (min(taps, sl * G + G) - sl * G) * nch / 2);
        __syncthreads();
      }
    }

    // ---- epilogue: bias, ReLU, one cast; the tile through shared memory
    __syncthreads();   // the stage reuses this tile's box
    bf16* stage = reinterpret_cast<bf16*>(smem + buf * P.box_bytes);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = nt * 8 + 2 * tq;
      const float b0 = (bias != nullptr && col < P.Cout) ? bias[col] : 0.f;
      const float b1 = (bias != nullptr && col + 1 < P.Cout) ? bias[col + 1] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int row = (warp * MT + mt) * 16 + g;
        float v[4] = {acc[mt][nt][0] + b0, acc[mt][nt][1] + b1, acc[mt][nt][2] + b0,
                      acc[mt][nt][3] + b1};
        if (P.relu) {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = fmaxf(v[i], 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(stage + row * WS + col) =
            __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8) * WS + col) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
    }
    __syncthreads();
    for (int q = tid; q < M * NT; q += kThreads) {
      const int row = q / NT, co = (q - row * NT) * 8;
      if (co >= P.Cout) continue;
      const int rr = div_tx.div(row), lx = row - rr * P.TX;
      const int lz = div_ty.div(rr), ly = rr - lz * P.TY;
      const int gz = cur.gz0 + lz, gy = cur.gy0 + ly, gx = cur.gx0 + lx;
      if (gz >= cp.Dc || gy >= cp.Hc || gx >= cp.Wc) continue;
      const int oz = gz * P.osd + cp.oz, oy = gy * P.osh + cp.oy, ox = gx * P.osw + cp.ox;
      bf16* dst =
          out + ((((int64_t)cur.b * P.Dout + oz) * P.Hout + oy) * P.Wout + ox) * P.Cout + co;
      const bf16* src = stage + row * WS + co;
      if ((P.Cout & 7) == 0) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const int n = min(8, P.Cout - co);
        for (int i = 0; i < n; ++i) dst[i] = src[i];
      }
    }
    if (Tn >= total) break;
    __syncthreads();   // this tile's stage, tap table and weights are free
    if (!prefetch) {
      if (nxt.cls != cur.cls) set_class(P.cls[nxt.cls]);
      else if (P.stream) load_weights(cp, 0, min(P.stream, taps), 0);
      stage_box(nxt, smem0 + (P.nbuf == 2 ? buf ^ 1 : 0) * P.box_bytes);
    }
    if (P.nbuf == 2) buf ^= 1;
    T = Tn;
    cur = nxt;
  }
}

template <int NT, int MT, int WARPS>
int launch_t(const Plan& P, const void* x, const void* w, const void* bias, void* out,
             cudaStream_t stream) {
  auto kern = tc_conv_kernel<NT, MT, WARPS>;
  constexpr int kThreads = 32 * WARPS;
  if (P.smem_bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  // persistent: as many blocks as the card holds at once, or one per tile
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, P.smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)(P.persist ? min(P.grid_x, sms * per_sm) : P.grid_x));
  kern<<<grid, kThreads, P.smem_bytes, stream>>>(
      P, static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(out));
  return (int)cudaGetLastError();
}

// (nt, mt, warps) as ops/kernels/tc.py TILE_CHOICES allows them.
inline int launch(int nt, int mt, int warps, const int* plan, const void* x, const void* w,
                  const void* bias, void* out, void* stream) {
  Plan P;
  memcpy(&P, plan, sizeof(Plan));
  if (P.nclass < 1 || P.nclass > kMaxClasses || P.grid_x < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define MVS_TC_CASE(N_, M_, W_) \
  if (nt == N_ && mt == M_ && warps == W_) return launch_t<N_, M_, W_>(P, x, w, bias, out, s);
  MVS_TC_CASE(1, 8, 4)
  MVS_TC_CASE(1, 4, 4)
  MVS_TC_CASE(1, 2, 4)
  MVS_TC_CASE(2, 4, 4)
  MVS_TC_CASE(2, 2, 4)
  MVS_TC_CASE(2, 1, 4)
  MVS_TC_CASE(4, 4, 4)
  MVS_TC_CASE(4, 2, 4)
  MVS_TC_CASE(4, 1, 4)
  MVS_TC_CASE(8, 2, 4)
  MVS_TC_CASE(8, 1, 4)
  MVS_TC_CASE(16, 2, 4)
  MVS_TC_CASE(16, 1, 4)
  MVS_TC_CASE(1, 4, 8)
  MVS_TC_CASE(1, 2, 8)
  MVS_TC_CASE(2, 2, 8)
  MVS_TC_CASE(2, 1, 8)
  MVS_TC_CASE(4, 2, 8)
  MVS_TC_CASE(4, 1, 8)
  MVS_TC_CASE(8, 1, 8)
  MVS_TC_CASE(16, 1, 8)
#undef MVS_TC_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc
}  // namespace mvs
