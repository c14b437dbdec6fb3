// All-depth homography warp (K2) and its adjoint, the transposed warp (K3).
//
// K2 replaces the Pallas warp kernels of mvsnet_tpu/ops/pallas/sweep.py
// (_sweep_kernel via pallas_warp_all_depths at sweep.py:1599, and
// _make_warp_kernel_preload_group via _pallas_warp_all_depths_preload at
// :1538): out[d, y, x, c] = img sampled bilinearly, zero fill per tap, at
// H_d (x + 0.5, y + 0.5, 1) - 0.5; float32 blend, one cast to img's type.
// K3 replaces _transpose_kernel via _pallas_warp_transpose (sweep.py:1701):
// the exact adjoint in img, out[tap(d, y, x)] += weight * g[d, y, x, c],
// summed in float32. Both take their taps from common.cuh's `project`, as
// the cost volume K1 does, so the three sample identically.
//
// K2, bound by bytes: it writes D maps for the one it reads (192x the
// input at the training point). It is K1 (cost_volume.cu) with one view
// and no variance: a block owns 8 rows of 32 / (C / 8) pixels, one warp a
// row, and walks kRun depths; a lane of the pixel projects each (pixel,
// depth) once into its warp's table of taps in shared memory
// (common.cuh's tap_record), the lanes of a pixel read it as a broadcast,
// each tap is a predicated 16-byte load under L2 evict-last (the 1.2 MB
// map stays in L2 beside the output passing through), the output goes out
// in 16-byte streaming stores, and offsets within a map are 32-bit.
//
// K3, bound by bytes: it reads D cotangent maps and writes one. Its
// scatter form (each cotangent added into its four taps) needs atomics,
// which leave the order of the sums open from run to run. This kernel is
// a gather in which the owner computes: each output element (source pixel,
// 8 channels) is summed by exactly one thread in a fixed order (depth
// ascending, then its contributing reference pixels in row-major order),
// written once, 0 where nothing contributes, so two calls are equal bit
// for bit and the output needs no memset.
//  1. A block owns a tile of 8 source rows (one warp a row) of 32 / G
//     pixels, a lane CPL = 32, 16 or 8 of a pixel's channels (G = C / CPL
//     lanes a pixel; at C = 32 a lane sums all 32 channels of its pixel, so
//     the search below is paid once a pixel), and walks a run of depths.
//     In plane d the reference pixels that feed source pixel (u, v) are
//     those whose top-left tap lies in {u - 1, u} x {v - 1, v}: their
//     projections lie in the square [u - 1, u + 1) x [v - 1, v + 1).
//  2. Bounds come from the inverse homography (`inv`, from the plan:
//     float64, one thread a plane, launched just before by the wrapper). Where a source
//     square's corners all map back to the side of the horizon (w = 0)
//     that the whole reference map is on (`wsign`, +1 or -1), its preimage
//     is the convex quadrilateral of the corners' preimages, so the
//     contributors are the integer pixels within kEps (plus kEpsRel of the
//     extent, for float32 rounding) of their span. A tile's box is that
//     span for the tile's source box; an owner's window, for its own
//     square. A plane on which w changes sign or nears 0 (`wsign` 0), or a
//     square that reaches the horizon, takes the whole map: slow, rare,
//     exact.
//  3. Membership is never decided from the inverse: the block projects
//     every pixel of the box with `project` itself, once, into a shared
//     table of top-left taps relative to the tile and weights, so a
//     contributor is exactly one of K2's and K1's float32 taps. The
//     corners of every owner's square form a grid of (32 / G + 2) x 10
//     source points, mapped back once a plane into shared memory.
//  4. The block stages the box's cotangents (its rows are contiguous runs
//     of g) into shared memory by 16-byte cp.async, in an XOR-swizzled
//     layout (lanes reading neighbouring pixels hit every bank). Two
//     buffers: while the owners sum plane k from one, the next plane's
//     copies, table and grid go into the other, so one barrier a plane.
//     Each owner walks its window (some 2 x 2 to 3 x 3 pixels at the
//     training point) in the table and adds weight * g from shared memory
//     where its pixel is one of the entry's taps. A fill holds P pixels
//     (384 at C = 32 in float32: 96 KB of cotangents in two buffers, two
//     blocks an SM); a box of more (the whole-map route) is cut into fills
//     by rows, then columns, so the order within such a plane is fill by
//     fill, still fixed. At dx/du ~ 1 (the DTU-like training point) an
//     8 x 32 tile's box is about 10 x 35 pixels: each cotangent is read
//     about 1.4 times from L2 and about once from device memory.
//  5. 75 tiles at the training point are too few blocks for 132 SMs, so
//     the depths split into runs (blockIdx.y; enough for one wave of two
//     blocks an SM, `ops/kernels/warp.transpose_segments`), each summed
//     apart into a partial map, and a second kernel adds the partials in
//     run order: a fixed order still.
//  A first form of this gather read each contributor's cotangent from
//  device memory in the owner's loop, and stalled a memory latency per
//  contributor; a second scanned each owner's candidate rows of the box's
//  table. Both were slower than the scatter (PERF.md).
//
// Row blocks (multi-device training, `parallel/`): both kernels take the
// reference rows [row_offset, row_offset + Hr) of an H-row map, as the
// cost kernel's K1s does. K2 writes the block (D, Hr, W, C) and projects
// its global rows; K3 reads the block's cotangents and writes the whole
// source map, its boxes and windows clipped to the block's rows (the plan
// bounds w over them). row_offset = 0, Hr = H is the whole map; a row
// block of K2 is the same arithmetic per pixel as the whole launch.
#include "common.cuh"

namespace {

using mvs::bf16;

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;   // tile rows, one warp each
constexpr int kRun = 16;               // depths a K2 block walks
constexpr int kChunk = 8;              // depths whose taps share one K2 table
constexpr int kCap = 512;              // K3 pixels per fill at most
constexpr int kStageBytes = 96 * 1024; // K3's two cotangent buffers
constexpr float kEps = 0.05f;          // K3 margin of a preimage span, reference pixels,
constexpr float kEpsRel = 0.01f;       // plus this share of its extent

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
warp_kernel(const T* __restrict__ img, const float* __restrict__ homs, T* __restrict__ out,
            int D, int Hr, int H, int W, int C, int row_offset, int tiles_x) {
  // per warp, [kChunk][TX] taps (common.cuh's tap_record)
  extern __shared__ int4 table[];
  const int G = C >> 3, TX = 32 / G;
  const int tile_y = blockIdx.x / tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = tile_y * kRows + warp, tx0 = (blockIdx.x - tile_y * tiles_x) * TX;
  if (y >= Hr) return;  // a warp owns its row: no barrier below is shared
  int4* wt = table + warp * kChunk * TX;
  const int d0 = blockIdx.y * kRun, d1 = min(D, d0 + kRun);
  const int px = lane / G, g = lane - px * G;
  const int x = tx0 + px;
  const bool mine = px < TX && x < W;
  const int plane = Hr * W * C;
  const int off = (y * W + x) * C + g * 8;     // in a depth plane of out
  const uint64_t keep = mvs::l2_evict_last();
  const T* src = img + g * 8;

  for (int dc = d0; dc < d1; dc += kChunk) {
    const int nd = min(kChunk, d1 - dc);
    __syncwarp();   // the previous chunk's table is consumed
    for (int q = lane; q < nd * TX; q += 32) {
      const int dd = q / TX, p = q - dd * TX;
      wt[q] = tx0 + p < W ? mvs::tap_record(homs + (dc + dd) * 9, tx0 + p, row_offset + y,
                                            H, W, C, 0)
                          : make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    if (!mine) continue;
    for (int dd = 0; dd < nd; ++dd) {
      float val[8];
      mvs::sample_record(src, wt[dd * TX + px], W, C, keep, val);
      mvs::store8_streaming(out + (int64_t)(dc + dd) * plane + off, val);
    }
  }
}

// The preimage (x, y), in reference pixel indices, of the source image
// point (U, V) (pixel centres at +0.5) through inv = H_d^-1; false where it
// does not lie, with margin, on the side of the horizon (w = 0) that the
// reference map is on (wsign), or is not finite. Z = 1 / w there.
__device__ __forceinline__ bool preimage(const float* __restrict__ inv, int wsign, float U,
                                         float V, float& x, float& y) {
  const float X = inv[0] * U + inv[1] * V + inv[2];
  const float Y = inv[3] * U + inv[4] * V + inv[5];
  const float Z = inv[6] * U + inv[7] * V + inv[8];
  const float zmag = fabsf(inv[6] * U) + fabsf(inv[7] * V) + fabsf(inv[8]);
  if (!((float)wsign * Z > 1e-4f * zmag)) return false;
  const float rz = __frcp_rn(Z);   // a bound, not a tap: one reciprocal will do
  x = X * rz - 0.5f;
  y = Y * rz - 0.5f;
  return isfinite(x) && isfinite(y);
}

// e / n for 0 <= e < 2^16 and 1 <= n <= 512, rn = 1 / n, by a float
// multiply: a quotient's fraction is 0 or at least 1 / n from the next
// integer, far beyond the product's rounding, so the 1e-3 nudge is exact.
__device__ __forceinline__ int quot(int e, float rn) { return (int)((float)e * rn + 1e-3f); }

// [lo, hi]: the integers within kEps (plus kEpsRel of the extent) of
// [a, b], clipped to [first, last]; the float bounds are clamped before the
// int conversions (far-off bounds leave the map anyway).
__device__ __forceinline__ void span(float a, float b, int first, int last, int& lo, int& hi) {
  const float e = kEps + kEpsRel * (b - a);
  lo = max(first, (int)ceilf(fmaxf(a - e, (float)first - 8.f)));
  hi = min(last, (int)floorf(fminf(b + e, (float)last + 9.f)));
}

// The reference pixels [x0, x1] x [y0, y1] (inclusive; empty when x1 < x0)
// whose projections by H_d can lie in the source box of the tile at (u0,
// v0): the span of its corners' preimages (grid points (0, 0) and (TX + 1,
// kRows + 1) of the note's item 3), or the whole block of reference rows
// [r0, r0 + Hr).
__device__ __forceinline__ int4 tile_box(const float* __restrict__ inv, int wsign, int u0,
                                         int v0, int TX, int Hr, int r0, int W) {
  const int4 whole = make_int4(0, r0, W - 1, r0 + Hr - 1);
  if (wsign == 0) return whole;
  float xlo = INFINITY, xhi = -INFINITY, ylo = INFINITY, yhi = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float x, y;
    if (!preimage(inv, wsign, (float)(u0 + ((k & 1) ? TX + 1 : 0)) - 0.5f,
                  (float)(v0 + ((k >> 1) ? kRows + 1 : 0)) - 0.5f, x, y))
      return whole;
    xlo = fminf(xlo, x);
    xhi = fmaxf(xhi, x);
    ylo = fminf(ylo, y);
    yhi = fmaxf(yhi, y);
  }
  int4 b;
  span(xlo, xhi, 0, W - 1, b.x, b.z);
  span(ylo, yhi, r0, r0 + Hr - 1, b.y, b.w);
  return b;
}

// K3's grid of (TX + 2) x (kRows + 2) preimages, rounded up to 16 bytes.
__host__ __device__ __forceinline__ int grid_slots(int TX) {
  return ((TX + 2) * (kRows + 2) + 1) & ~1;
}

// One fill of K3's shared memory: rows [r0, r0 + nr) and columns [c0, c0 +
// fw) of plane d's box (relative to it), nr * fw <= P pixels; d == D when
// none is left.
struct Fill {
  int d, r0, c0, nr, fw;
  int4 b;   // the box: x0, y0, x1, y1
};

// Advances f (f.d = -1: to the first fill) to the next column chunk of its
// rows, else its next rows, else the first rows of the next plane whose box
// is not empty. Every thread of a block computes the same fills.
__device__ __forceinline__ void next_fill(Fill& f, const int4* __restrict__ boxes, int D,
                                          int P) {
  if (f.d >= 0) {
    const int bw = f.b.z - f.b.x + 1, bh = f.b.w - f.b.y + 1;
    f.c0 += f.fw;
    if (f.c0 < bw) {
      f.fw = min(P, bw - f.c0);
      return;
    }
    f.c0 = 0;
    f.r0 += f.nr;
    if (f.r0 < bh) {
      f.fw = min(P, bw);
      f.nr = min(P / f.fw, bh - f.r0);
      return;
    }
  }
  for (++f.d; f.d < D; ++f.d) {
    f.b = boxes[f.d];
    if (f.b.z < f.b.x || f.b.w < f.b.y) continue;
    f.r0 = f.c0 = 0;
    f.fw = min(P, f.b.z - f.b.x + 1);
    f.nr = min(P / f.fw, f.b.w - f.b.y + 1);
    return;
  }
}

// K3's shared-memory layout of one fill's cotangents: pixel e of the fill
// (e = r fw + c) holds NC = C sizeof(T) / 16 units of 16 bytes, chunk k at
// unit e NC + (k ^ swz(e)). The XOR spreads the lanes that read one chunk
// of neighbouring pixels over every bank: swz takes m = min(3, log2 of NC's
// largest power-of-2 factor) bits of e above bit 3 - m, so it permutes
// chunks only within aligned runs of 2^m.
struct Swizzle {
  int sh, mask;
  __device__ __forceinline__ explicit Swizzle(int NC) {
    const int m = min(3, __ffs(NC) - 1);
    sh = 3 - m;
    mask = (1 << m) - 1;
  }
  __device__ __forceinline__ int unit(int e, int NC, int k) const {
    return e * NC + (k ^ ((e >> sh) & mask));
  }
};

// The block's asynchronous copy of a fill's cotangents into shared memory
// at base, as Swizzle lays them out. Warp w copies rows w, w + 8, ...
// (each a contiguous run of fw NC units in g, whose Hr rows start at
// reference row r0), its lanes a unit at a time; lg is log2 NC, or -1
// where NC is no power of 2.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ g, const Fill& f, uint32_t base,
                                      int Hr, int r0, int W, int C, int NC, int lg,
                                      Swizzle sw) {
  const int vpr = f.fw * NC;
  const char* src = reinterpret_cast<const char*>(
      g + (((int64_t)f.d * Hr + f.b.y + f.r0 - r0) * W + f.b.x + f.c0) * C);
  const int64_t row_bytes = (int64_t)W * C * sizeof(T);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < f.nr; r += kRows) {
    for (int k = lane; k < vpr; k += 32) {
      const int c = lg >= 0 ? k >> lg : k / NC;
      mvs::cp_async16(base + 16u * sw.unit(r * f.fw + c, NC, k - c * NC),
                      src + r * row_bytes + 16 * k, 16);
    }
  }
}

// acc[j] += wgt * the unit's elements (4 float32 or 8 bfloat16), j < 16 /
// sizeof(T): one 16-byte unit read from shared memory.
__device__ __forceinline__ void fma_unit(const uint4* p, float wgt, float* acc) {
  const uint4 u = *p;
  acc[0] = fmaf(wgt, __uint_as_float(u.x), acc[0]);
  acc[1] = fmaf(wgt, __uint_as_float(u.y), acc[1]);
  acc[2] = fmaf(wgt, __uint_as_float(u.z), acc[2]);
  acc[3] = fmaf(wgt, __uint_as_float(u.w), acc[3]);
}
__device__ __forceinline__ void fma_unit_bf16(const uint4* p, float wgt, float* acc) {
  mvs::Raw8<bf16> r;
  r.v = *p;
  float v[8];
  r.to_float(v);
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = fmaf(wgt, v[j], acc[j]);
}

// K3's plan of each plane (one thread a plane, float64), as the Python
// reference `ops/kernels/warp.transpose_plan` computes it: inv = H_d^-1 by
// the adjugate, cast to float32; wsign the sign of w = h6 (x + 0.5) + h7
// (y + 0.5) + h8 at the four corner pixels of the reference rows [r0, r0 +
// H) when all four agree beyond 1e-7 plus a float32 rounding margin (w is
// affine, so its corners bound it over the rows), else 0; 0 too where the
// inverse is not finite.
__global__ void plan_kernel(const float* __restrict__ homs, float* __restrict__ inv,
                            int* __restrict__ wsign, int D, int H, int r0, int W) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;
  double h[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) h[i] = homs[d * 9 + i];
  const double a[9] = {h[4] * h[8] - h[5] * h[7], h[2] * h[7] - h[1] * h[8],
                       h[1] * h[5] - h[2] * h[4], h[5] * h[6] - h[3] * h[8],
                       h[0] * h[8] - h[2] * h[6], h[2] * h[3] - h[0] * h[5],
                       h[3] * h[7] - h[4] * h[6], h[1] * h[6] - h[0] * h[7],
                       h[0] * h[4] - h[1] * h[3]};
  const double det = h[0] * a[0] + h[1] * a[3] + h[2] * a[6];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    const float v = (float)(a[i] / det);
    ok = ok && isfinite(v);
    inv[d * 9 + i] = v;
  }
  bool pos = true, neg = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double px = (k & 1) ? W - 0.5 : 0.5, py = (k >> 1) ? r0 + H - 0.5 : r0 + 0.5;
    const double w = h[6] * px + h[7] * py + h[8];
    const double margin = 1e-7 + 1e-6 * (fabs(h[6]) * px + fabs(h[7]) * py + fabs(h[8]));
    pos = pos && w > margin;
    neg = neg && w < -margin;
  }
  wsign[d] = ok ? (pos ? 1 : (neg ? -1 : 0)) : 0;
}

// A lane owns CPL channels (8, 16 or 32) of one source pixel: G = C / CPL
// lanes a pixel, 32 / G pixels a warp row. g holds the reference rows [r0,
// r0 + Hr); the source map (out) is H x W. Output: out, or with several
// depth segments (blockIdx.y) the segment's partial sums at out + s H W C.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, 2)
warp_transpose_kernel(const T* __restrict__ g, const float* __restrict__ homs,
                      const float* __restrict__ inv, const int* __restrict__ wsign,
                      float* __restrict__ out, int D, int Hr, int H, int W, int C, int r0,
                      int tiles_x, int P, int dseg) {
  // two buffers each of: a fill's cotangents ([P][NC] units, Swizzle's
  // layout), its table (per pixel: tap column - u0 and tap row - v0 in 16
  // bits each, fx, fy) and its plane's grid of preimages; then the tile's
  // boxes of this segment's planes
  extern __shared__ int4 smem[];
  constexpr int EPU = 16 / sizeof(T);          // elements a unit
  const int G = C / CPL, TX = 32 / G, GX = TX + 2, NG = GX * (kRows + 2);
  const int NC = C * (int)sizeof(T) / 16;
  const int lg = (NC & (NC - 1)) == 0 ? __ffs(NC) - 1 : -1;
  const Swizzle sw(NC);
  const uint4* gs = reinterpret_cast<const uint4*>(smem);
  const uint32_t gs_base = mvs::smem_u32(smem);
  int4* boxes = smem + 2 * P * NC;
  float2* grid = reinterpret_cast<float2*>(boxes + dseg);           // [2][grid_slots]
  int* cxy = reinterpret_cast<int*>(grid + 2 * grid_slots(TX));    // [2][P]
  float* wfx = reinterpret_cast<float*>(cxy + 2 * P);              // [2][P]
  float* wfy = wfx + 2 * P;                                        // [2][P]
  const int tile_y = blockIdx.x / tiles_x;
  const int u0 = (blockIdx.x - tile_y * tiles_x) * TX, v0 = tile_y * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int px = lane / G, cg = lane - px * G;   // the owner: tile pixel (px, warp)
  const bool mine = px < TX && u0 + px < W && v0 + warp < H;
  const float rgx = 1.f / (float)GX;
  const int d0 = blockIdx.y * dseg, nd = min(D, d0 + dseg) - d0;
  const T* gd = g + (int64_t)d0 * Hr * W * C;

  for (int d = threadIdx.x; d < nd; d += kThreads)
    boxes[d] = tile_box(inv + (d0 + d) * 9, wsign[d0 + d], u0, v0, TX, Hr, r0, W);
  __syncthreads();

  // fill f's table and its plane's grid into buffer b
  auto build = [&](const Fill& f, int b) {
    const int d = d0 + f.d, x0 = f.b.x + f.c0, y0 = f.b.y + f.r0;
    const float* h = homs + d * 9;
    const float rfw = 1.f / (float)f.fw;
    for (int e = threadIdx.x; e < f.nr * f.fw; e += kThreads) {
      const int r = quot(e, rfw), c = e - r * f.fw;
      const mvs::Taps t = mvs::project(h, x0 + c, y0 + r, H, W);
      cxy[b * P + e] = ((t.x0 - u0) & 0xffff) | ((t.y0 - v0) << 16);
      wfx[b * P + e] = t.fx;
      wfy[b * P + e] = t.fy;
    }
    const int ws = wsign[d];
    float2* gr = grid + b * grid_slots(TX);
    for (int q = threadIdx.x; q < NG; q += kThreads) {
      const int j = quot(q, rgx), i = q - j * GX;
      float x = NAN, y = NAN;
      if (ws == 0 || !preimage(inv + d * 9, ws, (float)(u0 + i) - 0.5f,
                               (float)(v0 + j) - 0.5f, x, y))
        x = y = NAN;
      gr[q] = make_float2(x, y);
    }
  };

  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  Fill cur;
  cur.d = -1;
  next_fill(cur, boxes, nd, P);
  if (cur.d < nd) {
    stage(gd, cur, gs_base, Hr, r0, W, C, NC, lg, sw);
    mvs::cp_async_commit();
    build(cur, 0);
    mvs::cp_async_wait<0>();
  }
  __syncthreads();
  // one barrier a fill: fill k + 1's copies, table and grid go into the
  // buffer that fill k - 1 used, read before the previous barrier
  for (int buf = 0; cur.d < nd; buf ^= 1) {
    Fill nxt = cur;
    next_fill(nxt, boxes, nd, P);
    if (nxt.d < nd) {
      stage(gd, nxt, gs_base + 16u * ((buf ^ 1) * P * NC), Hr, r0, W, C, NC, lg, sw);
      mvs::cp_async_commit();
      build(nxt, buf ^ 1);
    }
    if (mine) {
      // the owner's window: the span of its tap cell's preimage (source
      // points (u - 0.5 .. u + 1.5) x (v - 0.5 .. v + 1.5)), else the map
      const float2* gr = grid + buf * grid_slots(TX);
      const float2 p00 = gr[warp * GX + px], p01 = gr[warp * GX + px + 2];
      const float2 p10 = gr[(warp + 2) * GX + px], p11 = gr[(warp + 2) * GX + px + 2];
      int xlo = 0, xhi = W - 1, ylo = r0, yhi = r0 + Hr - 1;
      if (isfinite(p00.x) && isfinite(p01.x) && isfinite(p10.x) && isfinite(p11.x)) {
        span(fminf(fminf(p00.x, p01.x), fminf(p10.x, p11.x)),
             fmaxf(fmaxf(p00.x, p01.x), fmaxf(p10.x, p11.x)), 0, W - 1, xlo, xhi);
        span(fminf(fminf(p00.y, p01.y), fminf(p10.y, p11.y)),
             fmaxf(fmaxf(p00.y, p01.y), fmaxf(p10.y, p11.y)), r0, r0 + Hr - 1, ylo, yhi);
      }
      const int x0 = cur.b.x + cur.c0, y0 = cur.b.y + cur.r0;
      const int r1 = min(yhi, y0 + cur.nr - 1) - y0, c1 = min(xhi, x0 + cur.fw - 1) - x0;
      const uint4* gb = gs + buf * P * NC;
      const int* tc = cxy + buf * P;
      for (int r = max(ylo, y0) - y0; r <= r1; ++r) {
        for (int c = max(xlo, x0) - x0; c <= c1; ++c) {
          const int e = r * cur.fw + c, cell = tc[e];
          const int dx = px - (int)(short)(cell & 0xffff), dy = warp - (cell >> 16);
          if ((unsigned)dx > 1u || (unsigned)dy > 1u) continue;
          const float fx = wfx[buf * P + e], fy = wfy[buf * P + e];
          const float wgt = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
#pragma unroll
          for (int q = 0; q < CPL / EPU; ++q) {
            const uint4* p = gb + sw.unit(e, NC, cg * (CPL / EPU) + q);
            if constexpr (EPU == 4) fma_unit(p, wgt, acc + 4 * q);
            else fma_unit_bf16(p, wgt, acc + 8 * q);
          }
        }
      }
    }
    mvs::cp_async_wait<0>();   // the next fill's copies, issued above
    __syncthreads();
    cur = nxt;
  }
  if (mine) {
    float* o = out + (int64_t)blockIdx.y * H * W * C + ((v0 + warp) * W + u0 + px) * C +
               cg * CPL;
#pragma unroll
    for (int q = 0; q < CPL / 8; ++q) mvs::store8(o + 8 * q, acc + 8 * q);
  }
}

// out = the sum of the segments' partials part[s], s ascending (n
// elements each, n % 4 == 0), in float4 vectors.
__global__ void segment_sum_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                   int n4, int segments) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < segments; ++s) {
    const float4 b = part[(int64_t)s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

template <typename T>
int launch_warp(const void* img, const void* homs, void* out, int D, int Hr, int H, int W,
                int C, int row_offset, cudaStream_t s) {
  auto kern = warp_kernel<T>;
  const int TX = 32 / (C / 8);
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (Hr + kRows - 1) / kRows;
  const size_t smem = sizeof(int4) * kChunk * kRows * TX;   // 32 KB at most
  // a quarter of the SM's 256 KB as shared memory: the rest is L1 for the taps
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 25);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)((D + kRun - 1) / kRun));
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(img), static_cast<const float*>(homs),
                                    static_cast<T*>(out), D, Hr, H, W, C, row_offset, tiles_x);
  return (int)cudaGetLastError();
}

template <typename T, int CPL>
int launch_transpose(const void* g, const void* homs, const void* inv, const void* wsign,
                     void* out, void* part, int segments, int D, int Hr, int H, int W, int C,
                     int r0, cudaStream_t s) {
  auto kern = warp_transpose_kernel<T, CPL>;
  const int TX = 32 / (C / CPL), NC = C * (int)sizeof(T) / 16;
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (H + kRows - 1) / kRows;
  const int dseg = (D + segments - 1) / segments;
  // a fill's pixels: two buffers of cotangents in kStageBytes, at most kCap
  const int P = min(kCap, kStageBytes / (2 * 16 * NC));
  const size_t smem = 2 * 16 * (size_t)P * NC + sizeof(int4) * dseg +
                      2 * sizeof(float2) * grid_slots(TX) + 2 * 12 * (size_t)P;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)segments);
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const float*>(homs),
      static_cast<const float*>(inv), static_cast<const int*>(wsign),
      static_cast<float*>(segments > 1 ? part : out), D, Hr, H, W, C, r0, tiles_x, P, dseg);
  if (segments == 1) return (int)cudaGetLastError();
  if (cudaError_t e2 = cudaGetLastError()) return (int)e2;
  const int n4 = H * W * C / 4;
  segment_sum_kernel<<<(unsigned)((n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float4*>(part), static_cast<float4*>(out), n4, segments);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_transpose(const void* g, const void* homs, const void* inv, const void* wsign,
                     void* out, void* part, int segments, int D, int Hr, int H, int W, int C,
                     int r0, cudaStream_t s) {
  if (C % 32 == 0)
    return launch_transpose<T, 32>(g, homs, inv, wsign, out, part, segments, D, Hr, H, W, C,
                                   r0, s);
  if (C % 16 == 0)
    return launch_transpose<T, 16>(g, homs, inv, wsign, out, part, segments, D, Hr, H, W, C,
                                   r0, s);
  return launch_transpose<T, 8>(g, homs, inv, wsign, out, part, segments, D, Hr, H, W, C, r0,
                                s);
}

// The sizes both kernels take: C a multiple of 8 up to 256 (a pixel's lanes
// fit a warp), a map under 2^31 elements (32-bit offsets within it), and a
// block of reference rows [r0, r0 + Hr) inside its H rows.
bool sizes_ok(int D, int Hr, int H, int W, int C, int r0) {
  return C % 8 == 0 && C >= 8 && C <= 256 && D >= 1 && Hr >= 1 && W >= 1 && r0 >= 0 &&
         r0 + Hr <= H && (int64_t)H * W * C < ((int64_t)1 << 31);
}

}  // namespace

// img (H, W, C), homs (D, 3, 3) float32, out (D, Hr, W, C) in img's type:
// the reference rows [row_offset, row_offset + Hr); sizes as sizes_ok,
// D / 16 <= 65535, all contiguous. Returns cudaGetLastError().
extern "C" int warp_launch(int dtype, const void* img, const void* homs, void* out,
                           int D, int Hr, int H, int W, int C, int row_offset, void* stream) {
  if (!sizes_ok(D, Hr, H, W, C, row_offset) || (D + kRun - 1) / kRun > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == mvs::kFloat32)
    return launch_warp<float>(img, homs, out, D, Hr, H, W, C, row_offset, s);
  if (dtype == mvs::kBFloat16)
    return launch_warp<bf16>(img, homs, out, D, Hr, H, W, C, row_offset, s);
  return (int)cudaErrorInvalidValue;
}

// K3's plan (plan_kernel): homs (D, 3, 3) float32 -> inv (D, 3, 3)
// float32, wsign (D,) int32, over the reference rows [r0, r0 + Hr) of width
// W. Returns cudaGetLastError().
extern "C" int warp_plan_launch(const void* homs, void* inv, void* wsign, int D, int Hr,
                                int r0, int W, void* stream) {
  if (D < 1 || Hr < 1 || r0 < 0 || W < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  plan_kernel<<<(unsigned)((D + 127) / 128), 128, 0, s>>>(
      static_cast<const float*>(homs), static_cast<float*>(inv), static_cast<int*>(wsign), D,
      Hr, r0, W);
  return (int)cudaGetLastError();
}

// g (D, Hr, W, C) in float32 or bfloat16, the cotangents of the reference
// rows [row_offset, row_offset + Hr), homs (D, 3, 3) float32 and their plan
// over those rows from warp_plan_launch (inv (D, 3, 3) float32, wsign (D,)
// int32), out (H, W, C) float32, every element written; the depths split
// into `segments` runs (1 <= segments <= D) summed apart into part
// (segments, H, W, C) float32 scratch (unused for 1), then in order into
// out; sizes as sizes_ok, all contiguous. Returns cudaGetLastError().
extern "C" int warp_transpose_launch(int dtype, const void* g, const void* homs,
                                     const void* inv, const void* wsign, void* out, void* part,
                                     int segments, int D, int Hr, int H, int W, int C,
                                     int row_offset, void* stream) {
  if (!sizes_ok(D, Hr, H, W, C, row_offset) || segments < 1 || segments > D ||
      segments > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == mvs::kFloat32)
    return launch_transpose<float>(g, homs, inv, wsign, out, part, segments, D, Hr, H, W, C,
                                   row_offset, s);
  if (dtype == mvs::kBFloat16)
    return launch_transpose<bf16>(g, homs, inv, wsign, out, part, segments, D, Hr, H, W, C,
                                  row_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* warp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
