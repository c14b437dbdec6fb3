// Fused plane-sweep warp + variance cost volume for one batch element.
//
// Replaces the Pallas cost kernels of mvsnet_tpu/ops/pallas/sweep.py
// (_make_cost_kernel_preload_group, _make_cost_kernel_preload and
// _make_cost_kernel, launched at sweep.py:1094, :1322 and :1888), which
// compute one function in three editions (K1), and their row- and
// depth-sliced edition of multi-device serving (K1s: sweep.py:2032 in
// pallas_sweep_cost_volume_sharded, and the row_offset / out_rows path of
// _pallas_cost_volume_preload, sweep.py:1233-1260). K1s is this kernel
// with a row offset: the reference map and the output hold Hl rows that
// start at global row row_offset, the source maps hold all H rows, and
// the homographies hold the rank's depth slab. Each thread indexes ref and
// out by its local row and projects its global row row_offset + y against
// the full height H, so every element is K1's arithmetic on the same
// inputs; row_offset = 0, Hl = H is K1.
//
// out[d, y, x, c] = mean_v(f_v^2) - mean_v(f_v)^2 over the reference view
// and the V-1 source views, where f_v is source map v sampled bilinearly,
// with zero fill per tap, at H_vd (x + 0.5, y + 0.5, 1) - 0.5 (the taps of
// common.cuh, which the warp kernels K2 and K3 share). Coordinates,
// weights and the running sums are float32, summed as ref, then the views
// in order; the means are sums times 1 / V. The output is written once, in
// the input's type. No warped volume of any view ever reaches device memory.
//
// Bound on the H100: bytes. The output (D, h, w, C) is D/V times the size
// of the inputs (64 times at the operating point: 764 MB of bf16 against
// 12 MB read, 0.23 ms at 3.35 TB/s), and the arithmetic is a few dozen
// operations per output element. Behind the output come the gathers: each
// 16-byte output vector takes four 16-byte taps from each source view, 6 GB
// of loads at the operating point, which must hit L1 to stay under the
// output's time. The design:
//  1. A block owns a tile of 8 rows of 32 / (C / 8) reference pixels (8 at
//     C = 32; lanes past the last whole pixel idle), one warp a row, the
//     C / 8 lanes of a pixel each 8 channels, so a warp stores 512
//     contiguous bytes; and it walks a run of kRun depths in its inner
//     loop. The taps of neighbouring depths lie a
//     fraction of a pixel apart on the epipolar line, so they hit L1; the
//     reference values, loaded once per pixel, carry over every depth.
//  2. Each projection (two float32 divisions) is computed once per (pixel,
//     view, depth), by one lane of the pixel's warp, into the warp's table
//     of taps in shared memory for kChunk depths at a time, which the lanes
//     of a pixel read as one broadcast (the old design repeated it on every
//     channel group). A warp owns its row and its table, so it meets only
//     __syncwarp, never a block-wide barrier.
//  3. Every thread's work per output is a few hundred instructions, which
//     at 47.8 M outputs of 16 bytes is itself near half a millisecond of
//     issue: index arithmetic is 32-bit within a map (the launcher checks
//     the sizes), a depth plane's base is one 64-bit offset, the table
//     holds each tap's offset and in-map bits, a tap outside the map is a
//     predicated-off load (zero fill without a branch), a view's four taps
//     are loaded as raw 16-byte vectors before its blend, and the means
//     multiply by 1 / V. (Loading two views' taps before the first blend,
//     or holding four blocks an SM, measured slower: more registers, fewer
//     warps; PERF.md.) The table entries and the tap gather are
//     common.cuh's tap_record and sample_record, which the warp K2 shares.
//  4. The output goes out with streaming stores (st.global.cs) and the
//     source maps come in under an L2 evict-last policy, so that the 764 MB
//     of output passing through L2 does not evict the 8 MB of maps.
#include "common.cuh"

namespace {

using mvs::bf16;

constexpr int kThreads = 256;
constexpr int kRows = kThreads / 32;   // tile rows, one warp each
constexpr int kRun = 16;               // depths a block walks
constexpr int kChunk = 4;              // depths whose taps share one table

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
cost_volume_kernel(const T* __restrict__ ref, const T* __restrict__ views,
                   const float* __restrict__ homs, T* __restrict__ out,
                   int V1, int D, int Hl, int H, int W, int C, int row_offset, int tiles_x) {
  // per warp, [kChunk][V1][TX] taps: offset of the top-left tap in the
  // views, which of the four taps lie inside the map (bits 00, 01, 10,
  // 11), fx, fy
  extern __shared__ int4 table[];
  const int G = C >> 3, TX = 32 / G;
  const int tile_y = blockIdx.x / tiles_x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int y = tile_y * kRows + warp, tx0 = (blockIdx.x - tile_y * tiles_x) * TX;
  if (y >= Hl) return;   // a warp owns its row: no barrier below is shared
  int4* wt = table + warp * kChunk * V1 * TX;
  const int d0 = blockIdx.y * kRun, d1 = min(D, d0 + kRun);
  const int px = lane / G, g = lane - px * G;
  const int x = tx0 + px;
  const bool mine = px < TX && x < W;
  const int plane = H * W * C;                 // a source map
  const int off = (y * W + x) * C + g * 8;     // in ref and in a depth plane of out
  const uint64_t keep = mvs::l2_evict_last();
  const float inv = 1.f / (float)(V1 + 1);

  float r[8];
  if (mine) mvs::load8(ref + off, r);

  for (int dc = d0; dc < d1; dc += kChunk) {
    const int nd = min(kChunk, d1 - dc);
    __syncwarp();   // the previous chunk's table is consumed
    for (int q = lane; q < nd * V1 * TX; q += 32) {
      const int dv = q / TX, p = q - dv * TX;   // dv = dd * V1 + v
      const int dd = dv / V1, v = dv - dd * V1;
      wt[q] = tx0 + p < W ? mvs::tap_record(homs + ((int64_t)v * D + dc + dd) * 9, tx0 + p,
                                            row_offset + y, H, W, C, v * plane)
                          : make_int4(0, 0, 0, 0);
    }
    __syncwarp();
    if (!mine) continue;
    const T* img = views + g * 8;
    for (int dd = 0; dd < nd; ++dd) {
      float s[8], s2[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = r[j];
        s2[j] = s[j] * s[j];
      }
      for (int v = 0; v < V1; ++v) {
        float val[8];
        mvs::sample_record(img, wt[(dd * V1 + v) * TX + px], W, C, keep, val);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j] += val[j];
          s2[j] += val[j] * val[j];
        }
      }
      float o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float mean = s[j] * inv;
        o[j] = s2[j] * inv - mean * mean;
      }
      mvs::store8_streaming(out + (int64_t)(dc + dd) * Hl * W * C + off, o);
    }
  }
}

template <typename T>
int launch(const void* ref, const void* views, const void* homs, void* out, int V1, int D,
           int Hl, int H, int W, int C, int row_offset, cudaStream_t s) {
  auto kern = cost_volume_kernel<T>;
  const int TX = 32 / (C / 8);
  const int tiles_x = (W + TX - 1) / TX, tiles_y = (Hl + kRows - 1) / kRows;
  const size_t smem = sizeof(int4) * kChunk * V1 * kRows * TX;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // a quarter of the SM's 256 KB as shared memory: the rest is L1 for the taps
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, 25);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(tiles_x * tiles_y), (unsigned)((D + kRun - 1) / kRun));
  kern<<<grid, kThreads, smem, s>>>(static_cast<const T*>(ref), static_cast<const T*>(views),
                                    static_cast<const float*>(homs), static_cast<T*>(out), V1, D,
                                    Hl, H, W, C, row_offset, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// ref (Hl, W, C): rows [row_offset, row_offset + Hl) of the reference map;
// views (V1, H, W, C); homs (V1, D, 3, 3) float32; out (D, Hl, W, C);
// C % 8 == 0 and C <= 256, V1 * H * W * C < 2^31, all contiguous.
// Returns cudaGetLastError().
extern "C" int cost_volume_launch(int dtype, const void* ref, const void* views,
                                  const void* homs, void* out, int V1, int D,
                                  int Hl, int H, int W, int C, int row_offset,
                                  void* stream) {
  if (C % 8 != 0 || C > 256 || V1 < 1 || D < 1 || row_offset < 0 ||
      Hl < 1 || row_offset + Hl > H || (int64_t)V1 * H * W * C >= ((int64_t)1 << 31) ||
      (D + kRun - 1) / kRun > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == mvs::kFloat32)
    return launch<float>(ref, views, homs, out, V1, D, Hl, H, W, C, row_offset, s);
  if (dtype == mvs::kBFloat16)
    return launch<bf16>(ref, views, homs, out, V1, D, Hl, H, W, C, row_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cost_volume_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
