// Stride-2 transposed convolution, channels-last, with a fused bias + ReLU
// epilogue: flax ConvTranspose(kernel 3, stride 2, "SAME") and, with a
// kernel of 5 and a low-pad offset, the adjoint of the 5x5 stride-2 SAME
// conv.
//
// Replaces the Pallas deconv kernels of mvsnet_tpu/ops/pallas/deconv3d.py
// (_rowdeconv3d_fwd_impl at deconv3d.py:194, _make_kernel) and
// mvsnet_tpu/ops/pallas/deconv2d.py (_rowdeconv2d_fwd_impl at
// deconv2d.py:185, _make_kernel); it also computes the input gradient of
// every stride-2 conv (conv3d.py:1447-1450, conv2d.py:648-658), which for
// K = 5 the JAX package leaves to XLA. A 2D deconv is the case UPD = false,
// where the depth axis (of extent 1) is not upsampled.
//
// Along each upsampled axis, out[o] = sum_t k[K-1-t] * in[(o + lo - t) / 2]
// over the taps t with o + lo - t even and the index inside the input; for
// K = 3 and lo = 0 that is out[2i + d] += k[2 - d] * in[i] (deconv3d.py:
// 9-13). Written as a gather per output element, with no atomics and a
// fixed order of summation: at most (K + 1) / 2 taps per axis. Every
// output is written once; sums and the epilogue are float32.
//
// Two editions, which the wrapper (ops/kernels/deconv.py) picks by dtype
// and shape. bf16 (any Cin, zero-padded in shared memory where it is not a
// multiple of 8) runs the tensor-core edition of tc_conv.cuh
// (deconv_tc_launch): the output splits into 2^rank parity
// classes (one per parity of the output along each axis), each a stride-1
// implicit GEMM over the input grid with 1-8 taps (3D, K = 3) or 1-9 (2D,
// K = 5), all classes in one launch, stored to out[2 j + r]; bytes bound
// it on the H100 (a quarter of a 3x3x3 conv's taps, the output 8 times the
// input's voxels). float32 runs the CUDA-core edition below (deconv_launch;
// bf16 too where the caller asks for it), with the tiling of conv.cu's: one output
// voxel and COT output channels per thread, 16-byte input reads, and the
// weight slice in shared memory as float32.
#include "common.cuh"
#include "tc_conv.cuh"

namespace {

using mvs::bf16;

constexpr int kBlock = 128;

// Input index and kernel tap along one axis for output o: up to (K + 1) / 2.
template <int K>
__device__ __forceinline__ int taps_along(int o, bool upsample, int lo, int n, int idx[],
                                          int tap[]) {
  if (!upsample) {
    idx[0] = o;
    tap[0] = 0;
    return 1;
  }
  int c = 0;
#pragma unroll
  for (int t = 0; t < K; ++t) {
    const int s = o + lo - t;
    if (s < 0 || (s & 1) || (s >> 1) >= n) continue;
    idx[c] = s >> 1;
    tap[c] = K - 1 - t;
    ++c;
  }
  return c;
}

template <typename T, bool UPD, int K, int COT>
__global__ void __launch_bounds__(kBlock)
deconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ out, int B,
              int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo,
              int Cout, int lod, int loh, int low, int relu) {
  constexpr int KD = UPD ? K : 1;
  constexpr int NT = (K + 1) / 2;
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  const int co0 = blockIdx.y * COT;
  mvs::stage_weights<T, COT>(w, wsm, KD * K * K * Cin, Cout, co0);

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)B * Do * Ho * Wo) return;
  const int ox = (int)(p % Wo);
  int64_t t = p / Wo;
  const int oy = (int)(t % Ho);
  t /= Ho;
  const int oz = (int)(t % Do);
  const int b = (int)(t / Do);

  int zi[NT], zt[NT], yi[NT], yt[NT], xi[NT], xt[NT];
  const int nz = taps_along<K>(oz, UPD, lod, Di, zi, zt);
  const int ny = taps_along<K>(oy, true, loh, Hi, yi, yt);
  const int nx = taps_along<K>(ox, true, low, Wi, xi, xt);

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

  for (int a = 0; a < nz; ++a) {
    for (int bb = 0; bb < ny; ++bb) {
      for (int e = 0; e < nx; ++e) {
        const T* xp = x + ((((int64_t)b * Di + zi[a]) * Hi + yi[bb]) * Wi + xi[e]) * Cin;
        mvs::accumulate_tap<T, COT>(acc, xp, wsm + ((zt[a] * K + yt[bb]) * K + xt[e]) * Cin * COT,
                                    Cin);
      }
    }
  }

  mvs::epilogue<T, COT>(acc, bias, co0, relu, out + p * Cout + co0);
}

template <typename T, bool UPD, int K, int COT>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo, int Cout, int lod,
           int loh, int low, int relu, cudaStream_t stream) {
  auto kern = deconv_kernel<T, UPD, K, COT>;
  const size_t smem = sizeof(float) * (size_t)(UPD ? K : 1) * K * K * Cin * COT;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t total = (int64_t)B * Do * Ho * Wo;
  const int64_t gx = (total + kBlock - 1) / kBlock;
  if (gx > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)gx, (unsigned)(Cout / COT));
  kern<<<grid, kBlock, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, lod, loh, low, relu);
  return (int)cudaGetLastError();
}

#define MVS_DECONV_ARGS x, w, bias, out, B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, lod, loh, low, relu, s

template <typename T, bool UPD, int K>
int dispatch_cot(int cot, const void* x, const void* w, const float* bias,
                 void* out, int B, int Di, int Hi, int Wi, int Cin, int Do, int Ho,
                 int Wo, int Cout, int lod, int loh, int low, int relu, cudaStream_t s) {
  switch (cot) {
    case 8: return launch<T, UPD, K, 8>(MVS_DECONV_ARGS);
    case 4: return launch<T, UPD, K, 4>(MVS_DECONV_ARGS);
    case 2: return launch<T, UPD, K, 2>(MVS_DECONV_ARGS);
    case 1: return launch<T, UPD, K, 1>(MVS_DECONV_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_shape(int rank, int k, int cot, const void* x, const void* w,
                   const float* bias, void* out, int B, int Di, int Hi, int Wi,
                   int Cin, int Do, int Ho, int Wo, int Cout, int lod, int loh, int low,
                   int relu, cudaStream_t s) {
  if (rank == 3 && k == 3) return dispatch_cot<T, true, 3>(cot, MVS_DECONV_ARGS);
  if (rank == 2 && k == 3) return dispatch_cot<T, false, 3>(cot, MVS_DECONV_ARGS);
  if (rank == 2 && k == 5) return dispatch_cot<T, false, 5>(cot, MVS_DECONV_ARGS);
  return (int)cudaErrorInvalidValue;
}

#undef MVS_DECONV_ARGS

}  // namespace

// x (B, Di, Hi, Wi, Cin) with Di = 1 for rank 2, w (K, K, K, Cin, Cout) or
// (K, K, Cin, Cout) in x's type (flax-oriented: tap K-1-t pairs with the
// input at (o + lo - t) / 2), bias (Cout,) float32 or null, out (B, Do,
// Ho, Wo, Cout) with Do = 1 for rank 2; all contiguous. K is 3 (rank 2 or
// 3) or 5 (rank 2); lod, loh, low are the low-pad offsets (0 for flax's
// transposed conv, whose output is 2 Di x 2 Hi x 2 Wi). cot is one of 8,
// 4, 2, 1 and divides Cout. Returns cudaGetLastError() after the launch.
extern "C" int deconv_launch(int dtype, int rank, int k, int cot, const void* x,
                             const void* w, const void* bias, void* out, int B,
                             int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo,
                             int Cout, int lod, int loh, int low, int relu, void* stream) {
  if (Cout % cot != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == mvs::kFloat32)
    return dispatch_shape<float>(rank, k, cot, x, w, b, out, B, Di, Hi, Wi, Cin, Do, Ho, Wo,
                                 Cout, lod, loh, low, relu, s);
  if (dtype == mvs::kBFloat16)
    return dispatch_shape<bf16>(rank, k, cot, x, w, b, out, B, Di, Hi, Wi, Cin, Do, Ho, Wo,
                                Cout, lod, loh, low, relu, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core edition (bf16, any Cin): plan is the 200 ints of
// tc_conv.cuh's Plan with one class per output parity (ops/kernels/tc.py),
// w the flax-oriented (KD, KH, KW, Cin, Cout) kernel (KD = 1 for rank 2).
extern "C" int deconv_tc_launch(int nt, int mt, int warps, const int* plan, const void* x,
                                const void* w, const void* bias, void* out, void* stream) {
  return mvs::tc::launch(nt, mt, warps, plan, x, w, bias, out, stream);
}

extern "C" const char* deconv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
