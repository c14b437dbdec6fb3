// 3x3(x3) stride-2 transposed convolution, channels-last, with a fused
// bias + ReLU epilogue: flax ConvTranspose(kernel 3, stride 2, "SAME").
//
// Replaces the Pallas deconv kernels of mvsnet_tpu/ops/pallas/deconv3d.py
// (_rowdeconv3d_fwd_impl at deconv3d.py:194, _make_kernel) and
// mvsnet_tpu/ops/pallas/deconv2d.py (_rowdeconv2d_fwd_impl at
// deconv2d.py:185, _make_kernel). A 2D deconv is the case UPD = false,
// where the depth axis (of extent 1) is not upsampled.
//
// Along each upsampled axis, out[2i + d] += k[2 - d] * in[i] (deconv3d.py:
// 9-13). Written as a gather per output element, with no atomics and a
// fixed order of summation: an even output o takes k[2] * in[o/2] +
// k[0] * in[o/2 - 1], an odd output takes k[1] * in[(o-1)/2]. Every
// output is written once; sums and the epilogue are float32.
//
// Bound on the H100: bytes for the tensor cores (a quarter of the taps of a
// 3x3x3 conv, with the output 8 times the input's voxels). This first kernel
// runs on the CUDA cores, with the same tiling as the direct conv (conv.cu):
// one output voxel and COT output channels per thread, 16-byte input reads,
// and the weight slice in shared memory as float32.
#include "common.cuh"

namespace {

using mvs::bf16;

constexpr int kBlock = 128;

// Input index and kernel tap along one axis for output o: up to two taps.
__device__ __forceinline__ int taps_along(int o, bool upsample, int idx[2], int tap[2]) {
  if (!upsample) {
    idx[0] = o;
    tap[0] = 0;
    return 1;
  }
  const int m = o >> 1;
  if (o & 1) {
    idx[0] = m;
    tap[0] = 1;
    return 1;
  }
  idx[0] = m;
  tap[0] = 2;
  if (m >= 1) {
    idx[1] = m - 1;
    tap[1] = 0;
    return 2;
  }
  return 1;
}

template <typename T, bool UPD, int COT>
__global__ void __launch_bounds__(kBlock)
deconv_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ out, int B,
              int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo,
              int Cout, int relu) {
  constexpr int KD = UPD ? 3 : 1;
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  const int co0 = blockIdx.y * COT;
  mvs::stage_weights<T, COT>(w, wsm, KD * 9 * Cin, Cout, co0);

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)B * Do * Ho * Wo) return;
  const int ox = (int)(p % Wo);
  int64_t t = p / Wo;
  const int oy = (int)(t % Ho);
  t /= Ho;
  const int oz = (int)(t % Do);
  const int b = (int)(t / Do);

  int zi[2], zt[2], yi[2], yt[2], xi[2], xt[2];
  const int nz = taps_along(oz, UPD, zi, zt);
  const int ny = taps_along(oy, true, yi, yt);
  const int nx = taps_along(ox, true, xi, xt);

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

  for (int a = 0; a < nz; ++a) {
    for (int bb = 0; bb < ny; ++bb) {
      for (int e = 0; e < nx; ++e) {
        const T* xp = x + ((((int64_t)b * Di + zi[a]) * Hi + yi[bb]) * Wi + xi[e]) * Cin;
        mvs::accumulate_tap<T, COT>(acc, xp, wsm + ((zt[a] * 3 + yt[bb]) * 3 + xt[e]) * Cin * COT,
                                    Cin);
      }
    }
  }

  mvs::epilogue<T, COT>(acc, bias, co0, relu, out + p * Cout + co0);
}

template <typename T, bool UPD, int COT>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int Di, int Hi, int Wi, int Cin, int Cout, int relu,
           cudaStream_t stream) {
  auto kern = deconv_kernel<T, UPD, COT>;
  const int Do = UPD ? 2 * Di : Di, Ho = 2 * Hi, Wo = 2 * Wi;
  const size_t smem = sizeof(float) * (size_t)(UPD ? 27 : 9) * Cin * COT;
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
      static_cast<T*>(out), B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, relu);
  return (int)cudaGetLastError();
}

template <typename T, bool UPD>
int dispatch_cot(int cot, const void* x, const void* w, const float* bias,
                 void* out, int B, int Di, int Hi, int Wi, int Cin, int Cout,
                 int relu, cudaStream_t s) {
  switch (cot) {
    case 8: return launch<T, UPD, 8>(x, w, bias, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
    case 4: return launch<T, UPD, 4>(x, w, bias, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
    case 2: return launch<T, UPD, 2>(x, w, bias, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
    case 1: return launch<T, UPD, 1>(x, w, bias, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_rank(int rank, int cot, const void* x, const void* w,
                  const float* bias, void* out, int B, int Di, int Hi, int Wi,
                  int Cin, int Cout, int relu, cudaStream_t s) {
  if (rank == 3) return dispatch_cot<T, true>(cot, x, w, bias, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
  if (rank == 2) return dispatch_cot<T, false>(cot, x, w, bias, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, Di, Hi, Wi, Cin) with Di = 1 for rank 2, w (3, 3, 3, Cin, Cout) or
// (3, 3, Cin, Cout) in x's type (the flax kernel), bias (Cout,) float32 or
// null, out (B, Do, 2 Hi, 2 Wi, Cout) with Do = 2 Di for rank 3 and 1 for
// rank 2; all contiguous. cot is one of 8, 4, 2, 1 and divides Cout.
// Returns cudaGetLastError() after the launch.
extern "C" int deconv_launch(int dtype, int rank, int cot, const void* x,
                             const void* w, const void* bias, void* out, int B,
                             int Di, int Hi, int Wi, int Cin, int Cout,
                             int relu, void* stream) {
  if (Cout % cot != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == mvs::kFloat32)
    return dispatch_rank<float>(rank, cot, x, w, b, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
  if (dtype == mvs::kBFloat16)
    return dispatch_rank<bf16>(rank, cot, x, w, b, out, B, Di, Hi, Wi, Cin, Cout, relu, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* deconv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
