// Direct channels-last "SAME" convolution of rank 2 or 3 with a fused
// bias + ReLU epilogue.
//
// Replaces the Pallas conv kernels of mvsnet_tpu/ops/pallas/conv3d.py
// (_rowconv3d_fwd_impl at conv3d.py:974: _make_kernel, _make_kernel_dpack,
// _make_kernel_packed, _make_kernel_s2, _make_kernel_s2_split) and of
// mvsnet_tpu/ops/pallas/conv2d.py (_rowconv2d_fwd_impl at conv2d.py:871,
// :825, :774 and _rowconv2d_s2_fwd_impl at conv2d.py:578), and also every
// conv of the path that the JAX package leaves to XLA. A 2D conv is the
// KD = 1 case over a depth of 1.
//
// out[b, z, y, x, co] = act(bias[co] + sum_{taps, ci} in[b, z*sd - pd + kd,
// y*sh - ph + kh, x*sw - pw + kw, ci] * w[kd, kh, kw, ci, co]), taps outside
// the input read as zero (TF "SAME": low pad = total // 2). Products and
// sums are float32; the epilogue runs on the float32 sum and casts once.
//
// Two editions, which the wrapper (ops/kernels/conv.py) picks by dtype and
// shape. bf16 (Cout <= 128) runs the tensor-core edition of tc_conv.cuh
// (conv_tc_launch): an implicit GEMM on mma.sync fed by a staged,
// zero-filled input box, a Cin that is not a multiple of 8 zero-padded
// there; its note says what bounds each layer on the H100 and what the
// design does about it. float32 runs the CUDA-core edition below
// (conv_launch; bf16 too where the caller asks for it): there operations
// bound it, and each thread
// owns one output voxel and COT output channels, keeps COT float32 sums in
// registers, reads its input in 16-byte vectors of 8 channels, and takes
// the block's weight slice from shared memory as float32, so one
// shared-memory broadcast feeds COT fused multiply-adds. Float32 stays on
// the CUDA cores because TF32 would not hold float32's tolerances.
#include "common.cuh"
#include "tc_conv.cuh"

namespace {

using mvs::bf16;

constexpr int kBlock = 128;

template <typename T, int KD, int KH, int KW, int COT>
__global__ void __launch_bounds__(kBlock)
conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
            const float* __restrict__ bias, T* __restrict__ out, int B, int Di,
            int Hi, int Wi, int Cin, int Do, int Ho, int Wo, int Cout, int sd,
            int sh, int sw, int pd, int ph, int pw, int relu) {
  extern __shared__ float4 smem4[];
  float* wsm = reinterpret_cast<float*>(smem4);
  const int co0 = blockIdx.y * COT;
  mvs::stage_weights<T, COT>(w, wsm, KD * KH * KW * Cin, Cout, co0);

  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (int64_t)B * Do * Ho * Wo) return;
  const int ox = (int)(p % Wo);
  int64_t t = p / Wo;
  const int oy = (int)(t % Ho);
  t /= Ho;
  const int oz = (int)(t % Do);
  const int b = (int)(t / Do);

  float acc[COT];
#pragma unroll
  for (int c = 0; c < COT; ++c) acc[c] = 0.f;

#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const int iz = oz * sd - pd + kd;
    if (iz < 0 || iz >= Di) continue;
#pragma unroll
    for (int kh = 0; kh < KH; ++kh) {
      const int iy = oy * sh - ph + kh;
      if (iy < 0 || iy >= Hi) continue;
#pragma unroll
      for (int kw = 0; kw < KW; ++kw) {
        const int ix = ox * sw - pw + kw;
        if (ix < 0 || ix >= Wi) continue;
        const T* xp = x + ((((int64_t)b * Di + iz) * Hi + iy) * Wi + ix) * Cin;
        mvs::accumulate_tap<T, COT>(acc, xp, wsm + ((kd * KH + kh) * KW + kw) * Cin * COT, Cin);
      }
    }
  }
  mvs::epilogue<T, COT>(acc, bias, co0, relu, out + p * Cout + co0);
}

template <typename T, int KD, int KH, int KW, int COT>
int launch(const void* x, const void* w, const float* bias, void* out, int B,
           int Di, int Hi, int Wi, int Cin, int Do, int Ho, int Wo, int Cout,
           int sd, int sh, int sw, int pd, int ph, int pw, int relu,
           cudaStream_t stream) {
  auto kern = conv_kernel<T, KD, KH, KW, COT>;
  const size_t smem = sizeof(float) * (size_t)KD * KH * KW * Cin * COT;
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
      static_cast<T*>(out), B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, sd, sh, sw,
      pd, ph, pw, relu);
  return (int)cudaGetLastError();
}

template <typename T, int KD, int KH, int KW>
int dispatch_cot(int cot, const void* x, const void* w, const float* bias,
                 void* out, int B, int Di, int Hi, int Wi, int Cin, int Do,
                 int Ho, int Wo, int Cout, int sd, int sh, int sw, int pd,
                 int ph, int pw, int relu, cudaStream_t s) {
#define MVS_CONV_ARGS x, w, bias, out, B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, sd, sh, sw, pd, ph, pw, relu, s
  switch (cot) {
    case 8: return launch<T, KD, KH, KW, 8>(MVS_CONV_ARGS);
    case 4: return launch<T, KD, KH, KW, 4>(MVS_CONV_ARGS);
    case 2: return launch<T, KD, KH, KW, 2>(MVS_CONV_ARGS);
    case 1: return launch<T, KD, KH, KW, 1>(MVS_CONV_ARGS);
  }
#undef MVS_CONV_ARGS
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_kernel(int kd, int kh, int kw, int cot, const void* x,
                    const void* w, const float* bias, void* out, int B, int Di,
                    int Hi, int Wi, int Cin, int Do, int Ho, int Wo, int Cout,
                    int sd, int sh, int sw, int pd, int ph, int pw, int relu,
                    cudaStream_t s) {
#define MVS_CONV_ARGS cot, x, w, bias, out, B, Di, Hi, Wi, Cin, Do, Ho, Wo, Cout, sd, sh, sw, pd, ph, pw, relu, s
  if (kd == 3 && kh == 3 && kw == 3) return dispatch_cot<T, 3, 3, 3>(MVS_CONV_ARGS);
  if (kd == 1 && kh == 3 && kw == 3) return dispatch_cot<T, 1, 3, 3>(MVS_CONV_ARGS);
  if (kd == 1 && kh == 5 && kw == 5) return dispatch_cot<T, 1, 5, 5>(MVS_CONV_ARGS);
  if (kd == 1 && kh == 1 && kw == 1) return dispatch_cot<T, 1, 1, 1>(MVS_CONV_ARGS);
#undef MVS_CONV_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, Di, Hi, Wi, Cin), w (KD, KH, KW, Cin, Cout) in x's type, bias
// (Cout,) float32 or null, out (B, Do, Ho, Wo, Cout); all contiguous.
// cot (output channels per thread) is one of 8, 4, 2, 1 and divides Cout.
// Returns cudaGetLastError() after the launch.
extern "C" int conv_launch(int dtype, int kd, int kh, int kw, int cot,
                           const void* x, const void* w, const void* bias,
                           void* out, int B, int Di, int Hi, int Wi, int Cin,
                           int Do, int Ho, int Wo, int Cout, int sd, int sh,
                           int sw, int pd, int ph, int pw, int relu,
                           void* stream) {
  if (Cout % cot != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == mvs::kFloat32)
    return dispatch_kernel<float>(kd, kh, kw, cot, x, w, b, out, B, Di, Hi, Wi,
                                  Cin, Do, Ho, Wo, Cout, sd, sh, sw, pd, ph, pw,
                                  relu, s);
  if (dtype == mvs::kBFloat16)
    return dispatch_kernel<bf16>(kd, kh, kw, cot, x, w, b, out, B, Di, Hi, Wi,
                                 Cin, Do, Ho, Wo, Cout, sd, sh, sw, pd, ph, pw,
                                 relu, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core edition (bf16, any Cin): plan is the 200 ints of
// tc_conv.cuh's Plan (ops/kernels/tc.py), w the (KD, KH, KW, Cin, Cout)
// kernel, bias (Cout,) float32 or null.
extern "C" int conv_tc_launch(int nt, int mt, int warps, const int* plan, const void* x,
                              const void* w, const void* bias, void* out, void* stream) {
  return mvs::tc::launch(nt, mt, warps, plan, x, w, bias, out, stream);
}

extern "C" const char* conv_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
