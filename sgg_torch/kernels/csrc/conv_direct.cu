// Direct convolution for Hopper (sm_90a): stride 1, SAME padding, odd kernel,
// NHWC input, HWIO weights, out = cast(relu(scale * conv(x, w) + bias)).
//
// Replaces the Pallas TPU kernel `_conv_kernel` of sgg/kernels/conv_direct.py
// (pallas_call in `conv2d_direct`). Like it, this kernel never writes the
// im2col patch matrix to device memory: it is an implicit GEMM. Row m of A is
// the output pixel (b, oh, ow); column k = (dh * kw + dw) * C + c is tap
// (dh, dw) of input channel c, the order of the HWIO weight read as a
// [kh * kw * C, Cout] matrix. Each K slice loads the shifted input rows for
// its (dh, dw, C-slice) straight from NHWC memory into shared memory, with
// zeros where the SAME halo falls outside the image, and multiplies them
// against the weight slice (gemm_tile.cuh); scale, bias and ReLU run once
// on the float32 sums, then one cast.
//
// What bounds it: at the ResNet-50 3x3 shapes of the generate path (B = 32
// at 224 px, bf16) a conv does 9 * C * Cout / (C + Cout) FLOP per byte of
// input and output it must move: 288 at C = 64, 2,304 at C = 512, against
// the card's balance of about 295, so the first stage is bound by bytes and
// the deeper ones by the tensor cores. This first version is simple rather
// than fast: the tile core of fused_matmul, so each input pixel is read
// again for each of the kh * kw taps (from L2), and no TMA or wgmma.
//
// C % 16 == 0 (every ResNet and VGG conv but VGG's first, C = 3) lets a
// thread load its 16 channels of one tap with two 16-byte loads; otherwise
// every element is decoded and loaded on its own.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include "gemm_tile.cuh"

namespace {

using sgg_gemm::BLoader;
using sgg_gemm::kARun;
using sgg_gemm::zero_t;

template <typename T>
struct ImplicitA {
  const T* __restrict__ x;  // [B, H, W, C]
  int M, H, W, C, kw, ph, pw, K, vec;
  int b, oh, ow;
  bool valid;

  __device__ void init(int m) {
    valid = m < M;
    const int hw = H * W;
    b = m / hw;
    const int r = m - b * hw;
    oh = r / W;
    ow = r - oh * W;
  }

  __device__ T at(int k) const {
    if (!valid || k >= K) return zero_t<T>();
    const int tap = k / C, c = k - tap * C;
    const int dh = tap / kw, dw = tap - dh * kw;
    const int ih = oh + dh - ph, iw = ow + dw - pw;
    if (ih < 0 || ih >= H || iw < 0 || iw >= W) return zero_t<T>();
    return x[(((long)b * H + ih) * W + iw) * C + c];
  }

  __device__ void load(int k, T* v) const {
    if (vec) {  // the run shares one tap: C % 16 == 0 and k % 16 == 0
      const int tap = k / C, c = k - tap * C;
      const int dh = tap / kw, dw = tap - dh * kw;
      const int ih = oh + dh - ph, iw = ow + dw - pw;
      if (valid && k < K && ih >= 0 && ih < H && iw >= 0 && iw < W) {
        sgg_gemm::copy16<T, kARun>(x + (((long)b * H + ih) * W + iw) * C + c, v);
      } else {
#pragma unroll
        for (int i = 0; i < kARun; ++i) v[i] = zero_t<T>();
      }
      return;
    }
#pragma unroll
    for (int i = 0; i < kARun; ++i) v[i] = at(k + i);
  }
};

template <typename T>
cudaError_t run(int relu, int B, int H, int W, int C, int kh, int kw, int N, const void* x,
                const void* w, const void* scale, const void* bias, void* out, int a_vec,
                int b_vec, cudaStream_t s) {
  const int M = B * H * W, K = kh * kw * C;
  ImplicitA<T> la{static_cast<const T*>(x), M, H, W, C, kw, kh / 2, kw / 2, K, a_vec,
                  0, 0, 0, false};
  BLoader<T> lb{static_cast<const T*>(w), K, N, b_vec};
  return sgg_gemm::launch_gemm<T, T>(la, lb, static_cast<const float*>(scale),
                                     static_cast<const float*>(bias), static_cast<T*>(out),
                                     M, N, K, relu, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). a_vec: C % 16 == 0 and x
// 16-byte aligned; b_vec: N % 8 == 0 and w 16-byte aligned. kh and kw odd.
extern "C" cudaError_t sgg_conv_direct(int dtype, int relu, int B, int H, int W, int C,
                                       int kh, int kw, int N, const void* x, const void* w,
                                       const void* scale, const void* bias, void* out,
                                       int a_vec, int b_vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh % 2 == 0 || kw % 2 == 0) return cudaErrorInvalidValue;
  if (dtype == 0)
    return run<float>(relu, B, H, W, C, kh, kw, N, x, w, scale, bias, out, a_vec, b_vec, s);
  if (dtype == 1)
    return run<__nv_bfloat16>(relu, B, H, W, C, kh, kw, N, x, w, scale, bias, out, a_vec,
                              b_vec, s);
  return cudaErrorInvalidValue;
}
