// Fused matmul for Hopper (sm_90a): out = cast(relu(scale * (a @ b) + bias)).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` of sgg/kernels/matmul.py
// (pallas_call in `fused_matmul`). a [M, K] and b [K, N] are row-major in the
// compute type (float32 or bfloat16), scale and bias float32 [N]; the sum is
// float32 and the epilogue runs once, after the last K slice, then one cast
// to the output type (the input type, or float32 from bfloat16).
//
// What bounds it: at the ResNet-50 1x1-conv shapes of the generate path
// (B = 32 at 224 px, bf16) most calls move more bytes than the tensor cores
// need time for (e.g. M = 100,352, K = 64, N = 256: 64 FLOP per byte, well
// under the card's ~295), so the bound is the bytes: read a and b once,
// write out once. This first version is simple rather than fast: a
// 128 x 64 tile per block, mma.sync m16n8k16 on the tensor cores for bf16,
// register-staged loads with one slice of prefetch (gemm_tile.cuh), no
// TMA, no wgmma, no split-K for the few-block shapes (M = 1,568).
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include "gemm_tile.cuh"

namespace {

using sgg_gemm::BLoader;
using sgg_gemm::kARun;
using sgg_gemm::zero_t;

template <typename T>
struct MatrixA {
  const T* __restrict__ a;
  int M, K, vec;
  const T* row;
  bool valid;

  __device__ void init(int m) {
    valid = m < M;
    row = a + (long)m * K;
  }

  __device__ void load(int k, T* v) const {
    if (valid && vec && k + kARun <= K) {
      sgg_gemm::copy16<T, kARun>(row + k, v);
      return;
    }
#pragma unroll
    for (int i = 0; i < kARun; ++i) v[i] = valid && k + i < K ? row[k + i] : zero_t<T>();
  }
};

template <typename T, typename O>
cudaError_t run(int relu, int M, int N, int K, const void* a, const void* b,
                const void* scale, const void* bias, void* out, int a_vec, int b_vec,
                cudaStream_t s) {
  MatrixA<T> la{static_cast<const T*>(a), M, K, a_vec, nullptr, false};
  BLoader<T> lb{static_cast<const T*>(b), K, N, b_vec};
  return sgg_gemm::launch_gemm<T, O>(la, lb, static_cast<const float*>(scale),
                                     static_cast<const float*>(bias), static_cast<O*>(out),
                                     M, N, K, relu, s);
}

}  // namespace

// dtype / out_dtype: 0 = float32, 1 = bfloat16; pairs (0, 0), (1, 1), (1, 0).
// a_vec: K % 16 == 0 and a 16-byte aligned; b_vec: N % 8 == 0 and b 16-byte
// aligned. All pointers are device pointers to contiguous arrays.
extern "C" cudaError_t sgg_fused_matmul(int dtype, int out_dtype, int relu, int M, int N,
                                        int K, const void* a, const void* b,
                                        const void* scale, const void* bias, void* out,
                                        int a_vec, int b_vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && out_dtype == 0)
    return run<float, float>(relu, M, N, K, a, b, scale, bias, out, a_vec, b_vec, s);
  if (dtype == 1 && out_dtype == 1)
    return run<__nv_bfloat16, __nv_bfloat16>(relu, M, N, K, a, b, scale, bias, out, a_vec,
                                             b_vec, s);
  if (dtype == 1 && out_dtype == 0)
    return run<__nv_bfloat16, float>(relu, M, N, K, a, b, scale, bias, out, a_vec, b_vec, s);
  return cudaErrorInvalidValue;
}
