// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): type conversions, the shared-memory row
// length of a tile, the bf16 mma.sync m16n8k16 product and the copy of a
// 64-row tile of a [S, D] matrix into shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory row length of a tile, in elements: bf16 rows padded by 8
// (16-byte aligned, conflict-free mma fragment loads), float32 rows by 1.
template <typename T> struct Ld;
template <> struct Ld<__nv_bfloat16> { __host__ __device__ static int of(int D) { return D + 8; } };
template <> struct Ld<float> { __host__ __device__ static int of(int D) { return D + 1; } };

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [r0, r0 + kRows) of a [S, D] matrix into a shared tile of row
// length ld, zeros past S, with kThreads threads. D % 16 == 0 and 16-byte
// aligned rows (the wrappers check), so every thread moves 16-byte words.
// With kScale (q only) each element becomes its product with `scale`
// rounded to T; with TS = float and T = bf16 each element is widened.
template <int kRows, int kThreads, typename T, typename TS, bool kScale>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, TS* dst, int ld, int r0,
                                          int S, int D, float scale) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte word
  const int words = D / kPer;
  for (int w = threadIdx.x; w < kRows * words; w += kThreads) {
    const int r = w / words, c = (w % words) * kPer;
    alignas(16) T v[kPer];
    if (r0 + r < S) {
      *reinterpret_cast<uint4*>(v) =
          *reinterpret_cast<const uint4*>(src + (long)(r0 + r) * D + c);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) v[i] = from_f<T>(0.0f);
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      float x = to_f(v[i]);
      if (kScale) x = __fmul_rn(x, scale);  // exact for bf16 x bf16, then one rounding
      dst[r * ld + c + i] = from_f<TS>(x);
    }
  }
}

}  // namespace
