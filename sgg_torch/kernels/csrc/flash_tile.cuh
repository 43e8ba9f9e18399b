// Helpers shared by the flash-attention forward (flash_attention.cu) and
// backward (flash_attention_bwd.cu): type conversions, the shared-memory row
// length of a tile, plain and cp.async copies of row tiles, ldmatrix, the
// bf16 mma.sync m16n8k16 product, and the exact three-way bf16 split of
// float32 values that puts p and ds on the tensor cores.
//
// Why the split computes the reference's function. The reference keeps p
// and ds in float32 and multiplies them by bf16 operands widened to float32.
// split3 writes a float32 x as hi + mid + lo with hi = bf16(x),
// mid = bf16(x - hi) and lo = bf16(x - hi - mid), all rounded to nearest; the
// subtractions are exact in float32, so the three bf16 significands of 8 bits
// hold all 24 of x's, and hi + mid + lo == x exactly for |x| >= 2^-100 (below
// about 2^-110 lo falls among bf16's subnormals and the split may miss x by
// at most 2^-134, far under any ulp of the outputs). Each bf16 x bf16 product
// is exact in float32, so hi.b + mid.b + lo.b summed by mma.sync in float32
// is p.b (or ds.b) up to the order of the float32 sums.
//
// How the float32 sums are taken. mma.sync adds its 16 products and the
// accumulator it is given with truncation, so a long sum carried inside the
// tensor core drifts by about an ulp of the running sum per step: with hi,
// mid and lo summed that way in one accumulator, the float32 results at
// S = 576 lie 2.1e-6 to 2.2e-6 (relative L2) from the plain version, as far
// as a split cut to hi + mid (chip_fault_check.py on an H100). So every
// 16-deep step goes into a fresh tensor-core sum that is added to the
// running float32 sum with __fadd_rn (mma_rn), for the score-side products
// and for the hi products alike; the mid and lo products, 2^-8 and 2^-16 of
// hi, go to a second accumulator (cor) added at the end, whose truncation
// stays 2^-8 below the first sum's rounding. The float32 results then lie
// 2.3e-7 to 4.9e-7 from the plain version at the ViT shapes.
//
// What bounds the kernels now (the .cu notes give the numbers): the
// tensor-core products, with the split's three products for each one that
// takes p or ds, the expf and softmax passes on the CUDA cores, and the
// bytes, all of one size at S = 196. The first design's claim, that the
// float32 products on the CUDA cores were the floor of the reference's
// function, no longer holds.
//
// Fragment layout (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t holds
// accumulator rows g and g + 8, columns 2t and 2t + 1 of each n-tile of 8.
// The accumulators of two neighbouring n-tiles are, element for element, the
// A fragment of a 16 x 16 tile for the next product (FlashAttention-2), so p
// and ds never leave registers; split_frag packs them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// Shared-memory row length of a tile, in elements: bf16 rows padded by 8
// (16-byte aligned rows whose 8-row ldmatrix groups hit distinct banks),
// float32 rows by 1.
template <typename T> struct Ld;
template <> struct Ld<bf16> { __host__ __device__ static int of(int D) { return D + 8; } };
template <> struct Ld<float> { __host__ __device__ static int of(int D) { return D + 1; } };

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async from global to shared memory; with valid false nothing is
// read and the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte cp.async (one float32), zero-filled where valid is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issue the cp.async copies of rows [r0, r0 + kRows) of a [S, D] bf16 matrix
// into a shared tile of row length ld; rows at or past S are zero-filled.
template <int kRows, int kThreads>
__device__ __forceinline__ void stage_rows(const bf16* __restrict__ src, bf16* dst, int ld, int r0,
                                           int S, int D) {
  const int words = D / 8;
  for (int w = threadIdx.x; w < kRows * words; w += kThreads) {
    const int r = w / words, c = (w % words) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * ld + c, src + (long)(in ? r0 + r : 0) * D + c, in);
  }
}

// Replace each element of the words this thread staged with stage_rows
// (same kRows, kThreads, D) by its product with `scale` rounded to bf16, as
// load_rows<..., true> does. Call after this thread's copies have landed.
template <int kRows, int kThreads>
__device__ __forceinline__ void scale_rows(bf16* dst, int ld, int D, float scale) {
  const int words = D / 8;
  for (int w = threadIdx.x; w < kRows * words; w += kThreads) {
    const int r = w / words, c = (w % words) * 8;
    uint4* p = reinterpret_cast<uint4*>(dst + r * ld + c);
    alignas(16) bf16 v[8];
    *reinterpret_cast<uint4*>(v) = *p;
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __float2bfloat16(__fmul_rn(__bfloat162float(v[i]), scale));
    *p = *reinterpret_cast<const uint4*>(v);
  }
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. Plain: lane 4g + t gets row g, columns 2t and
// 2t + 1 of each; .trans: rows 2t and 2t + 1 of column g.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// The A fragment of rows [0, 16), columns [k, k + 16) of a row-major shared
// tile (row length ld) starting at the warp's first row.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* rows, int ld, int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(a, rows + (lane & 15) * ld + k + (lane >> 4) * 8);
}

// The B fragments of two n-tiles (rows [n, n + 16) of a row-major tile, as
// B[k][n] = tile[n][k]) at columns [k, k + 16): b[0..1] for rows n..n+7,
// b[2..3] for rows n+8..n+15. For the score products s = q k^T and the like.
__device__ __forceinline__ void load_b(uint32_t* b, const bf16* tile, int ld, int n, int k) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, tile + (n + (lane & 7) + ((lane >> 4) << 3)) * ld + k + ((lane >> 3) & 1) * 8);
}

// The B fragments of two n-tiles of a product over rows (B[k][n] =
// tile[k][n], k = rows [k, k + 16), n = columns [n, n + 16)), through
// ldmatrix.trans: b[0..1] for columns n..n+7, b[2..3] for n+8..n+15.
__device__ __forceinline__ void load_bt(uint32_t* b, const bf16* tile, int ld, int k, int n) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, tile + (k + (lane & 15)) * ld + n + (lane >> 4) * 8);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x0, x1 (neighbouring columns, x0 in the low half) as three packed bf16x2
// words with hi + mid + lo == x exactly (see the note above).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = __fsub_rn(x0, __low2float(h)), r1 = __fsub_rn(x1, __high2float(h));
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, __low2float(m)), __fsub_rn(r1, __high2float(m)));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// A float32 A fragment split three ways.
struct Split {
  uint32_t hi[4], mid[4], lo[4];
};

// The A fragment of the 16 x 16 tile whose values are the accumulators of two
// neighbouring n-tiles c0 (columns 0-7) and c1 (columns 8-15), split.
__device__ __forceinline__ Split split_frag(const float (&c0)[4], const float (&c1)[4]) {
  Split f;
  split3(c0[0], c0[1], f.hi[0], f.mid[0], f.lo[0]);  // row g, columns 2t, 2t + 1
  split3(c0[2], c0[3], f.hi[1], f.mid[1], f.lo[1]);  // row g + 8
  split3(c1[0], c1[1], f.hi[2], f.mid[2], f.lo[2]);  // row g, columns 8 + 2t, 9 + 2t
  split3(c1[2], c1[3], f.hi[3], f.mid[3], f.lo[3]);  // row g + 8
  return f;
}

// c += a . b over one 16-deep step: a fresh tensor-core sum, then one
// round-to-nearest float32 add into c.
__device__ __forceinline__ void mma_rn(float* c, const uint32_t* a, const uint32_t* b) {
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_bf16(h, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = __fadd_rn(c[i], h[i]);
}

// a . b for a split A: the hi product into acc (mma_rn), the mid and lo
// products into cor (the result is acc + cor).
__device__ __forceinline__ void mma_split(float* acc, float* cor, const Split& a,
                                          const uint32_t* b) {
  mma_rn(acc, a.hi, b);
  mma_bf16(cor, a.mid, b);
  mma_bf16(cor, a.lo, b);
}

// Two neighbouring outputs of a row, rounded once to the output type.
__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}

}  // namespace
