// Tiled GEMM core with a fused scale/bias/ReLU epilogue, shared by
// fused_matmul.cu (A is a row-major matrix) and conv_direct.cu (A is the
// implicit im2col matrix of an NHWC image, never written to memory).
//
// out[m, n] = cast(relu(scale[n] * sum_k A[m, k] * B[k, n] + bias[n]))
//
// A block owns a kBM x kBN output tile and walks K in kBK slices. Each slice
// of A and B goes global -> registers -> shared memory; the next slice's
// global loads are issued before the current slice's products, so their
// latency overlaps the arithmetic. Accumulators stay in float32 registers
// for the whole K loop; the epilogue runs once, after the last slice
// (scale, then bias, then ReLU, then one cast), as the Pallas kernel
// `_matmul_kernel` does on its last K step.
//
// Products: bfloat16 inputs run on the tensor cores through mma.sync
// m16n8k16 (bf16 x bf16 -> f32); float32 inputs run on the CUDA cores in
// full float32, so a float32 result matches a float32 reference to rounding.
//
// Edges are guarded, not padded: rows past M, columns past N and K past its
// end load zeros and are not stored, so M = 100,352 or K = 27 need no copy.
// A "vec" flag, set by the wrapper when a run of loads is contiguous and
// 16-byte aligned, selects 16-byte loads; otherwise every element is loaded
// on its own.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sgg_gemm {

constexpr int kBM = 128;      // output rows per block
constexpr int kBN = 64;       // output columns per block
constexpr int kBK = 32;       // K slice staged in shared memory
constexpr int kThreads = 256;
constexpr int kARun = 16;     // contiguous k of A one thread loads per slice
constexpr int kBRun = 8;      // contiguous n of B one thread loads per slice

// Shared-memory row length in elements. bf16 rows are padded by 8 so that the
// mma fragment loads hit 32 distinct banks and rows stay 16-byte aligned;
// float32 rows by 1, for conflict-free column reads on the CUDA-core path.
template <typename T> struct Ld;
template <> struct Ld<__nv_bfloat16> { static constexpr int v = kBK + 8; };
template <> struct Ld<float> { static constexpr int v = kBK + 1; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename O> __device__ __forceinline__ O from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ T zero_t() { return from_f<T>(0.0f); }

// Copy n elements (n * sizeof(T) a multiple of 16) as 16-byte words.
template <typename T, int n>
__device__ __forceinline__ void copy16(const T* __restrict__ src, T* dst) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < n * (int)sizeof(T) / 16; ++i) d[i] = s[i];
}

// B [K, N] row-major (an HWIO weight is [kh*kw*Cin, Cout] as it lies).
// Thread t loads row k = t / 8 of the slice, columns (t % 8) * 8 .. + 8.
template <typename T>
struct BLoader {
  const T* __restrict__ b;
  int K, N, vec;

  __device__ void load(int k, int n, T* v) const {
    if (k >= K) {
#pragma unroll
      for (int j = 0; j < kBRun; ++j) v[j] = zero_t<T>();
      return;
    }
    const T* row = b + (long)k * N;
    if (vec && n + kBRun <= N) {
      copy16<T, kBRun>(row + n, v);
      return;
    }
#pragma unroll
    for (int j = 0; j < kBRun; ++j) v[j] = n + j < N ? row[n + j] : zero_t<T>();
  }
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Products of one staged slice, and the epilogue, for each input type.
// bf16: 8 warps as 4 (rows) x 2 (columns), a 32 x 32 warp tile of
// 2 x 4 mma tiles of 16 x 8. Fragment layouts are PTX's for m16n8k16.
template <typename T> struct Core;

template <> struct Core<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int L = Ld<T>::v;
  float acc[2][4][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;
  }

  __device__ void compute(const T* As, const T* Bs) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const T* r0 = As + (wm + i * 16 + g) * L + ks + 2 * t;
        const T* r8 = r0 + 8 * L;
        af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
        af[i][1] = *reinterpret_cast<const uint32_t*>(r8);
        af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const T* c0 = Bs + (wn + j * 8 + g) * L + ks + 2 * t;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }

  template <typename Epi>
  __device__ void epilogue(int m0, int n0, Epi epi) const {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp & 3) * 32, wn = (warp >> 2) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          epi(m0 + wm + i * 16 + g + (q >> 1) * 8, n0 + wn + j * 8 + 2 * t + (q & 1),
              acc[i][j][q]);
  }
};

// float32: a 16 x 16 thread grid, each thread 8 rows x 4 columns, 16 apart.
template <> struct Core<float> {
  using T = float;
  static constexpr int L = Ld<T>::v;
  float acc[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ void compute(const T* As, const T* Bs) {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll 4
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(ty + 16 * i) * L + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * L + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  template <typename Epi>
  __device__ void epilogue(int m0, int n0, Epi epi) const {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(m0 + ty + 16 * i, n0 + tx + 16 * j, acc[i][j]);
  }
};

// The kernel. ALoader supplies A: `init(m)` once per thread for its row,
// then `load(k, v)` fills kARun values A[m, k .. k + kARun) (zeros outside).
// Thread t owns row t / 2 of the block's A tile and k offset (t % 2) * 16.
template <typename T, typename O, typename ALoader>
__global__ void __launch_bounds__(kThreads)
gemm_epilogue_kernel(ALoader la, BLoader<T> lb, const float* __restrict__ scale,
                     const float* __restrict__ bias, O* __restrict__ out, int M, int N,
                     int K, int relu) {
  constexpr int L = Ld<T>::v;
  __shared__ __align__(16) T As[kBM * L];
  __shared__ __align__(16) T Bs[kBN * L];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ar = tid >> 1, ak = (tid & 1) * kARun;
  const int bk = tid >> 3, bn = (tid & 7) * kBRun;
  la.init(m0 + ar);

  alignas(16) T av[kARun];
  alignas(16) T bv[kBRun];
  Core<T> core;
  core.zero();
  la.load(ak, av);
  lb.load(bk, n0 + bn, bv);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();  // the previous slice's products are done
    if constexpr (sizeof(T) == 2) {  // bf16 rows are 16-byte aligned
      copy16<T, kARun>(av, As + ar * L + ak);
    } else {
#pragma unroll
      for (int i = 0; i < kARun; ++i) As[ar * L + ak + i] = av[i];
    }
#pragma unroll
    for (int j = 0; j < kBRun; ++j) Bs[(bn + j) * L + bk] = bv[j];
    __syncthreads();
    if (k0 + kBK < K) {  // issue the next slice's loads before the products
      la.load(k0 + kBK + ak, av);
      lb.load(k0 + kBK + bk, n0 + bn, bv);
    }
    core.compute(As, Bs);
  }

  core.epilogue(m0, n0, [&](int m, int n, float a) {
    if (m >= M || n >= N) return;
    // No contraction into an fma: scale, then bias, rounded like the
    // reference's separate multiply and add.
    float y = __fadd_rn(__fmul_rn(a, scale[n]), bias[n]);
    if (relu) y = fmaxf(y, 0.0f);
    out[(long)m * N + n] = from_f<O>(y);
  });
}

template <typename T, typename O, typename ALoader>
cudaError_t launch_gemm(const ALoader& la, const BLoader<T>& lb, const float* scale,
                        const float* bias, O* out, int M, int N, int K, int relu,
                        cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  gemm_epilogue_kernel<T, O, ALoader><<<grid, kThreads, 0, stream>>>(
      la, lb, scale, bias, out, M, N, K, relu);
  return cudaGetLastError();
}

}  // namespace sgg_gemm
