// Fused matmul for Hopper (sm_90a): out = cast(relu(scale * (a @ b) + bias)).
//
// Replaces the Pallas TPU kernel `_matmul_kernel` of sgg/kernels/matmul.py
// (pallas_call in `fused_matmul`). a [M, K] and b [K, N] are row-major in the
// compute type (float32 or bfloat16), scale and bias float32 [N]; the sum is
// float32 and the epilogue runs once, after the last K slice (a multiply and
// an add, each rounded, no fma; then ReLU), then one cast to the output type
// (the input type, or float32 from bfloat16).
//
// What bounds it: at the ResNet-50 1x1-conv shapes of the generate path
// (B = 32 at 224 px, bf16) 10 of the 15 shapes move more bytes than the
// tensor cores need time for (M = 100,352, K = 64, N = 256 does 64 FLOP per
// byte, under the card's ~295, and 80 % of its bytes are the output), so the
// bound is the bytes: read a and b once, write out once. Only the shapes at
// M = 1,568 and M = 6,272 with K * N >= 512 * 1024 are bound by operations.
//
// Two instances, chosen by the launch plan in matmul.py (plan()):
//
// "tiled", bf16 in and out with K % 16 == 0, N % 8 == 0 and 16-byte aligned
// a and b (every ResNet-50 1x1 conv, and VGG-19's im2col convs after the
// first):
//   - A multi-stage ring fed by 16-byte cp.async for both operands, one
//     __syncthreads per K slice. Rows of A past M and k past K are
//     zero-filled (src-size 0, nothing read); b's slice [BK, BN] is copied as
//     it lies, not transposed.
//   - Fragments by ldmatrix.x4 (A) and ldmatrix.x4.trans (the row-major B)
//     from rows padded by 8 elements, so each 8-row phase hits 32 distinct
//     banks, into mma.sync m16n8k16 with float32 sums.
//   - Tiles per shape (matmul.plan()), chosen by timing on the card: 128
//     rows by 128 columns where N > 64 (eight warps of 64 x 32; four warps
//     of 64 x 64 where K >= 1,024, whose fewer shared-memory loads per
//     product pay once the tensor cores bound the shape), 128 x 64 where
//     N <= 64 or where 128 x 128 leaves SMs without a block; 64-deep K
//     slices where K % 64 == 0 in the 128 x 64 tile. Blocks run along N
//     first, so the blocks of one row tile run together and find its A in
//     L2: A crosses from device memory once. Wider tiles (128 x 256,
//     256 x 128) and 64 x 64 tiles with twice the blocks were slower at
//     every ResNet-50 shape.
//   - Epilogue: scale and bias for a thread's columns in registers, the bf16
//     tile staged through the ring's shared memory, then 16-byte coalesced
//     stores marked evict-first (st.global.cs); rows past M and columns past
//     N are not stored.
//   No split-K (one float32 sum per output, one pass, no workspace); wgmma
//   and TMA are left for later.
//
// "generic", everything else (float32; bf16 to float32; K % 16 != 0 as
// VGG-19's conv1_1 im2col with K = 27; N % 8 != 0; unaligned operands): the
// tile core that conv_direct's generic instance shares (gemm_tile.cuh), a
// 128 x 64 tile with register-staged loads and one slice of prefetch, each
// element loaded on its own unless a run is contiguous and aligned.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <atomic>

#include "gemm_tile.cuh"

namespace {

using sgg_gemm::BLoader;
using sgg_gemm::kARun;
using sgg_gemm::zero_t;

// ---------------------------------------------------------------- generic

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

// ------------------------------------------------------------------ tiled

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async, cached in L2 only; with valid false nothing is read and
// the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The epilogue's arithmetic: scale, then bias, each rounded on its own, as
// the reference's separate multiply and add.
__device__ __forceinline__ float scale_bias(float a, float s, float b) {
  return __fadd_rn(__fmul_rn(a, s), b);
}

// Row m of A and of the output exists: rows past M are neither read
// (zero-filled) nor stored.
__device__ __forceinline__ bool in_rows(int m, int M) {
  return m < M;
}

// Index k of the sum exists: k past K is read from neither A nor B
// (zero-filled).
__device__ __forceinline__ bool in_k(int k, int K) {
  return k < K;
}

// A block tile of BM x BN outputs, K slices of BK, a ring of kStages slices,
// warps of WM x WN outputs. Shared rows are padded by 8 elements (16 bytes)
// so the 8 rows of an ldmatrix phase fall on 32 distinct banks.
template <int BM, int BN, int BK, int kStages, int WM, int WN>
struct Tile {
  static constexpr int kWarpsM = BM / WM, kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kLdA = BK + 8, kLdB = BN + 8, kLdC = BN + 8;
  static constexpr int kStageElems = BM * kLdA + BK * kLdB;
  static constexpr int kRingElems = kStages * kStageElems;
  static constexpr int kSmem = 2 * (kRingElems > BM * kLdC ? kRingElems : BM * kLdC);
  static constexpr int kACols = BK / 8, kBCols = BN / 8;  // 16-byte words of a row
  static constexpr int kARows = BM * kACols / kThreads;   // A rows a thread loads
  static constexpr int kBRows = BK * kBCols / kThreads;   // B rows a thread loads
  static constexpr int kMT = WM / 16, kNT = WN / 8;       // mma tiles of a warp
  static_assert(BM % WM == 0 && BN % WN == 0 && WM % 16 == 0 && WN % 16 == 0, "warp tile");
  static_assert(kThreads % kACols == 0 && kThreads % kBCols == 0, "a thread's column");
  static_assert(BM * kACols % kThreads == 0 && BK * kBCols % kThreads == 0, "whole rows");
  static_assert(kARows <= 32 && kStages >= 2 && BK % 16 == 0, "shape");
  // Two blocks per SM, unless eight warps' 64 x 64 sums need more than half
  // of the SM's registers.
  static constexpr int kMinBlocks = kThreads * WM * WN >= 256 * 64 * 64 ? 1 : 2;
};

template <int BM, int BN, int BK, int kStages, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, BK, kStages, WM, WN>::kThreads,
                                  Tile<BM, BN, BK, kStages, WM, WN>::kMinBlocks)
matmul_tiled_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                    const float* __restrict__ scale, const float* __restrict__ bias,
                    bf16* __restrict__ out, int M, int N, int K, int n_tiles, int relu) {
  using Cfg = Tile<BM, BN, BK, kStages, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // Blocks run along N first: the n_tiles blocks of one row tile are
  // consecutive, so its A comes from device memory once and from L2 after.
  const int tm = blockIdx.x / n_tiles, tn = blockIdx.x - tm * n_tiles;
  const int m0 = tm * BM, n0 = tn * BN;

  // The A rows this thread loads: rows a_row + i * kAStep of the tile, 8
  // columns from a_col.
  constexpr int kAStep = Cfg::kThreads / Cfg::kACols;
  const int a_row = tid / Cfg::kACols, a_col = (tid % Cfg::kACols) * 8;
  const bf16* a_src = a + (long)(m0 + a_row) * K + a_col;
  uint32_t a_in = 0;  // bit i: row i exists
#pragma unroll
  for (int i = 0; i < Cfg::kARows; ++i)
    a_in |= (in_rows(m0 + a_row + i * kAStep, M) ? 1u : 0u) << i;
  constexpr int kBStep = Cfg::kThreads / Cfg::kBCols;
  const int b_row = tid / Cfg::kBCols, b_col = (tid % Cfg::kBCols) * 8;
  const bool b_in = n0 + b_col < N;  // N % 8 == 0: a word is all in or all out

  int p_k0 = 0;  // the producer's K slice
  auto load_stage = [&](int slot) {
    bf16* As = smem + slot * Cfg::kStageElems;
    bf16* Bs = As + BM * Cfg::kLdA;
    const bool ka = in_k(p_k0 + a_col, K);
#pragma unroll
    for (int i = 0; i < Cfg::kARows; ++i) {
      const bool ok = ((a_in >> i) & 1u) && ka;
      cp_async16(As + (a_row + i * kAStep) * Cfg::kLdA + a_col,
                 ok ? a_src + (long)i * kAStep * K + p_k0 : a, ok);
    }
    const bf16* b_src = b + (long)p_k0 * N + n0 + b_col;  // the slice's rows of B
#pragma unroll
    for (int j = 0; j < Cfg::kBRows; ++j) {
      const int kk = b_row + j * kBStep;
      const bool ok = b_in && in_k(p_k0 + kk, K);
      cp_async16(Bs + kk * Cfg::kLdB + b_col, ok ? b_src + (long)kk * N : b, ok);
    }
    p_k0 += BK;
  };

  const int wm = (warp % Cfg::kWarpsM) * WM, wn = (warp / Cfg::kWarpsM) * WN;
  float acc[Cfg::kMT][Cfg::kNT][4];
#pragma unroll
  for (int i = 0; i < Cfg::kMT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int steps = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  int slot_r = 0, slot_w = kStages - 1;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // slice t has landed, for this thread
    __syncthreads();               // for every thread; slot_w's last reader is done
    if (t + kStages - 1 < steps) load_stage(slot_w);
    cp_async_commit();
    slot_w = slot_w + 1 == kStages ? 0 : slot_w + 1;

    const bf16* As = smem + slot_r * Cfg::kStageElems;
    const bf16* Bs = As + BM * Cfg::kLdA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[Cfg::kMT][4], bfr[Cfg::kNT][2];
#pragma unroll
      for (int i = 0; i < Cfg::kMT; ++i)
        ldmatrix_x4(af[i], As + (wm + i * 16 + (lane & 15)) * Cfg::kLdA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < Cfg::kNT; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, Bs + (kk + (lane & 15)) * Cfg::kLdB + wn + j * 8 + (lane >> 4) * 8);
        bfr[j][0] = r[0];
        bfr[j][1] = r[1];
        bfr[j + 1][0] = r[2];
        bfr[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < Cfg::kMT; ++i)
#pragma unroll
        for (int j = 0; j < Cfg::kNT; ++j) sgg_gemm::mma_bf16(acc[i][j], af[i], bfr[j]);
    }
    slot_r = slot_r + 1 == kStages ? 0 : slot_r + 1;
  }

  // Epilogue. Lane 4g + t holds rows g and g + 8, columns 2t and 2t + 1 of
  // each 16 x 8 mma tile (PTX's m16n8k16 layout).
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the output tile
  const int g = lane >> 2, t4 = lane & 3;
  float sc[Cfg::kNT][2], bi[Cfg::kNT][2];
#pragma unroll
  for (int j = 0; j < Cfg::kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + j * 8 + 2 * t4 + e;
      sc[j][e] = n < N ? scale[n] : 0.0f;
      bi[j][e] = n < N ? bias[n] : 0.0f;
    }
  bf16* Cs = smem;
#pragma unroll
  for (int i = 0; i < Cfg::kMT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::kNT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float y0 = scale_bias(acc[i][j][2 * h], sc[j][0], bi[j][0]);
        float y1 = scale_bias(acc[i][j][2 * h + 1], sc[j][1], bi[j][1]);
        if (relu) {
          y0 = fmaxf(y0, 0.0f);
          y1 = fmaxf(y1, 0.0f);
        }
        *reinterpret_cast<__nv_bfloat162*>(
            Cs + (wm + i * 16 + g + 8 * h) * Cfg::kLdC + wn + j * 8 + 2 * t4) =
            __floats2bfloat162_rn(y0, y1);
      }
  __syncthreads();
#pragma unroll
  for (int id = tid; id < BM * Cfg::kBCols; id += Cfg::kThreads) {
    const int r = id / Cfg::kBCols, c = (id % Cfg::kBCols) * 8;
    const int m = m0 + r, n = n0 + c;
    if (in_rows(m, M) && n < N)  // st.global.cs: the kernel never reads its output back
      __stcs(reinterpret_cast<uint4*>(out + (long)m * N + n),
             *reinterpret_cast<const uint4*>(Cs + r * Cfg::kLdC + c));
  }
}

template <int BM, int BN, int BK, int kStages, int WM, int WN>
cudaError_t launch_tiled(int relu, int M, int N, int K, const void* a, const void* b,
                         const void* scale, const void* bias, void* out, int smem, int gx,
                         int gy, cudaStream_t s) {
  using Cfg = Tile<BM, BN, BK, kStages, WM, WN>;
  if (smem != Cfg::kSmem || gx != (M + BM - 1) / BM || gy != (N + BN - 1) / BN)
    return cudaErrorInvalidValue;
  auto kernel = matmul_tiled_kernel<BM, BN, BK, kStages, WM, WN>;
  // The shared-memory limit is an attribute of the function on one device:
  // set it on each device's first launch of this instance (one bit per
  // device; past 64 devices, on every launch).
  static std::atomic<unsigned long long> smem_set{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(smem_set.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmem);
    if (err != cudaSuccess) return err;
    smem_set.fetch_or(bit, std::memory_order_relaxed);
  }
  kernel<<<(unsigned)gx * (unsigned)gy, Cfg::kThreads, Cfg::kSmem, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<bf16*>(out),
      M, N, K, gy, relu);
  return cudaGetLastError();
}


}  // namespace

// The generic instance. dtype / out_dtype: 0 = float32, 1 = bfloat16; pairs
// (0, 0), (1, 1), (1, 0). a_vec: K % 16 == 0 and a 16-byte aligned; b_vec:
// N % 8 == 0 and b 16-byte aligned. All pointers are device pointers to
// contiguous arrays.
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

// The tiled bf16 instance at the tile, ring depth, threads, shared memory and
// grid (M tiles, N tiles) that matmul.plan() gives; a, b and out are bf16,
// K % 16 == 0, N % 8 == 0, a and b 16-byte aligned. A plan that names no
// instance below, or whose shared memory or grid is not that instance's, is
// refused (cudaErrorInvalidValue).
extern "C" cudaError_t sgg_fused_matmul_tiled(int relu, int M, int N, int K, const void* a,
                                              const void* b, const void* scale,
                                              const void* bias, void* out, int bm, int bn,
                                              int bk, int stages, int threads, int smem,
                                              int gx, int gy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 16 != 0 || N % 8 != 0 || M < 0 || N < 0 || K < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
#define SGG_MM_TILE(BM, BN, BK, ST, WM, WN)                                                 \
  if (bm == BM && bn == BN && bk == BK && stages == ST &&                                   \
      threads == Tile<BM, BN, BK, ST, WM, WN>::kThreads)                                    \
    return launch_tiled<BM, BN, BK, ST, WM, WN>(relu, M, N, K, a, b, scale, bias, out, smem, \
                                                gx, gy, s);
  SGG_MM_TILE(128, 128, 32, 4, 64, 64)
  SGG_MM_TILE(128, 128, 32, 4, 64, 32)
  SGG_MM_TILE(128, 64, 64, 4, 64, 32)
  SGG_MM_TILE(128, 64, 32, 4, 64, 32)
#undef SGG_MM_TILE
  return cudaErrorInvalidValue;
}

