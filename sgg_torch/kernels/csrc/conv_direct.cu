// Direct convolution for Hopper (sm_90a): stride 1, SAME padding, odd kernel,
// NHWC input, HWIO weights, out = cast(relu(scale * conv(x, w) + bias)).
//
// Replaces the Pallas TPU kernel `_conv_kernel` of sgg/kernels/conv_direct.py
// (pallas_call in `conv2d_direct`). Like it, this kernel never writes the
// im2col patch matrix to device memory: it is an implicit GEMM. Row m of A is
// the output pixel (b, oh, ow); column k = (dh * kw + dw) * C + c is tap
// (dh, dw) of input channel c, the order of the HWIO weight read as a
// [kh * kw * C, Cout] matrix. Sums are float32; scale, bias and ReLU run once
// on them (a multiply and an add, each rounded, no fma), then one cast.
//
// What bounds it: at the ResNet-50 3x3 shapes of the generate path (B = 32
// at 224 px, bf16) a conv does 9 * C * Cout / (C + Cout) FLOP per byte of
// input and output it must move: 288 at C = 64, 2,304 at C = 512, against
// the card's balance of about 295. So [32,56,56,64] -> 64 is bound by bytes
// (7.70 us at 3.35 TB/s) and [32,28,28,128] -> 128, [32,14,14,256] -> 256
// and [32,7,7,512] -> 512 by the tensor cores (7.48 us each at 989 TFLOP/s;
// each launch is 7.40 GFLOP).
//
// Two instances, chosen by the launch plan in conv_direct.py (plan()):
//
// "tiled", bf16 with C % 16 == 0, Cout % 8 == 0 and 16-byte aligned x and w
// (every ResNet-50 3x3 conv and VGG-19's convs after the first):
//   - K runs in steps of one tap of one slice of BK = 32 or 64 channels (64
//     only where C % 64 == 0):
//     channel slices outer, the kh * kw taps inner, so the taps of a slice
//     re-read overlapping pixels in consecutive steps. Each thread finds
//     the pixel (b, oh, ow) of each A row it loads once, before the loop;
//     per step it adds one offset and tests the shifted pixel against the
//     image. The K loop has no integer divide.
//   - A ring of 4 stages fed by 16-byte cp.async for both operands: an A
//     row is one copy per 8 channels of the tapped pixel, zero-filled
//     (src-size 0, nothing read) where the tap falls in the SAME halo or
//     past M; the weight slice [BK, BN] is copied as it lies, not
//     transposed. One __syncthreads per K step.
//   - A's copies allocate in L1 (cp.async.ca), so a pixel that the previous
//     taps of the slice fetched comes from L1; B's (cp.async.cg) bypass it.
//     Each block re-reads its input once per tap and its weights once per
//     block. At 150-270 TFLOP/s on the device's clock (chip_smoke.py, H100),
//     that traffic from L2 and through shared memory is the likely limit.
//   - Fragments by ldmatrix.x4 (A) and ldmatrix.x4.trans (the row-major B)
//     from rows padded by 8 elements, so each 8-row phase hits 32 distinct
//     banks; 64 x 32 warp tiles (6 ldmatrix per 16 mma.sync m16n8k16), or
//     32 x 32 in the 64 x 64 tile (four warps rather than two).
//   - Tiles per shape (conv_direct.plan()) so that each ResNet-50 shape puts
//     two blocks on each of the 132 SMs where it can: 128 x 64 (784 blocks
//     at 56 x 56, 392 at 28 x 28) and 64 x 64 (392 at 14 x 14, 200 at
//     7 x 7).
//   - Epilogue: scale and bias for a thread's columns in registers, the bf16
//     tile staged through the ring's shared memory, then 16-byte coalesced
//     stores; rows past M and columns past Cout are not stored.
//   Left for later: wgmma with A from registers, TMA's im2col mode, and a
//   halo tile kept in shared memory so that each input pixel crosses from
//   L2 once per block instead of once per tap.
//
// "generic", everything else (float32; C % 16 != 0 as VGG's conv1_1 with
// C = 3; Cout % 8 != 0): the tile core that fused_matmul shares
// (gemm_tile.cuh), each element of A decoded on its own unless C % 16 == 0.
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

// ------------------------------------------------------------------ tiled

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async, cached in L2 only (.cg) or in L1 too (.ca); with valid
// false nothing is read and the 16 bytes are zero-filled (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16_l1(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
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

// A block tile of BM x BN outputs, K slices of BK channels, a ring of
// kStages slices, warps of WM x WN outputs. Shared rows are padded by 8
// elements (16 bytes): row strides of 80, 144 or 272 bytes put the 8 rows of
// an ldmatrix phase on 32 distinct banks.
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
  static constexpr int kMinBlocks = 2;  // two blocks per SM: the plan sizes the ring for it
};

template <int BM, int BN, int BK, int kStages, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, BK, kStages, WM, WN>::kThreads,
                                  Tile<BM, BN, BK, kStages, WM, WN>::kMinBlocks)
conv_tiled_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                  const float* __restrict__ scale, const float* __restrict__ bias,
                  bf16* __restrict__ out, int M, int H, int W, int C, int kh, int kw, int N,
                  int relu) {
  using Cfg = Tile<BM, BN, BK, kStages, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ph = kh / 2, pw = kw / 2;

  // The A rows this thread loads: rows a_row + i * kAStep of the tile, 8
  // channels from a_col. Output pixel m = (b, oh, ow) sits at m * C in the
  // NHWC input too (stride 1, SAME), so its tap (dh, dw) is one offset away.
  constexpr int kAStep = Cfg::kThreads / Cfg::kACols;
  const int a_row = tid / Cfg::kACols, a_col = (tid % Cfg::kACols) * 8;
  const bf16* a_pix[Cfg::kARows];
  int a_oh[Cfg::kARows], a_ow[Cfg::kARows];
  uint32_t a_in = 0;  // bit i: row i lies below M
  const int hw = H * W;
#pragma unroll
  for (int i = 0; i < Cfg::kARows; ++i) {
    const int m = m0 + a_row + i * kAStep;
    const int mm = m < M ? m : 0;
    const int b = mm / hw, r = mm - b * hw;
    a_oh[i] = r / W;
    a_ow[i] = r - a_oh[i] * W;
    a_pix[i] = x + (long)mm * C + a_col;
    a_in |= (m < M ? 1u : 0u) << i;
  }
  constexpr int kBStep = Cfg::kThreads / Cfg::kBCols;
  const int b_row = tid / Cfg::kBCols, b_col = (tid % Cfg::kBCols) * 8;
  const bool b_in = n0 + b_col < N;  // Cout % 8 == 0: a word is all in or all out

  // The producer's place in K: channel slice p_c0, tap (p_dh, p_dw), number
  // p_tap = p_dh * kw + p_dw.
  int p_dh = 0, p_dw = 0, p_tap = 0, p_c0 = 0;
  auto load_stage = [&](int slot) {
    bf16* As = smem + slot * Cfg::kStageElems;
    bf16* Bs = As + BM * Cfg::kLdA;
    const int dh = p_dh - ph, dw = p_dw - pw;
    const long delta = ((long)dh * W + dw) * C + p_c0;
    const bool c_in = p_c0 + a_col < C;
#pragma unroll
    for (int i = 0; i < Cfg::kARows; ++i) {
      const int ih = a_oh[i] + dh, iw = a_ow[i] + dw;
      bool ok = ((a_in >> i) & 1u) && c_in;
      ok = ok && (unsigned)ih < (unsigned)H;  // halo: the row test
      ok = ok && (unsigned)iw < (unsigned)W;  // halo: the column test
      cp_async16_l1(As + (a_row + i * kAStep) * Cfg::kLdA + a_col, ok ? a_pix[i] + delta : x,
                    ok);
    }
    const bf16* wk = w + ((long)p_tap * C + p_c0) * N + n0 + b_col;  // the slice's weight rows
#pragma unroll
    for (int j = 0; j < Cfg::kBRows; ++j) {
      const int kk = b_row + j * kBStep;
      const bool ok = b_in && p_c0 + kk < C;
      cp_async16(Bs + kk * Cfg::kLdB + b_col, ok ? wk + (long)kk * N : w, ok);
    }
  };
  auto advance = [&]() {  // the next tap; after the last, the next slice
    ++p_tap;
    if (++p_dw == kw) {
      p_dw = 0;
      if (++p_dh == kh) {
        p_dh = 0;
        p_tap = 0;
        p_c0 += BK;
      }
    }
  };

  const int wm = (warp % Cfg::kWarpsM) * WM, wn = (warp / Cfg::kWarpsM) * WN;
  float acc[Cfg::kMT][Cfg::kNT][4];
#pragma unroll
  for (int i = 0; i < Cfg::kMT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::kNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int steps = kh * kw * ((C + BK - 1) / BK);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) {
      load_stage(s);
      advance();
    }
    cp_async_commit();
  }
  int slot_r = 0, slot_w = kStages - 1;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();  // slice t has landed, for this thread
    __syncthreads();               // for every thread; slot_w's last reader is done
    if (t + kStages - 1 < steps) {
      load_stage(slot_w);
      advance();
    }
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
    if (m < M && n < N)
      *reinterpret_cast<uint4*>(out + (long)m * N + n) =
          *reinterpret_cast<const uint4*>(Cs + r * Cfg::kLdC + c);
  }
}

template <int BM, int BN, int BK, int kStages, int WM, int WN>
cudaError_t launch_tiled(int relu, int B, int H, int W, int C, int kh, int kw, int N,
                         const void* x, const void* w, const void* scale, const void* bias,
                         void* out, int threads, int smem, int gx, int gy, cudaStream_t s) {
  using Cfg = Tile<BM, BN, BK, kStages, WM, WN>;
  if (threads != Cfg::kThreads || smem != Cfg::kSmem) return cudaErrorInvalidValue;
  auto kernel = conv_tiled_kernel<BM, BN, BK, kStages, WM, WN>;
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
  kernel<<<dim3(gx, gy), Cfg::kThreads, Cfg::kSmem, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<bf16*>(out),
      B * H * W, H, W, C, kh, kw, N, relu);
  return cudaGetLastError();
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

// The tiled bf16 instance at the tile, slice depth, ring depth, threads,
// shared memory and grid that conv_direct.plan() gives; x, w and out are
// bf16, C % 16 == 0, N % 8 == 0, x and w 16-byte aligned, kh and kw odd. A
// plan that names no instance below is refused (cudaErrorInvalidValue).
extern "C" cudaError_t sgg_conv_direct_tiled(int relu, int B, int H, int W, int C, int kh,
                                             int kw, int N, const void* x, const void* w,
                                             const void* scale, const void* bias, void* out,
                                             int bm, int bn, int bk, int stages, int threads,
                                             int smem, int gx, int gy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kh % 2 == 0 || kw % 2 == 0 || C % 16 != 0 || N % 8 != 0) return cudaErrorInvalidValue;
  if (B * H * W <= 0 || N <= 0) return cudaSuccess;
#define SGG_CONV_TILE(BM, BN, BK, ST, WM, WN)                                                  \
  if (bm == BM && bn == BN && bk == BK && stages == ST &&                                      \
      threads == Tile<BM, BN, BK, ST, WM, WN>::kThreads)                                       \
    return launch_tiled<BM, BN, BK, ST, WM, WN>(relu, B, H, W, C, kh, kw, N, x, w, scale, bias, \
                                                out, threads, smem, gx, gy, s);
  SGG_CONV_TILE(128, 128, 32, 4, 64, 32)
  SGG_CONV_TILE(128, 64, 32, 4, 64, 32)
  SGG_CONV_TILE(64, 64, 64, 4, 32, 32)
#undef SGG_CONV_TILE
  return cudaErrorInvalidValue;
}
