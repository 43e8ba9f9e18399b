// Flash-attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v,
// optionally with the log-sum-exp of each query row.
//
// Replaces the Pallas TPU kernel `_fa_kernel` of sgg/kernels/flash_attention.py
// (pallas_call in `_fa_forward`, behind `flash_attention` and
// `flash_attention_with_lse`). q, k, v and o are [BH, S, D] in the compute
// type (float32 or bfloat16), lse is [BH, S] float32. The arithmetic is the
// Pallas kernel's:
//   - q * scale rounded to q's type (the scale itself rounded to that type);
//   - scores from q_scaled . k of the stored-type operands, summed in float32;
//   - an online softmax in float32 (expf): a running max m and normaliser l
//     per row, rescaled with __fmul_rn and __fadd_rn;
//   - P . V with p kept in float32 and v widened to float32;
//   - one cast of acc / l to the compute type at the end; lse = m + log(l).
// Keys at or past S are masked to -inf before the max (the Pallas kernel adds
// -1e30 through a bias lane; both give p = 0 there). Its padding, bias lane
// and head batching are TPU layout tricks and have no counterpart here.
//
// bfloat16 (the main path). One block of 4 warps per (batch * head, 64-query
// tile), 16 query rows per warp; q's A fragments stay in registers. Key
// tiles of 64 (k and v in bf16) stream through a two-stage cp.async ring, so
// the next tile loads while this one computes. Per tile a warp computes its
// 16 x 64 scores with mma.sync m16n8k16 (k by ldmatrix), takes the online
// softmax in registers (a row's max and sum reduced over the 4 lanes that
// hold it), and multiplies p by v on the tensor cores: p is split exactly
// into three bf16 terms (flash_tile.cuh, split3) and v is read by
// ldmatrix.trans, so P . V is three bf16 products summed in float32 - the
// reference's function, not p rounded to bf16. Nothing of s or p goes
// through shared memory. Every 16-deep step of a product is a fresh
// tensor-core sum added in float32 with __fadd_rn (flash_tile.cuh, mma_rn).
//
// Block shape: 4 warps and 64 query rows per block, key tiles of 64, 46 KB of
// shared memory at D = 64. ptxas gives the D <= 64 instance 168 registers and
// no spills (the D <= 128 one 255, no spills), so registers allow 3 blocks
// (12 warps) per SM; at [32, 12, 196, 64] the grid is 1,536 blocks.
//
// What bounds it: at ViT-B/16 ([32, 12, 196, 64] bf16) the kernel moves
// 4 BH S D x 2 bytes = 19.3 MB (5.8 us at 3.35 TB/s) and does 2 BH S^2 D for
// the scores plus 3 x 2 BH S^2 D for the split P . V, 7.6 GFLOP (7.6 us at
// 989 TFLOP/s; mma.sync reaches a fraction of that), and 14.8 M expf. So
// the tensor-core products, at three times the reference's P . V, and the
// exp and softmax passes on the CUDA cores bound it together; the bytes
// come after. It takes 0.091 ms there on an H100 (PERF.md), 3.5x SDPA. The
// first design's claim, that P . V has to stay on the CUDA cores in float32
// to compute the reference's function, no longer holds. Not yet done: wgmma,
// TMA, persistent blocks; k and v are re-read from L2 by each of the
// ceil(S / 64) query tiles of a head.
//
// float32 keeps the first version: scores and P . V on the CUDA cores
// (no TF32), two lanes per row over a score buffer in shared memory.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <math.h>

#include "flash_tile.cuh"

namespace {

constexpr int kTQ = 64;       // query rows per block
constexpr int kTK = 64;       // keys per staged tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kSLd = kTK + 4;  // float32 score buffer row length (floats)

// ---------------------------------------------------------------- bfloat16

__host__ __device__ inline size_t smem_bytes_bf16(int D) {
  return (size_t)(kTQ + 4 * kTK) * Ld<bf16>::of(D) * sizeof(bf16);  // q; k, v x 2 stages
}

// kDMax: the largest head width the instance takes (64 or 128); D <= kDMax.
// TO: the output type, bf16; float for the check-only entry, which stores
// acc / l before the cast.
template <int kDMax, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, TO* __restrict__ o, float* __restrict__ lse,
                      int S, int D, float scale) {
  constexpr int kND = kDMax / 16;  // k-steps over D
  constexpr int kNT = kDMax / 8;   // n-tiles over D
  constexpr int kNS = kTK / 8;     // n-tiles over a key tile
  extern __shared__ float4 smem4[];
  const int ld = Ld<bf16>::of(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem4);
  bf16* Ks = Qs + kTQ * ld;      // [2][kTK][ld]
  bf16* Vs = Ks + 2 * kTK * ld;  // [2][kTK][ld]

  const int n_qt = (S + kTQ - 1) / kTQ, n_kt = (S + kTK - 1) / kTK;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kTQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const long base = bh * (long)S * D;

  stage_rows<kTK, kThreads>(k + base, Ks, ld, 0, S, D);
  stage_rows<kTK, kThreads>(v + base, Vs, ld, 0, S, D);
  cp_async_commit();
  load_rows<kTQ, kThreads, bf16, bf16, true>(q + base, Qs, ld, q0, S, D, scale);
  __syncthreads();
  uint32_t qf[kND][4];
#pragma unroll
  for (int ks = 0; ks < kND; ++ks)
    if (ks * 16 < D) load_a(qf[ks], Qs + warp * 16 * ld, ld, ks * 16);

  // Rows g (c = 0, 1) and g + 8 (c = 2, 3) of the warp, columns 2t, 2t + 1
  // of each n-tile of D: the hi products in acc, the mid and lo ones in cor.
  float acc[kNT][4], cor[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = cor[i][c] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kTK;
    if (it + 1 < n_kt) {
      const int nb = ((it + 1) & 1) * kTK * ld;
      stage_rows<kTK, kThreads>(k + base, Ks + nb, ld, k0 + kTK, S, D);
      stage_rows<kTK, kThreads>(v + base, Vs + nb, ld, k0 + kTK, S, D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * kTK * ld;
    const bf16* Vt = Vs + (it & 1) * kTK * ld;

    float s[kNS][4];
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kND; ++ks) {
      if (ks * 16 >= D) break;
#pragma unroll
      for (int j = 0; j < kNS; j += 2) {
        if (k0 + j * 8 >= S) break;
        uint32_t b[4];
        load_b(b, Kt, ld, j * 8, ks * 16);
        mma_rn(s[j], qf[ks], b);
        mma_rn(s[j + 1], qf[ks], b + 2);
      }
    }

    // Online softmax step of rows g and g + 8 over this tile's keys.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        if (k0 + j * 8 + 2 * t + c >= S) s[j][c] = s[j][2 + c] = -INFINITY;
        mx0 = fmaxf(mx0, s[j][c]);
        mx1 = fmaxf(mx1, s[j][2 + c]);
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite: a key < S
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int j = 0; j < kNS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        s[j][c] = expf(s[j][c] - mn0);
        s[j][2 + c] = expf(s[j][2 + c] - mn1);
        ps0 += s[j][c];
        ps1 += s[j][2 + c];
      }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, x);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, x);
    }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = __fadd_rn(__fmul_rn(l0, a0), ps0);
    l1 = __fadd_rn(__fmul_rn(l1, a1), ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      acc[i][0] = __fmul_rn(acc[i][0], a0);
      acc[i][1] = __fmul_rn(acc[i][1], a0);
      acc[i][2] = __fmul_rn(acc[i][2], a1);
      acc[i][3] = __fmul_rn(acc[i][3], a1);
      cor[i][0] = __fmul_rn(cor[i][0], a0);
      cor[i][1] = __fmul_rn(cor[i][1], a0);
      cor[i][2] = __fmul_rn(cor[i][2], a1);
      cor[i][3] = __fmul_rn(cor[i][3], a1);
    }

    // acc + cor += p . v over the tile's keys, 16 at a time.
#pragma unroll
    for (int kk = 0; kk < kNS / 2; ++kk) {
      if (k0 + kk * 16 >= S) break;
      const Split pa = split_frag(s[2 * kk], s[2 * kk + 1]);  // p of P . V
#pragma unroll
      for (int dn = 0; dn < kNT; dn += 2) {
        if (dn * 8 >= D) break;
        uint32_t b[4];
        load_bt(b, Vt, ld, kk * 16, dn * 8);
        mma_split(acc[dn], cor[dn], pa, b);
        mma_split(acc[dn + 1], cor[dn + 1], pa, b + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    if (i * 8 >= D) break;
    const int c = i * 8 + 2 * t;
    if (r0 < S)
      store2(o + base + (long)r0 * D + c, __fdiv_rn(__fadd_rn(acc[i][0], cor[i][0]), l0),
             __fdiv_rn(__fadd_rn(acc[i][1], cor[i][1]), l0));
    if (r1 < S)
      store2(o + base + (long)r1 * D + c, __fdiv_rn(__fadd_rn(acc[i][2], cor[i][2]), l1),
             __fdiv_rn(__fadd_rn(acc[i][3], cor[i][3]), l1));
  }
  if (lse != nullptr && t == 0) {
    if (r0 < S) lse[bh * S + r0] = m0 + logf(l0);
    if (r1 < S) lse[bh * S + r1] = m1 + logf(l1);
  }
}

template <int kDMax, typename TO>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                        int S, int D, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes_bf16(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_bf16_kernel<kDMax, TO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long blocks = (long)BH * ((S + kTQ - 1) / kTQ);
  flash_fwd_bf16_kernel<kDMax, TO><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<TO*>(o), static_cast<float*>(lse), S, D, scale);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                          int BH, int S, int D, float scale, cudaStream_t s) {
  if (D <= 64) return launch_bf16<64, TO>(q, k, v, o, lse, BH, S, D, scale, s);
  return launch_bf16<128, TO>(q, k, v, o, lse, BH, S, D, scale, s);
}

// ----------------------------------------------------------------- float32

__host__ __device__ inline size_t smem_bytes_f32(int D) {
  return (size_t)2 * kTQ * Ld<float>::of(D) * sizeof(float)  // q tile, k tile
         + (size_t)kTK * D * sizeof(float)                   // v tile
         + (size_t)kWarps * 16 * kSLd * sizeof(float);       // score buffers
}

// Scores of the warp's 16 rows against the 64 staged keys -> sbuf[16][kSLd].
// Two lanes per row: lane 2r + p scores row r against keys p, p + 2, ...
__device__ void scores_f32(const float* Qs, const float* Ks, int ld, int D, float* sbuf) {
  const int lane = threadIdx.x & 31, row = lane >> 1, par = lane & 1;
  const float* q = Qs + ((threadIdx.x >> 5) * 16 + row) * ld;
  float s[kTK / 2];
#pragma unroll
  for (int j = 0; j < kTK / 2; ++j) s[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float qd = q[d];
#pragma unroll
    for (int j = 0; j < kTK / 2; ++j) s[j] = fmaf(qd, Ks[(2 * j + par) * ld + d], s[j]);
  }
#pragma unroll
  for (int j = 0; j < kTK / 2; ++j) sbuf[row * kSLd + 2 * j + par] = s[j];
}

template <int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int S, int D, float scale) {
  constexpr int kNV = kDMax / 8;  // float4 groups of a row, at most
  extern __shared__ float4 smem4[];
  const int ld = Ld<float>::of(D);
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTQ * ld;
  float* Vs = Ks + kTQ * ld;  // [kTK][D]
  float* Sb = Vs + kTK * D;   // [kWarps][16][kSLd]

  const int n_qt = (S + kTQ - 1) / kTQ;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kTQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, par = lane & 1;  // this lane's row of the warp's 16
  const long base = bh * (long)S * D;
  float* sbuf = Sb + warp * 16 * kSLd;

  load_rows<kTQ, kThreads, float, float, true>(q + base, Qs, ld, q0, S, D, scale);

  // The lane's accumulators: columns 8 i + 4 par + c, c < 4, of its row.
  float acc[kNV][4];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kTK) {
    __syncthreads();  // the previous tile's products are done
    load_rows<kTK, kThreads, float, float, false>(k + base, Ks, ld, k0, S, D, 1.0f);
    load_rows<kTK, kThreads, float, float, false>(v + base, Vs, D, k0, S, D, 1.0f);
    __syncthreads();
    scores_f32(Qs, Ks, ld, D, sbuf);
    __syncwarp();

    // Online softmax step of the row: keys par, par + 2, ... of the tile.
    float* srow = sbuf + row * kSLd;
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < kTK / 2; ++j) {
      const int key = 2 * j + par;
      const float s = k0 + key < S ? srow[key] : -INFINITY;
      srow[key] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);  // finite: the tile holds a key < S
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kTK / 2; ++j) {
      const int key = 2 * j + par;
      const float p = expf(srow[key] - m_new);
      srow[key] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();

    // acc = acc * alpha + p . v, p and v in float32.
    float pv[kNV][4];
#pragma unroll
    for (int i = 0; i < kNV; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) pv[i][c] = 0.0f;
    for (int key = 0; key < kTK; key += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(srow + key);
      const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (key + u) * D + 4 * par;
#pragma unroll
        for (int i = 0; i < kNV; ++i) {
          if (8 * i >= D) break;
          const float4 v4 = *reinterpret_cast<const float4*>(vrow + 8 * i);
          pv[i][0] = fmaf(pk[u], v4.x, pv[i][0]);
          pv[i][1] = fmaf(pk[u], v4.y, pv[i][1]);
          pv[i][2] = fmaf(pk[u], v4.z, pv[i][2]);
          pv[i][3] = fmaf(pk[u], v4.w, pv[i][3]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kNV; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = __fadd_rn(__fmul_rn(acc[i][c], alpha), pv[i][c]);
  }

  const int qr = q0 + warp * 16 + row;
  if (qr >= S) return;
  float* orow = o + base + (long)qr * D + 4 * par;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    if (8 * i >= D) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) orow[8 * i + c] = __fdiv_rn(acc[i][c], l);
  }
  if (lse != nullptr && par == 0) lse[bh * S + qr] = m + logf(l);
}

template <int kDMax>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                       int S, int D, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes_f32(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel<kDMax>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long blocks = (long)BH * ((S + kTQ - 1) / kTQ);
  flash_fwd_f32_kernel<kDMax><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), S, D, scale);
  return cudaGetLastError();
}

bool valid(int D) { return D > 0 && D % 16 == 0 && D <= 128; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous [BH, S, D] device
// arrays, 16-byte aligned; D % 16 == 0 and D <= 128. lse: [BH, S] float32 or
// null. scale: the softmax scale already rounded to the compute type.
extern "C" cudaError_t sgg_flash_attention(int dtype, int BH, int S, int D, const void* q,
                                           const void* k, const void* v, void* o, void* lse,
                                           float scale, void* stream) {
  if (BH <= 0 || S <= 0) return cudaSuccess;
  if (!valid(D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D <= 64) return launch_f32<64>(q, k, v, o, lse, BH, S, D, scale, s);
  if (dtype == 0) return launch_f32<128>(q, k, v, o, lse, BH, S, D, scale, s);
  if (dtype == 1) return dispatch_bf16<bf16>(q, k, v, o, lse, BH, S, D, scale, s);
  return cudaErrorInvalidValue;
}

// Check only, never on the main path: the bfloat16 instance with o32 a
// [BH, S, D] float32 array that receives acc / l before the final cast.
extern "C" cudaError_t sgg_flash_attention_f32_result(int BH, int S, int D, const void* q,
                                                      const void* k, const void* v, void* o32,
                                                      void* lse, float scale, void* stream) {
  if (BH <= 0 || S <= 0) return cudaSuccess;
  if (!valid(D)) return cudaErrorInvalidValue;
  return dispatch_bf16<float>(q, k, v, o32, lse, BH, S, D, scale,
                              static_cast<cudaStream_t>(stream));
}
