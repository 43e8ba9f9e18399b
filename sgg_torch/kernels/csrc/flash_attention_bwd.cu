// Flash-attention backward for Hopper (sm_90a): dq, dk and dv of
// o = softmax(q k^T * scale) v, from the forward's saved q, k, v, lse and the
// statistic D = rowsum(do * o), recomputing p tile by tile so that no S x S
// tensor reaches device memory.
//
// Replaces the Pallas TPU kernels of sgg/kernels/flash_attention_bwd.py,
// behind `flash_attention_bwd`: `_dq_kernel` (q-stationary, its dq) by
// `sgg_flash_attention_bwd_dq`, and `_dkv_kernel` (kv-stationary, dk and dv)
// by `sgg_flash_attention_bwd_dkv`. q, k, v, do, dq, dk and dv are [BH, S, D]
// in the compute type (float32 or bfloat16); lse and D are [BH, S] float32.
// The arithmetic is the Pallas bodies' `_dq_body` and `_dkv_body`:
//   - q_s = q * scale rounded to q's type (the scale itself rounded to it);
//   - s = q_s . k from the stored-type operands, summed in float32;
//   - p = exp(s - lse) (expf) and dp = do . v (both widened), in float32;
//   - ds = p * (dp - D);
//   - dq = scale * (ds . k), dk = ds^T . q_s, dv = p^T . do, each summed in
//     float32 with the stored-type operand widened, and cast once.
// Keys at or past S get p = 0; query rows at or past S are read as zeros,
// give p = 0 in dk and dv, and are not stored. The Pallas kernels' bias
// lanes, padding to 128 and head batching are TPU layout tricks and have no
// counterpart here.
//
// bfloat16 (the main path). Both kernels are row-stationary: a block of 4
// warps owns 64 rows of one (batch * head), 16 per warp, and streams the
// other side in tiles of 64 through a two-stage cp.async ring (the next
// tile loads while this one computes), 16 rows of it at a time:
//   dq kernel:  rows = 64 queries; q_s's and do's A fragments stay in
//               registers; per 16 keys, s = q_s . k^T and dp = do . v^T
//               (mma.sync, k and v by ldmatrix), then p and ds in registers,
//               then dq += ds . k.
//   dkv kernel: rows = 64 keys; per 16 queries, s^T = k . q_s^T and
//               dp^T = v . do^T, p^T and ds^T in registers (lse and D of the
//               streamed queries staged beside them), then dv += p^T . do and
//               dk += ds^T . q_s.
// The score-side products s and dp take bf16 operands and run as single
// bf16 mma.sync products. The three products that take p or ds split them
// exactly into three bf16 terms (flash_tile.cuh, split3) and read the value
// operand (k, do, q_s) by ldmatrix.trans, so each is three bf16 products
// summed in float32 on the tensor cores: the reference's function, not p or
// ds rounded to bf16. Nothing of s, p, dp or ds goes through shared memory;
// dq keeps its own kernel, so no atomics and deterministic results. Every
// 16-deep step of a product is a fresh tensor-core sum added in float32 with
// __fadd_rn (flash_tile.cuh, mma_rn).
//
// Block shape: 4 warps, 64 rows per block, streamed tiles of 64, 56 KB of
// shared memory at D = 64. ptxas, D <= 64: dq 162 registers, dk/dv 207 (its
// four D-wide float32 accumulators per row: dk, dv and their mid + lo
// parts), no spills, so 3 and 2 blocks per SM; D <= 128: both 255, dk/dv
// with 996 bytes of spill stores. The dk/dv kernel reloads its k and v
// fragments from shared memory per 16 queries to stay inside that.
//
// What bounds it: at ViT-B/16 ([32, 12, 196, 64] bf16) the dq kernel moves
// 48.8 MB (14.6 us at 3.35 TB/s) and does 2 + 3 products of 2 BH S^2 D, 9.4
// GFLOP (9.5 us at 989 TFLOP/s), the dk/dv kernel 58.4 MB (17.4 us) and
// 2 + 3 + 3 products, 15.1 GFLOP (15.3 us); each takes BH S^2 = 14.8 M expf.
// The bytes and the tensor-core products (with the split's 3x on the p and
// ds products) are of one size; mma.sync and the exp passes keep the kernels
// above both: 0.100 and 0.170 ms there on an H100 (PERF.md). The first
// design's claim, that the float32 products on the CUDA cores (28 and 56 us)
// are the floor of the reference's function, no longer holds.
// Not yet done: wgmma, TMA, persistent blocks; the other side is re-read
// from L2 by each of the ceil(S / 64) row tiles of a head.
//
// float32 keeps the first version: all products on the CUDA cores (no
// TF32), two lanes per row over s / p and dp / ds buffers in shared memory.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <math.h>

#include "flash_tile.cuh"

namespace {

constexpr int kT = 64;       // rows per block, and rows per streamed tile
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kSLd = kT + 4;  // float32 score buffer row length (floats)

// ---------------------------------------------------------------- bfloat16

__host__ __device__ inline size_t smem_bytes_bf16(int D) {
  return (size_t)6 * kT * Ld<bf16>::of(D) * sizeof(bf16)  // two fixed tiles, two x 2 stages
         + (size_t)4 * kT * sizeof(float);               // lse and D x 2 stages (dkv)
}

// One block per (batch * head, 64-query tile): dq of those queries. TO is
// the output type, bf16; float for the check-only entry (dq before the cast).
template <int kDMax, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dstat,
                         TO* __restrict__ dq, int S, int D, float scale_q, float scale) {
  constexpr int kND = kDMax / 16, kNT = kDMax / 8;
  extern __shared__ float4 smem4[];
  const int ld = Ld<bf16>::of(D);
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // q_s rows of the block
  bf16* Os = Qs + kT * ld;                    // do rows of the block
  bf16* Ks = Os + kT * ld;                    // [2][kT][ld] streamed keys
  bf16* Vs = Ks + 2 * kT * ld;                // [2][kT][ld]

  const int n_qt = (S + kT - 1) / kT, n_kt = n_qt;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const long base = bh * (long)S * D;

  stage_rows<kT, kThreads>(k + base, Ks, ld, 0, S, D);
  stage_rows<kT, kThreads>(v + base, Vs, ld, 0, S, D);
  cp_async_commit();
  load_rows<kT, kThreads, bf16, bf16, true>(q + base, Qs, ld, q0, S, D, scale_q);
  load_rows<kT, kThreads, bf16, bf16, false>(dout + base, Os, ld, q0, S, D, 1.0f);
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const float lse0 = r0 < S ? lse[bh * S + r0] : 0.0f, lse1 = r1 < S ? lse[bh * S + r1] : 0.0f;
  const float d0 = r0 < S ? dstat[bh * S + r0] : 0.0f, d1 = r1 < S ? dstat[bh * S + r1] : 0.0f;
  __syncthreads();
  uint32_t qf[kND][4], of[kND][4];
#pragma unroll
  for (int ks = 0; ks < kND; ++ks)
    if (ks * 16 < D) {
      load_a(qf[ks], Qs + warp * 16 * ld, ld, ks * 16);
      load_a(of[ks], Os + warp * 16 * ld, ld, ks * 16);
    }

  float acc[kNT][4], cor[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = cor[i][c] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * kT;
    if (it + 1 < n_kt) {
      const int nb = ((it + 1) & 1) * kT * ld;
      stage_rows<kT, kThreads>(k + base, Ks + nb, ld, k0 + kT, S, D);
      stage_rows<kT, kThreads>(v + base, Vs + nb, ld, k0 + kT, S, D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + (it & 1) * kT * ld;
    const bf16* Vt = Vs + (it & 1) * kT * ld;

#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      if (k0 + kk * 16 >= S) break;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kND; ++ks) {
        if (ks * 16 >= D) break;
        uint32_t b[4];
        load_b(b, Kt, ld, kk * 16, ks * 16);
        mma_rn(s[0], qf[ks], b);
        mma_rn(s[1], qf[ks], b + 2);
        load_b(b, Vt, ld, kk * 16, ks * 16);
        mma_rn(dp[0], of[ks], b);
        mma_rn(dp[1], of[ks], b + 2);
      }
      // p and ds of rows g (c < 2) and g + 8 against keys 8n + 2t + (c & 1).
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool in = k0 + kk * 16 + n * 8 + 2 * t + (c & 1) < S;
          const float p = in ? expf(s[n][c] - (c < 2 ? lse0 : lse1)) : 0.0f;
          s[n][c] = __fmul_rn(p, __fsub_rn(dp[n][c], c < 2 ? d0 : d1));
        }
      const Split da = split_frag(s[0], s[1]);  // ds of dq
#pragma unroll
      for (int dn = 0; dn < kNT; dn += 2) {
        if (dn * 8 >= D) break;
        uint32_t b[4];
        load_bt(b, Kt, ld, kk * 16, dn * 8);
        mma_split(acc[dn], cor[dn], da, b);
        mma_split(acc[dn + 1], cor[dn + 1], da, b + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    if (i * 8 >= D) break;
    const int c = i * 8 + 2 * t;
    if (r0 < S)
      store2(dq + base + (long)r0 * D + c, __fmul_rn(__fadd_rn(acc[i][0], cor[i][0]), scale),
             __fmul_rn(__fadd_rn(acc[i][1], cor[i][1]), scale));
    if (r1 < S)
      store2(dq + base + (long)r1 * D + c, __fmul_rn(__fadd_rn(acc[i][2], cor[i][2]), scale),
             __fmul_rn(__fadd_rn(acc[i][3], cor[i][3]), scale));
  }
}

// One block per (batch * head, 64-key tile): dk and dv of those keys.
template <int kDMax, typename TO>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dstat,
                          TO* __restrict__ dk, TO* __restrict__ dv, int S, int D,
                          float scale_q) {
  constexpr int kND = kDMax / 16, kNT = kDMax / 8;
  extern __shared__ float4 smem4[];
  const int ld = Ld<bf16>::of(D);
  bf16* Ks = reinterpret_cast<bf16*>(smem4);  // key rows of the block
  bf16* Vs = Ks + kT * ld;
  bf16* Qs = Vs + kT * ld;                              // [2][kT][ld] streamed q_s
  bf16* Os = Qs + 2 * kT * ld;                          // [2][kT][ld] streamed do
  float* Ls = reinterpret_cast<float*>(Os + 2 * kT * ld);  // [2][kT] their lse
  float* Ds = Ls + 2 * kT;                                 // [2][kT] their D

  const int n_kt = (S + kT - 1) / kT, n_qt = n_kt;
  const long bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const long base = bh * (long)S * D;

  // Stage the query tile starting at row r into stage b.
  auto stage = [&](int r, int b) {
    stage_rows<kT, kThreads>(q + base, Qs + b * kT * ld, ld, r, S, D);
    stage_rows<kT, kThreads>(dout + base, Os + b * kT * ld, ld, r, S, D);
    for (int i = threadIdx.x; i < 2 * kT; i += kThreads) {
      const int qi = i % kT;
      const bool in = r + qi < S;
      const float* src = (i < kT ? lse : dstat) + bh * S + (in ? r + qi : 0);
      cp_async4((i < kT ? Ls : Ds) + b * kT + qi, src, in);
    }
  };
  stage(0, 0);
  cp_async_commit();
  load_rows<kT, kThreads, bf16, bf16, false>(k + base, Ks, ld, k0, S, D, 1.0f);
  load_rows<kT, kThreads, bf16, bf16, false>(v + base, Vs, ld, k0, S, D, 1.0f);
  const bf16* Kw = Ks + warp * 16 * ld;  // the warp's 16 keys
  const bf16* Vw = Vs + warp * 16 * ld;

  float acck[kNT][4], cork[kNT][4], accv[kNT][4], corv[kNT][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acck[i][c] = cork[i][c] = accv[i][c] = corv[i][c] = 0.0f;

  for (int it = 0; it < n_qt; ++it) {
    const int q0 = it * kT;
    if (it + 1 < n_qt) stage(q0 + kT, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    bf16* Qt = Qs + (it & 1) * kT * ld;
    scale_rows<kT, kThreads>(Qt, ld, D, scale_q);  // q -> q_s, this thread's own words
    __syncthreads();
    const bf16* Ot = Os + (it & 1) * kT * ld;
    const float* Lt = Ls + (it & 1) * kT;
    const float* Dt = Ds + (it & 1) * kT;

#pragma unroll
    for (int qq = 0; qq < kT / 16; ++qq) {
      if (q0 + qq * 16 >= S) break;
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kND; ++ks) {
        if (ks * 16 >= D) break;
        uint32_t a[4], b[4];
        load_a(a, Kw, ld, ks * 16);
        load_b(b, Qt, ld, qq * 16, ks * 16);
        mma_rn(st[0], a, b);
        mma_rn(st[1], a, b + 2);
        load_a(a, Vw, ld, ks * 16);
        load_b(b, Ot, ld, qq * 16, ks * 16);
        mma_rn(dpt[0], a, b);
        mma_rn(dpt[1], a, b + 2);
      }
      // p^T and ds^T of keys g (c < 2) and g + 8 against queries
      // 16 qq + 8n + 2t + (c & 1) of the tile.
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = qq * 16 + n * 8 + 2 * t + (c & 1);
          const float p = q0 + col < S ? expf(st[n][c] - Lt[col]) : 0.0f;
          st[n][c] = p;
          dpt[n][c] = __fmul_rn(p, __fsub_rn(dpt[n][c], Dt[col]));
        }
      const Split pa = split_frag(st[0], st[1]);  // p of dv
#pragma unroll
      for (int dn = 0; dn < kNT; dn += 2) {
        if (dn * 8 >= D) break;
        uint32_t b[4];
        load_bt(b, Ot, ld, qq * 16, dn * 8);
        mma_split(accv[dn], corv[dn], pa, b);
        mma_split(accv[dn + 1], corv[dn + 1], pa, b + 2);
      }
      const Split da = split_frag(dpt[0], dpt[1]);  // ds of dk
#pragma unroll
      for (int dn = 0; dn < kNT; dn += 2) {
        if (dn * 8 >= D) break;
        uint32_t b[4];
        load_bt(b, Qt, ld, qq * 16, dn * 8);
        mma_split(acck[dn], cork[dn], da, b);
        mma_split(acck[dn + 1], cork[dn + 1], da, b + 2);
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  const int r0 = k0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    if (i * 8 >= D) break;
    const int c = i * 8 + 2 * t;
    if (r0 < S) {
      store2(dk + base + (long)r0 * D + c, __fadd_rn(acck[i][0], cork[i][0]),
             __fadd_rn(acck[i][1], cork[i][1]));
      store2(dv + base + (long)r0 * D + c, __fadd_rn(accv[i][0], corv[i][0]),
             __fadd_rn(accv[i][1], corv[i][1]));
    }
    if (r1 < S) {
      store2(dk + base + (long)r1 * D + c, __fadd_rn(acck[i][2], cork[i][2]),
             __fadd_rn(acck[i][3], cork[i][3]));
      store2(dv + base + (long)r1 * D + c, __fadd_rn(accv[i][2], corv[i][2]),
             __fadd_rn(accv[i][3], corv[i][3]));
    }
  }
}

// ----------------------------------------------------------------- float32

__host__ __device__ inline size_t smem_bytes_f32(int D) {
  return (size_t)4 * kT * Ld<float>::of(D) * sizeof(float)  // two fixed, two streamed tiles
         + (size_t)2 * kWarps * 16 * kSLd * sizeof(float)   // s / p and dp / ds buffers
         + (size_t)2 * kT * sizeof(float);                  // streamed lse and D (dkv)
}

// buf (the warp's 16 rows x 64 columns, row length kSLd) = A's rows of this
// warp . B's 64 rows, over D, float32 sums. Two lanes per row: lane 2r + p
// takes row r against B rows p, p + 2, ...
__device__ void product_f32(const float* As, const float* Bs, int ld, int D, float* buf) {
  const int lane = threadIdx.x & 31, row = lane >> 1, par = lane & 1;
  const float* a = As + ((threadIdx.x >> 5) * 16 + row) * ld;
  float s[kT / 2];
#pragma unroll
  for (int j = 0; j < kT / 2; ++j) s[j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float ad = a[d];
#pragma unroll
    for (int j = 0; j < kT / 2; ++j) s[j] = fmaf(ad, Bs[(2 * j + par) * ld + d], s[j]);
  }
#pragma unroll
  for (int j = 0; j < kT / 2; ++j) buf[row * kSLd + 2 * j + par] = s[j];
}

// acc[i][c] += w[j] * x[j][8 i + 4 par + c] over the 64 rows j of a staged
// tile x (row length ld), the lane's half of the columns.
template <int kNV>
__device__ __forceinline__ void accumulate(float (&acc)[kNV][4], const float* w, const float* x,
                                           int ld, int D, int par) {
  for (int j = 0; j < kT; ++j) {
    const float wj = w[j];
    const float* xr = x + j * ld + 4 * par;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      if (8 * i >= D) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wj, xr[8 * i + c], acc[i][c]);
    }
  }
}

template <int kNV>
__device__ __forceinline__ void store_row(float* out, const float (&acc)[kNV][4], int D, int par,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    if (8 * i >= D) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[8 * i + 4 * par + c] = __fmul_rn(acc[i][c], mul);
  }
}

template <int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dstat,
                        float* __restrict__ dq, int S, int D, float scale_q, float scale) {
  constexpr int kNV = kDMax / 8;
  extern __shared__ float4 smem4[];
  const int ld = Ld<float>::of(D);
  float* Qs = reinterpret_cast<float*>(smem4);  // q_s rows of the block
  float* Os = Qs + kT * ld;                     // do rows of the block
  float* Ks = Os + kT * ld;                     // streamed keys
  float* Vs = Ks + kT * ld;
  float* Sb = Vs + kT * ld;             // [kWarps][16][kSLd]: s, then ds
  float* Pb = Sb + kWarps * 16 * kSLd;  // [kWarps][16][kSLd]: dp

  const int n_qt = (S + kT - 1) / kT;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, par = lane & 1;
  const long base = bh * (long)S * D;
  float* srow = Sb + (warp * 16 + row) * kSLd;
  const float* prow = Pb + (warp * 16 + row) * kSLd;

  load_rows<kT, kThreads, float, float, true>(q + base, Qs, ld, q0, S, D, scale_q);
  load_rows<kT, kThreads, float, float, false>(dout + base, Os, ld, q0, S, D, 1.0f);
  const int qr = q0 + warp * 16 + row;
  const float l_r = qr < S ? lse[bh * S + qr] : 0.0f;
  const float d_r = qr < S ? dstat[bh * S + qr] : 0.0f;

  float acc[kNV][4];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kT) {
    __syncthreads();  // the previous tile's products are done
    load_rows<kT, kThreads, float, float, false>(k + base, Ks, ld, k0, S, D, 1.0f);
    load_rows<kT, kThreads, float, float, false>(v + base, Vs, ld, k0, S, D, 1.0f);
    __syncthreads();
    product_f32(Qs, Ks, ld, D, Sb + warp * 16 * kSLd);
    product_f32(Os, Vs, ld, D, Pb + warp * 16 * kSLd);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kT / 2; ++j) {
      const int key = 2 * j + par;
      const float p = k0 + key < S ? expf(srow[key] - l_r) : 0.0f;
      srow[key] = p * (prow[key] - d_r);  // ds
    }
    __syncwarp();
    accumulate<kNV>(acc, srow, Ks, ld, D, par);
  }
  if (qr < S) store_row<kNV>(dq + base + (long)qr * D, acc, D, par, scale);
}

template <int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ dstat,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int D,
                         float scale_q) {
  constexpr int kNV = kDMax / 8;
  extern __shared__ float4 smem4[];
  const int ld = Ld<float>::of(D);
  float* Ks = reinterpret_cast<float*>(smem4);  // key rows of the block
  float* Vs = Ks + kT * ld;
  float* Qs = Vs + kT * ld;             // streamed q_s
  float* Os = Qs + kT * ld;             // streamed do
  float* Sb = Os + kT * ld;             // [kWarps][16][kSLd]: s^T, then p^T
  float* Pb = Sb + kWarps * 16 * kSLd;  // [kWarps][16][kSLd]: dp^T, then ds^T
  float* Ls = Pb + kWarps * 16 * kSLd;  // [kT] lse of the streamed queries
  float* Ds = Ls + kT;                  // [kT] D of the streamed queries

  const int n_kt = (S + kT - 1) / kT;
  const long bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, par = lane & 1;
  const long base = bh * (long)S * D;
  float* srow = Sb + (warp * 16 + row) * kSLd;
  float* prow = Pb + (warp * 16 + row) * kSLd;

  load_rows<kT, kThreads, float, float, false>(k + base, Ks, ld, k0, S, D, 1.0f);
  load_rows<kT, kThreads, float, float, false>(v + base, Vs, ld, k0, S, D, 1.0f);

  float acck[kNV][4], accv[kNV][4];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acck[i][c] = accv[i][c] = 0.0f;

  for (int q0 = 0; q0 < S; q0 += kT) {
    __syncthreads();  // the previous tile's products are done
    load_rows<kT, kThreads, float, float, true>(q + base, Qs, ld, q0, S, D, scale_q);
    load_rows<kT, kThreads, float, float, false>(dout + base, Os, ld, q0, S, D, 1.0f);
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      Ls[i] = q0 + i < S ? lse[bh * S + q0 + i] : 0.0f;
      Ds[i] = q0 + i < S ? dstat[bh * S + q0 + i] : 0.0f;
    }
    __syncthreads();
    product_f32(Ks, Qs, ld, D, Sb + warp * 16 * kSLd);
    product_f32(Vs, Os, ld, D, Pb + warp * 16 * kSLd);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kT / 2; ++j) {
      const int qi = 2 * j + par;
      const float p = q0 + qi < S ? expf(srow[qi] - Ls[qi]) : 0.0f;
      srow[qi] = p;
      prow[qi] = p * (prow[qi] - Ds[qi]);  // ds
    }
    __syncwarp();
    accumulate<kNV>(accv, srow, Os, ld, D, par);
    accumulate<kNV>(acck, prow, Qs, ld, D, par);
  }
  const int kr = k0 + warp * 16 + row;
  if (kr < S) {
    store_row<kNV>(dk + base + (long)kr * D, acck, D, par, 1.0f);
    store_row<kNV>(dv + base + (long)kr * D, accv, D, par, 1.0f);
  }
}

// ------------------------------------------------------------------ launch

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// TI: the input type; TO: the output type (TI, or float for the check-only
// bf16 entries).
template <typename TI, typename TO, int kDMax>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dstat, void* dq, int BH, int S, int D,
                      float scale_q, float scale, cudaStream_t stream) {
  const long blocks = (long)BH * ((S + kT - 1) / kT);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dstat);
  if constexpr (sizeof(TI) == sizeof(float)) {
    const size_t bytes = smem_bytes_f32(D);
    cudaError_t err = prepare(flash_bwd_dq_f32_kernel<kDMax>, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<kDMax><<<(unsigned)blocks, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, ds, static_cast<float*>(dq), S, D, scale_q, scale);
  } else {
    const size_t bytes = smem_bytes_bf16(D);
    cudaError_t err = prepare(flash_bwd_dq_bf16_kernel<kDMax, TO>, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_bf16_kernel<kDMax, TO><<<(unsigned)blocks, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), l, ds, static_cast<TO*>(dq), S, D, scale_q, scale);
  }
  return cudaGetLastError();
}

template <typename TI, typename TO, int kDMax>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dstat, void* dk, void* dv, int BH, int S,
                       int D, float scale_q, cudaStream_t stream) {
  const long blocks = (long)BH * ((S + kT - 1) / kT);
  const float* l = static_cast<const float*>(lse);
  const float* ds = static_cast<const float*>(dstat);
  if constexpr (sizeof(TI) == sizeof(float)) {
    const size_t bytes = smem_bytes_f32(D);
    cudaError_t err = prepare(flash_bwd_dkv_f32_kernel<kDMax>, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_f32_kernel<kDMax><<<(unsigned)blocks, kThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), l, ds, static_cast<float*>(dk), static_cast<float*>(dv),
        S, D, scale_q);
  } else {
    const size_t bytes = smem_bytes_bf16(D);
    cudaError_t err = prepare(flash_bwd_dkv_bf16_kernel<kDMax, TO>, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkv_bf16_kernel<kDMax, TO><<<(unsigned)blocks, kThreads, bytes, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), l, ds, static_cast<TO*>(dk), static_cast<TO*>(dv), S, D,
        scale_q);
  }
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* dstat, void* dq, int BH, int S, int D,
                        float scale_q, float scale, cudaStream_t s) {
  if (D <= 64)
    return launch_dq<TI, TO, 64>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q, scale, s);
  return launch_dq<TI, TO, 128>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q, scale, s);
}

template <typename TI, typename TO>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* dstat, void* dk, void* dv, int BH, int S,
                         int D, float scale_q, cudaStream_t s) {
  if (D <= 64)
    return launch_dkv<TI, TO, 64>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D, scale_q, s);
  return launch_dkv<TI, TO, 128>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D, scale_q, s);
}

bool valid(int BH, int S, int D) { return BH > 0 && S > 0 && D > 0 && D % 16 == 0 && D <= 128; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, dout, dq: contiguous [BH, S, D]
// device arrays, 16-byte aligned; D % 16 == 0 and D <= 128. lse, dstat:
// [BH, S] float32. scale_q: the softmax scale rounded to the compute type
// (q_s = q * scale_q); scale: the float32 scale dq is multiplied by.
extern "C" cudaError_t sgg_flash_attention_bwd_dq(int dtype, int BH, int S, int D, const void* q,
                                                  const void* k, const void* v, const void* dout,
                                                  const void* lse, const void* dstat, void* dq,
                                                  float scale_q, float scale, void* stream) {
  if (BH == 0 || S == 0) return cudaSuccess;
  if (!valid(BH, S, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dq<float, float>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q, scale, s);
  if (dtype == 1)
    return dispatch_dq<bf16, bf16>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q, scale, s);
  return cudaErrorInvalidValue;
}

// As above; dk, dv: contiguous [BH, S, D] in the compute type.
extern "C" cudaError_t sgg_flash_attention_bwd_dkv(int dtype, int BH, int S, int D,
                                                   const void* q, const void* k, const void* v,
                                                   const void* dout, const void* lse,
                                                   const void* dstat, void* dk, void* dv,
                                                   float scale_q, void* stream) {
  if (BH == 0 || S == 0) return cudaSuccess;
  if (!valid(BH, S, D)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dkv<float, float>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D, scale_q, s);
  if (dtype == 1)
    return dispatch_dkv<bf16, bf16>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D, scale_q, s);
  return cudaErrorInvalidValue;
}

// Check only, never on the main path: the bfloat16 instances with float32
// outputs (dq32, or dk32 and dv32, [BH, S, D]) that receive the results
// before the final cast.
extern "C" cudaError_t sgg_flash_attention_bwd_dq_f32_result(
    int BH, int S, int D, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dstat, void* dq32, float scale_q, float scale, void* stream) {
  if (BH == 0 || S == 0) return cudaSuccess;
  if (!valid(BH, S, D)) return cudaErrorInvalidValue;
  return dispatch_dq<bf16, float>(q, k, v, dout, lse, dstat, dq32, BH, S, D, scale_q, scale,
                                  static_cast<cudaStream_t>(stream));
}

extern "C" cudaError_t sgg_flash_attention_bwd_dkv_f32_result(
    int BH, int S, int D, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* dstat, void* dk32, void* dv32, float scale_q, void* stream) {
  if (BH == 0 || S == 0) return cudaSuccess;
  if (!valid(BH, S, D)) return cudaErrorInvalidValue;
  return dispatch_dkv<bf16, float>(q, k, v, dout, lse, dstat, dk32, dv32, BH, S, D, scale_q,
                                   static_cast<cudaStream_t>(stream));
}
