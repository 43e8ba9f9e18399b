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
//   - an online softmax in float32: a running max m and normaliser l per row;
//   - P . V with p kept in float32 and v widened to float32;
//   - one cast of acc / l to the compute type at the end; lse = m + log(l).
// Keys at or past S are masked to -inf before the max (the Pallas kernel adds
// -1e30 through a bias lane; both give p = 0 there). Its padding, bias lane
// and head batching are TPU layout tricks and have no counterpart here.
//
// Layout: one block of 4 warps per (batch * head, 64-query tile); each warp
// owns 16 query rows. The block walks the keys in tiles of 64 staged in
// shared memory (k in its stored type, v widened to float32). Per key tile a
// warp computes its 16 x 64 scores (bfloat16: mma.sync m16n8k16 on the
// tensor cores, float32 sums, q's fragments kept in registers for the whole
// walk; float32: on the CUDA cores, no TF32), writes them to its own score
// buffer in shared memory, then two lanes per row take the row's softmax
// step and its P . V on the CUDA cores, each lane holding half of the row's
// D float32 accumulators.
//
// What bounds it: at ViT-B/16 (S = 196, D = 64, bf16) attention does about
// 2 S D / (4 D * 2 bytes) = S / 4 = 49 FLOP per byte of q, k, v and o,
// under the card's balance of about 295, so the bound is the bytes (11.5 us
// for [32, 12, 196, 64]); at S = 576 the two bounds meet. This first version
// is simple rather than fast: P . V runs on the CUDA cores in float32
// because rounding p to bf16 for the tensor cores would compute another
// function; k and v are re-read from L2 by each of the ceil(S / 64) query
// tiles of a head; no TMA, no wgmma, no ring of tiles.
//
// Plain C interface for ctypes; the entry returns cudaGetLastError().

#include <math.h>

#include "flash_tile.cuh"

namespace {

constexpr int kTQ = 64;       // query rows per block
constexpr int kTK = 64;       // keys per staged tile
constexpr int kWarps = 4;     // 16 query rows each
constexpr int kThreads = kWarps * 32;
constexpr int kSLd = kTK + 4;  // score buffer row length (floats)

template <typename T>
__host__ __device__ inline size_t smem_bytes(int D) {
  return (size_t)2 * kTQ * Ld<T>::of(D) * sizeof(T)  // q tile, k tile
         + (size_t)kTK * D * sizeof(float)           // v tile (float32)
         + (size_t)kWarps * 16 * kSLd * sizeof(float);  // score buffers
}

// Scores of the warp's 16 rows against the 64 staged keys → sbuf[16][kSLd].
template <typename T, int kND> struct Scores;

template <int kND> struct Scores<__nv_bfloat16, kND> {
  uint32_t qf[kND][4];  // q's A fragments, loaded once

  __device__ void load_q(const __nv_bfloat16* Qs, int ld, int D) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
#pragma unroll
    for (int ks = 0; ks < kND; ++ks) {
      if (ks * 16 >= D) break;
      const __nv_bfloat16* r0 = Qs + (wr + g) * ld + ks * 16 + 2 * t;
      const __nv_bfloat16* r8 = r0 + 8 * ld;
      qf[ks][0] = *reinterpret_cast<const uint32_t*>(r0);
      qf[ks][1] = *reinterpret_cast<const uint32_t*>(r8);
      qf[ks][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      qf[ks][3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
    }
  }

  __device__ void compute(const __nv_bfloat16* Qs, const __nv_bfloat16* Ks, int ld, int D,
                          float* sbuf) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kTK / 8; ++j) {
      float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < kND; ++ks) {
        if (ks * 16 >= D) break;
        const __nv_bfloat16* c0 = Ks + (j * 8 + g) * ld + ks * 16 + 2 * t;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(c0);
        bf[1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
        mma_bf16(c, qf[ks], bf);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sbuf[(g + (q >> 1) * 8) * kSLd + j * 8 + 2 * t + (q & 1)] = c[q];
    }
  }
};

template <int kND> struct Scores<float, kND> {
  __device__ void load_q(const float*, int, int) {}

  // Two lanes per row: lane 2r + p scores row r against keys p, p + 2, ...
  __device__ void compute(const float* Qs, const float* Ks, int ld, int D, float* sbuf) {
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
};

// kDMax: the largest head width the instance takes (64 or 128); D <= kDMax.
template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int S, int D, float scale) {
  constexpr int kND = kDMax / 16;   // mma k-steps at most
  constexpr int kNV = kDMax / 8;    // float4 groups of a row, at most
  extern __shared__ float4 smem4[];
  const int ld = Ld<T>::of(D);
  T* Qs = reinterpret_cast<T*>(smem4);
  T* Ks = Qs + kTQ * ld;
  float* Vs = reinterpret_cast<float*>(Ks + kTQ * ld);   // [kTK][D]
  float* Sb = Vs + kTK * D;                                // [kWarps][16][kSLd]

  const int n_qt = (S + kTQ - 1) / kTQ;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kTQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, par = lane & 1;  // this lane's row of the warp's 16
  const long base = bh * (long)S * D;
  float* sbuf = Sb + warp * 16 * kSLd;

  load_rows<kTQ, kThreads, T, T, true>(q + base, Qs, ld, q0, S, D, scale);
  __syncthreads();
  Scores<T, kND> sc;
  sc.load_q(Qs, ld, D);

  // The lane's accumulators: columns 8 i + 4 par + c, c < 4, of its row.
  float acc[kNV][4];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
  float m = -INFINITY, l = 0.0f;

  for (int k0 = 0; k0 < S; k0 += kTK) {
    __syncthreads();  // the previous tile's products are done
    load_rows<kTK, kThreads, T, T, false>(k + base, Ks, ld, k0, S, D, 1.0f);
    load_rows<kTK, kThreads, T, float, false>(v + base, Vs, D, k0, S, D, 1.0f);
    __syncthreads();
    sc.compute(Qs, Ks, ld, D, sbuf);
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
  T* orow = o + base + (long)qr * D + 4 * par;
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    if (8 * i >= D) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) orow[8 * i + c] = from_f<T>(__fdiv_rn(acc[i][c], l));
  }
  if (lse != nullptr && par == 0) lse[bh * S + qr] = m + logf(l);
}

template <typename T, int kDMax>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                   int S, int D, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, kDMax>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long blocks = (long)BH * ((S + kTQ - 1) / kTQ);
  flash_fwd_kernel<T, kDMax><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), S, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, void* lse, int BH,
                     int S, int D, float scale, cudaStream_t s) {
  if (D <= 64) return launch<T, 64>(q, k, v, o, lse, BH, S, D, scale, s);
  return launch<T, 128>(q, k, v, o, lse, BH, S, D, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, o: contiguous [BH, S, D] device
// arrays, 16-byte aligned; D % 16 == 0 and D <= 128. lse: [BH, S] float32 or
// null. scale: the softmax scale already rounded to the compute type.
extern "C" cudaError_t sgg_flash_attention(int dtype, int BH, int S, int D, const void* q,
                                           const void* k, const void* v, void* o, void* lse,
                                           float scale, void* stream) {
  if (BH <= 0 || S <= 0) return cudaSuccess;
  if (D <= 0 || D % 16 != 0 || D > 128) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, lse, BH, S, D, scale, s);
  if (dtype == 1) return dispatch<__nv_bfloat16>(q, k, v, o, lse, BH, S, D, scale, s);
  return cudaErrorInvalidValue;
}
