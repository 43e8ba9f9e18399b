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
//   - p = exp(s - lse) and dp = do . v (both widened), in float32;
//   - ds = p * (dp - D);
//   - dq = scale * (ds . k), dk = ds^T . q_s, dv = p^T . do, each summed in
//     float32 with the stored-type operand widened, and cast once.
// With bf16 inputs s and dp run on the tensor cores (mma.sync m16n8k16, bf16
// operands widen exactly, float32 sums: the same function). The three
// products that take p or ds stay in float32 on the CUDA cores: rounding p or
// ds to bf16 to reach the tensor cores would compute another function.
// Keys at or past S get p = 0; query rows at or past S are read as zeros,
// give p = 0 in dk and dv, and are not stored. The Pallas kernels' bias
// lanes, padding to 128 and head batching are TPU layout tricks and have no
// counterpart here.
//
// Layout: both kernels are "row-stationary" with the forward's shape. A
// block of 4 warps owns 64 rows of one (batch * head) and walks the other
// side in tiles of 64 staged in shared memory; each warp owns 16 rows and
// computes its 16 x 64 tile of s and of dp into two buffers in shared
// memory, then two lanes per row turn them into p and ds and accumulate the
// row's float32 products, each lane holding half of the row's D columns.
//   dq kernel:  rows = 64 queries (q_s and do tiles fixed), streams k and v;
//               acc = sum over keys of ds * k.
//   dkv kernel: rows = 64 keys (k and v tiles fixed), streams q_s, do, lse
//               and D; computes s^T and dp^T directly (k . q_s, v . do) and
//               accumulates dk = sum of ds * q_s and dv = sum of p * do.
//
// What bounds it: at ViT-B/16 (S = 196, D = 64, bf16) each kernel moves
// about 49-58 MB and does 5.7-7.6 GFLOP, so the bound is the bytes (14.6 and
// 17.4 us). The float32 products on the CUDA cores (1.9 GFLOP in dq, 3.8 in
// dk and dv) alone need 28 and 56 us at 67 TFLOP/s: that is the floor of the
// reference's function without the tensor cores. This first version is
// simple rather than fast: the other side is re-read from L2 by each of the
// ceil(S / 64) row tiles of a head, tiles are staged by plain loads (no
// cp.async, TMA or wgmma) and the value products read the stored type
// element by element.
//
// Plain C interface for ctypes; each entry returns cudaGetLastError().

#include <math.h>

#include "flash_tile.cuh"

namespace {

constexpr int kT = 64;       // rows per block, and rows per streamed tile
constexpr int kWarps = 4;    // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kSLd = kT + 4;  // score buffer row length (floats)

template <typename T>
__host__ __device__ inline size_t smem_bytes(int D) {
  return (size_t)4 * kT * Ld<T>::of(D) * sizeof(T)        // two fixed, two streamed tiles
         + (size_t)2 * kWarps * 16 * kSLd * sizeof(float)  // s / p and dp / ds buffers
         + (size_t)2 * kT * sizeof(float);                 // streamed lse and D (dkv)
}

// buf (the warp's 16 rows x 64 columns, row length kSLd) = A's rows of this
// warp . B's 64 rows, over D, float32 sums.
template <typename T> struct Product;

template <> struct Product<__nv_bfloat16> {
  __device__ static void run(const __nv_bfloat16* As, const __nv_bfloat16* Bs, int ld, int D,
                             float* buf) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wr = (threadIdx.x >> 5) * 16;
    float c[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) c[j][q] = 0.0f;
    for (int ks = 0; ks < D; ks += 16) {
      const __nv_bfloat16* r0 = As + (wr + g) * ld + ks + 2 * t;
      const __nv_bfloat16* r8 = r0 + 8 * ld;
      uint32_t a[4];
      a[0] = *reinterpret_cast<const uint32_t*>(r0);
      a[1] = *reinterpret_cast<const uint32_t*>(r8);
      a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(r8 + 8);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j) {
        const __nv_bfloat16* c0 = Bs + (j * 8 + g) * ld + ks + 2 * t;
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(c0);
        b[1] = *reinterpret_cast<const uint32_t*>(c0 + 8);
        mma_bf16(c[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        buf[(g + (q >> 1) * 8) * kSLd + j * 8 + 2 * t + (q & 1)] = c[j][q];
  }
};

template <> struct Product<float> {
  // Two lanes per row: lane 2r + p takes row r against B rows p, p + 2, ...
  __device__ static void run(const float* As, const float* Bs, int ld, int D, float* buf) {
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
};

// acc[i][c] += w[j] * x[j][8 i + 4 par + c] over the 64 rows j of a staged
// tile x (row length ld), the lane's half of the columns.
template <typename T, int kNV>
__device__ __forceinline__ void accumulate(float (&acc)[kNV][4], const float* w, const T* x,
                                           int ld, int D, int par) {
  for (int j = 0; j < kT; ++j) {
    const float wj = w[j];
    const T* xr = x + j * ld + 4 * par;
#pragma unroll
    for (int i = 0; i < kNV; ++i) {
      if (8 * i >= D) break;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(wj, to_f(xr[8 * i + c]), acc[i][c]);
    }
  }
}

template <typename T, int kNV>
__device__ __forceinline__ void store_row(T* out, const float (&acc)[kNV][4], int D, int par,
                                          float mul) {
#pragma unroll
  for (int i = 0; i < kNV; ++i) {
    if (8 * i >= D) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[8 * i + 4 * par + c] = from_f<T>(__fmul_rn(acc[i][c], mul));
  }
}

// One block per (batch * head, 64-query tile): dq of those queries.
template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dstat, T* __restrict__ dq, int S, int D,
                    float scale_q, float scale) {
  constexpr int kNV = kDMax / 8;
  extern __shared__ float4 smem4[];
  const int ld = Ld<T>::of(D);
  T* Qs = reinterpret_cast<T*>(smem4);  // q_s rows of the block
  T* Os = Qs + kT * ld;                 // do rows of the block
  T* Ks = Os + kT * ld;                 // streamed keys
  T* Vs = Ks + kT * ld;
  float* Sb = reinterpret_cast<float*>(Vs + kT * ld);  // [kWarps][16][kSLd]: s, then ds
  float* Pb = Sb + kWarps * 16 * kSLd;                 // [kWarps][16][kSLd]: dp

  const int n_qt = (S + kT - 1) / kT;
  const long bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, par = lane & 1;
  const long base = bh * (long)S * D;
  float* srow = Sb + (warp * 16 + row) * kSLd;
  const float* prow = Pb + (warp * 16 + row) * kSLd;

  load_rows<kT, kThreads, T, T, true>(q + base, Qs, ld, q0, S, D, scale_q);
  load_rows<kT, kThreads, T, T, false>(dout + base, Os, ld, q0, S, D, 1.0f);
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
    load_rows<kT, kThreads, T, T, false>(k + base, Ks, ld, k0, S, D, 1.0f);
    load_rows<kT, kThreads, T, T, false>(v + base, Vs, ld, k0, S, D, 1.0f);
    __syncthreads();
    Product<T>::run(Qs, Ks, ld, D, Sb + warp * 16 * kSLd);
    Product<T>::run(Os, Vs, ld, D, Pb + warp * 16 * kSLd);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kT / 2; ++j) {
      const int key = 2 * j + par;
      const float p = k0 + key < S ? expf(srow[key] - l_r) : 0.0f;
      srow[key] = p * (prow[key] - d_r);  // ds
    }
    __syncwarp();
    accumulate<T, kNV>(acc, srow, Ks, ld, D, par);
  }
  if (qr < S) store_row<T, kNV>(dq + base + (long)qr * D, acc, D, par, scale);
}

// One block per (batch * head, 64-key tile): dk and dv of those keys.
template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dstat, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int D, float scale_q) {
  constexpr int kNV = kDMax / 8;
  extern __shared__ float4 smem4[];
  const int ld = Ld<T>::of(D);
  T* Ks = reinterpret_cast<T*>(smem4);  // key rows of the block
  T* Vs = Ks + kT * ld;
  T* Qs = Vs + kT * ld;                 // streamed q_s
  T* Os = Qs + kT * ld;                 // streamed do
  float* Sb = reinterpret_cast<float*>(Os + kT * ld);  // [kWarps][16][kSLd]: s^T, then p^T
  float* Pb = Sb + kWarps * 16 * kSLd;                 // [kWarps][16][kSLd]: dp^T, then ds^T
  float* Ls = Pb + kWarps * 16 * kSLd;                 // [kT] lse of the streamed queries
  float* Ds = Ls + kT;                                 // [kT] D of the streamed queries

  const int n_kt = (S + kT - 1) / kT;
  const long bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = lane >> 1, par = lane & 1;
  const long base = bh * (long)S * D;
  float* srow = Sb + (warp * 16 + row) * kSLd;
  float* prow = Pb + (warp * 16 + row) * kSLd;

  load_rows<kT, kThreads, T, T, false>(k + base, Ks, ld, k0, S, D, 1.0f);
  load_rows<kT, kThreads, T, T, false>(v + base, Vs, ld, k0, S, D, 1.0f);

  float acck[kNV][4], accv[kNV][4];
#pragma unroll
  for (int i = 0; i < kNV; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acck[i][c] = accv[i][c] = 0.0f;

  for (int q0 = 0; q0 < S; q0 += kT) {
    __syncthreads();  // the previous tile's products are done
    load_rows<kT, kThreads, T, T, true>(q + base, Qs, ld, q0, S, D, scale_q);
    load_rows<kT, kThreads, T, T, false>(dout + base, Os, ld, q0, S, D, 1.0f);
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      Ls[i] = q0 + i < S ? lse[bh * S + q0 + i] : 0.0f;
      Ds[i] = q0 + i < S ? dstat[bh * S + q0 + i] : 0.0f;
    }
    __syncthreads();
    Product<T>::run(Ks, Qs, ld, D, Sb + warp * 16 * kSLd);
    Product<T>::run(Vs, Os, ld, D, Pb + warp * 16 * kSLd);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kT / 2; ++j) {
      const int qi = 2 * j + par;
      const float p = q0 + qi < S ? expf(srow[qi] - Ls[qi]) : 0.0f;
      srow[qi] = p;
      prow[qi] = p * (prow[qi] - Ds[qi]);  // ds
    }
    __syncwarp();
    accumulate<T, kNV>(accv, srow, Os, ld, D, par);
    accumulate<T, kNV>(acck, prow, Qs, ld, D, par);
  }
  const int kr = k0 + warp * 16 + row;
  if (kr < S) {
    store_row<T, kNV>(dk + base + (long)kr * D, acck, D, par, 1.0f);
    store_row<T, kNV>(dv + base + (long)kr * D, accv, D, par, 1.0f);
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int kDMax>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* dstat, void* dq, int BH, int S, int D,
                      float scale_q, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(D);
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, kDMax>, bytes);
  if (err != cudaSuccess) return err;
  const long blocks = (long)BH * ((S + kT - 1) / kT);
  flash_bwd_dq_kernel<T, kDMax><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dstat), static_cast<T*>(dq), S, D, scale_q, scale);
  return cudaGetLastError();
}

template <typename T, int kDMax>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* dstat, void* dk, void* dv, int BH, int S,
                       int D, float scale_q, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T>(D);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, kDMax>, bytes);
  if (err != cudaSuccess) return err;
  const long blocks = (long)BH * ((S + kT - 1) / kT);
  flash_bwd_dkv_kernel<T, kDMax><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(dstat), static_cast<T*>(dk), static_cast<T*>(dv), S, D,
      scale_q);
  return cudaGetLastError();
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
  if (dtype == 0 && D <= 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q, scale, s);
  if (dtype == 0)
    return launch_dq<float, 128>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q, scale, s);
  if (dtype == 1 && D <= 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q,
                                        scale, s);
  if (dtype == 1)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dstat, dq, BH, S, D, scale_q,
                                         scale, s);
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
  if (dtype == 0 && D <= 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D, scale_q, s);
  if (dtype == 0)
    return launch_dkv<float, 128>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D, scale_q, s);
  if (dtype == 1 && D <= 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D,
                                         scale_q, s);
  if (dtype == 1)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dstat, dk, dv, BH, S, D,
                                          scale_q, s);
  return cudaErrorInvalidValue;
}
