// Fused 3-step triple decode for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_decode_kernel` of sgg/kernels/fused_decode.py
// (pallas_call in `fused_decode`). It computes, for each batch row: the LSTM
// state from the mean feature, the hoisted projection proj = feats @ wf, then
// for each of the 3 steps additive attention over the R regions, the TF1 LSTM
// gates (i, j, f, o; forget bias 1.0), the deep output, the vocab logits plus
// the additive step-mask bias, softmax((logits + gumbel) / tau), the one-hot of
// the first maximum when `hard`, and the embedding feedback. Forward only.
//
// Numerics follow the Pallas kernel, not the jnp reference: every product
// accumulates in float32; c, h, proj, hp, tanh(proj + hp), ctx, dec, prev and y
// are rounded to the compute type T where the Pallas kernel rounds them;
// biases, the mask and the Gumbel noise are float32; tanhf and expf at full
// precision.
//
// Two instances, chosen by the launch plan in fused_decode.py (plan()).
//
// "batched", bf16 with B <= 64 and F, A, H, E, Z multiples of 8 (the vg1k
// and resnet50 generate paths). The decode is a chain of products of a
// small batch (M = B = 32 or 64 rows) with weights of up to 2,944 x 2,048,
// so the design shares each weight read across the whole batch and spreads
// the columns over every SM:
//   - One cooperative launch of one block per SM (cudaLaunchCooperativeKernel;
//     the entry checks that the card takes it and that the grid can be
//     co-resident, and otherwise launches nothing). Phases are separated by
//     grid-wide barriers (cooperative_groups grid sync), 16 in hard mode:
//     (a) the mean over R, then c, h = tanh(mean @ wc | wi + b) beside proj
//     = feats @ wf in 64 x 64 tiles, then hp = h @ wh + bh; per step (c) the
//     attention scores, 4 rows (b, r) a warp; (d) the softmax over R and
//     ctx = alpha . feats, an item per (b, 256 features); (e) the gates
//     [ctx, prev, z, h] @ k with the TF1 cell in the epilogue, an item per 8
//     hidden units and their 4 gate columns; (f) dec = tanh([h, ctx] @ wd +
//     bd) beside the next step's hp; (g) the logits, 32 vocab columns an
//     item; (h) a block per row: the softmax over V, the first index among
//     the maxima of y, y written, and prev. The next step's (c) and (d) need
//     only its hp, so they run beside (g) and (h).
//   - Every product is one small-M GEMM over the batch on the tensor cores
//     (mma.sync, bf16 in, float32 sums; rows past B zero-filled and never
//     stored), its output columns split into items that go to the blocks in
//     turn, so each weight element is read by one block per step, not by B
//     blocks. Weights and activations stream through a 4-deep cp.async ring
//     into ldmatrix(.trans); the 8 warps split each 128-deep slice and their
//     sums are added in warp order. mma.sync adds a sum's products with
//     truncation, so each 16-deep step is a fresh tensor-core sum added with
//     one round-to-nearest float32 add; proj, whose every value reaches the
//     softmax over R, takes sums of 2 products (kProjSum): 8 times its
//     mma.sync count, but close to plain's float32 sum in k order, which
//     the rounding of proj to bf16 must follow (kProjSum's note).
//   - Hard mode's feedback is a row read: y is exactly 1.0 at one index and
//     0.0 elsewhere, so rnd(y @ emb) = emb[first] bit for bit. Soft mode
//     keeps the product, [B, V] @ [V, E], after one more barrier.
//   - Cross-block reductions are never atomics: a block owns whole rows of
//     the softmax over V and over R, and every sum runs in an order fixed by
//     the widths alone. The launch gives the same bits from run to run, and
//     row b's bits do not depend on B.
// What bounds it: the bytes are 6.3 us at vg1k widths (B = 64, R = 196,
// F = 512, H = 512, V = 210) and about 10.3 us at resnet50 widths (B = 32,
// R = 49, F = 2,048, V = 8,192; the weights and features read once at
// 3.35 TB/s, emb's chosen rows only); the products on the tensor cores are
// under 5 us. What bounds the launch (measured on an H100 by the timed
// instance, a check-only entry that stamps every barrier) is its 16 grid
// barriers, about 2-3 us each with the ramp of the phase after them; proj's
// sums of 2, about 85 us at vg1k widths (784 tiles, bound by the tensor
// pipe: a quarter of each m16n8k8 is useful) and 55 us at resnet50 widths;
// and each block's reads from L2, about 30 GB/s per SM whatever the ring
// depth (4, 6 and 8 timed alike): a block reads the batch's activations of
// every item it takes, as many bytes as the item's weights, and the small
// phases (hp, dec, the init products) run on 8-64 of the 132 SMs.
//
// "generic", float32 and every width the plan cannot take (the first
// design): one thread block per batch row, every product a matvec on the
// CUDA cores, proj through a global scratch buffer that the caller
// allocates, the feature rows staged through shared memory in tiles of RT
// rows: 32 where that fits one block (vg1k widths), else 16 (resnet50
// widths, where 32 rows would need 328 KB and 16 need 197 KB). The tile
// only stages rows: proj does not depend on it. It reads every weight once
// per block, about 0.9 GB from L2 per launch at resnet50 widths.
//
// Plain C interface for ctypes: no PyTorch headers, so nvcc builds it in
// seconds. Each entry returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long kSmemLimit = 232448;        // bytes of shared memory one block may use
constexpr int kCols = 4;      // matvec output columns per thread per pass
constexpr int kSteps = 3;     // (subject, predicate, object)

__device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

template <typename T> __device__ __forceinline__ T to_t(float x);
template <> __device__ __forceinline__ float to_t<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to T's precision and back.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  T v = to_t<T>(x);
  return ld(&v, 0);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// Block-wide reductions; every thread of the block must call them.
// `red` is kWarps floats of shared memory.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.0f;
  for (int w = 0; w < kWarps; ++w) r += red[w];
  return r;
}

__device__ int block_min_int(int v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  int* ired = reinterpret_cast<int*>(red);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) ired[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = ired[0];
  for (int w = 1; w < kWarps; ++w) r = min(r, ired[w]);
  return r;
}

// out[n] = sum_k x[k] * W[k, n] over x = [x1 (K1 values), x2 (K2 values)],
// W row-major [K1 + K2, N]; epi(n, acc) consumes each float32 sum.
// Each thread owns kCols columns kThreads apart, so a warp reads W coalesced.
template <typename T, typename Epi>
__device__ void matvec(const float* x1, int K1, const float* x2, int K2,
                       const T* __restrict__ W, int N, Epi epi) {
  for (int n0 = threadIdx.x; n0 < N; n0 += kCols * kThreads) {
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.0f;
    for (int k = 0; k < K1 + K2; ++k) {
      const float xv = k < K1 ? x1[k] : x2[k - K1];
      const T* row = W + (long)k * N;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int n = n0 + j * kThreads;
        if (n < N) acc[j] = fmaf(xv, ld(row, n), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int n = n0 + j * kThreads;
      if (n < N) epi(n, acc[j]);
    }
  }
}

template <typename T>
struct Args {
  const T* feats;          // [B, R, F]
  const T* z;              // [B, Z]
  const float* gumbel;     // [B, 3, V]
  const float* mask_bias;  // [3, V]
  float tau;
  const T* wf;             // [F, A]
  const T* wh;             // [H, A]
  const float* bh;         // [A]
  const T* v;              // [A]
  const T* wc;             // [F, H]
  const float* bc;         // [H]
  const T* wi;             // [F, H]
  const float* bi;         // [H]
  const T* k;              // [F + E + Z + H, 4H]
  const float* bk;         // [4H]
  const T* wd;             // [H + F, E]
  const float* bd;         // [E]
  const T* wv;             // [E, V]
  const float* bv;         // [V]
  const T* emb;            // [V, E]
  T* proj;                 // [B, R, A] scratch
  T* y;                    // [B, 3, V]
  int R, F, A, H, E, Z, V, hard;
};

// Shared memory, in floats: the feature tile first (16-byte aligned), then
// the per-row vectors.
__host__ __device__ inline int tile_stride(int F) { return (F + 3) & ~3; }
__host__ __device__ inline long smem_floats(int R, int F, int A, int H, int E, int Z, int V,
                                            int row_tile) {
  const long K = (long)F + E + Z + H;
  return (long)row_tile * tile_stride(F) + K + H + F + 2L * A + R + 4L * H + E + V + kWarps;
}


template <typename T, int RT>
__global__ void __launch_bounds__(kThreads) fused_decode_kernel(Args<T> p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int R = p.R, F = p.F, A = p.A, H = p.H, E = p.E, Z = p.Z, V = p.V;
  const int I = F + E + Z;  // LSTM input width: ctx, prev, z
  const int K = I + H;      // LSTM kernel rows: input then h
  const int Fs = tile_stride(F);
  const int tid = threadIdx.x;
  const long b = blockIdx.x;

  float* tile = smem;                 // [RT, Fs]
  float* x = tile + RT * Fs;          // [K] = ctx | prev | z | h
  float* ctx = x;
  float* prev = x + F;
  float* zv = x + F + E;
  float* h = x + I;
  float* c = x + K;                   // [H]
  float* mean = c + H;                // [F]
  float* hp = mean + F;               // [A]
  float* vv = hp + A;                 // [A]
  float* sc = vv + A;                 // [R] attention scores, then weights
  float* gates = sc + R;              // [4H]
  float* dec = gates + 4 * H;         // [E]
  float* yv = dec + E;                // [V]
  float* red = yv + V;                // [kWarps]

  const T* feats = p.feats + b * R * F;
  T* proj = p.proj + b * R * A;

  for (int i = tid; i < Z; i += kThreads) zv[i] = ld(p.z, b * Z + i);
  for (int i = tid; i < A; i += kThreads) vv[i] = ld(p.v, i);
  for (int i = tid; i < E; i += kThreads) prev[i] = 0.0f;
  for (int i = tid; i < F; i += kThreads) mean[i] = 0.0f;

  // proj = feats @ wf and the feature sum, one tile of rows at a time.
  const int F4 = F & ~3;
  for (int r0 = 0; r0 < R; r0 += RT) {
    const int nr = min(RT, R - r0);
    __syncthreads();
    for (int idx = tid; idx < RT * F; idx += kThreads) {
      const int i = idx / F, f = idx - i * F;
      tile[i * Fs + f] = i < nr ? ld(feats, (long)(r0 + i) * F + f) : 0.0f;
    }
    __syncthreads();
    for (int f = tid; f < F; f += kThreads) {
      float s = 0.0f;
      for (int i = 0; i < nr; ++i) s += tile[i * Fs + f];
      mean[f] += s;
    }
    for (int a = tid; a < A; a += kThreads) {
      float acc[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i] = 0.0f;
      for (int f = 0; f < F4; f += 4) {
        const float w0 = ld(p.wf, (long)(f + 0) * A + a);
        const float w1 = ld(p.wf, (long)(f + 1) * A + a);
        const float w2 = ld(p.wf, (long)(f + 2) * A + a);
        const float w3 = ld(p.wf, (long)(f + 3) * A + a);
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          const float4 t = *reinterpret_cast<const float4*>(tile + i * Fs + f);
          acc[i] = fmaf(t.x, w0, acc[i]);
          acc[i] = fmaf(t.y, w1, acc[i]);
          acc[i] = fmaf(t.z, w2, acc[i]);
          acc[i] = fmaf(t.w, w3, acc[i]);
        }
      }
      for (int f = F4; f < F; ++f) {
        const float w = ld(p.wf, (long)f * A + a);
#pragma unroll
        for (int i = 0; i < RT; ++i) acc[i] = fmaf(tile[i * Fs + f], w, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
        if (i < nr) proj[(long)(r0 + i) * A + a] = to_t<T>(acc[i]);
    }
  }
  __syncthreads();
  for (int f = tid; f < F; f += kThreads) mean[f] = rnd<T>(mean[f] / (float)R);
  __syncthreads();

  // Show-Attend-Tell init: c, h = tanh(mean @ w + b).
  matvec<T>(mean, F, nullptr, 0, p.wc, H,
            [&](int n, float acc) { c[n] = rnd<T>(tanhf(acc + p.bc[n])); });
  matvec<T>(mean, F, nullptr, 0, p.wi, H,
            [&](int n, float acc) { h[n] = rnd<T>(tanhf(acc + p.bi[n])); });
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int t = 0; t < kSteps; ++t) {
    // Additive attention: scores, softmax over R, context.
    matvec<T>(h, H, nullptr, 0, p.wh, A,
              [&](int n, float acc) { hp[n] = rnd<T>(acc + p.bh[n]); });
    __syncthreads();
    for (int r = warp; r < R; r += kWarps) {
      float s = 0.0f;
      for (int a = lane; a < A; a += 32) {
        const float u = rnd<T>(ld(proj, (long)r * A + a) + hp[a]);
        s = fmaf(rnd<T>(tanhf(u)), vv[a], s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) sc[r] = s;
    }
    __syncthreads();
    float m = -INFINITY;
    for (int r = tid; r < R; r += kThreads) m = fmaxf(m, sc[r]);
    m = block_max(m, red);
    float se = 0.0f;
    for (int r = tid; r < R; r += kThreads) {
      const float e = expf(sc[r] - m);
      sc[r] = e;
      se += e;
    }
    se = block_sum(se, red);  // its barriers also publish sc
    for (int r = tid; r < R; r += kThreads) sc[r] = sc[r] / se;
    __syncthreads();
    for (int f = tid; f < F; f += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < R; ++r) s = fmaf(sc[r], ld(feats, (long)r * F + f), s);
      ctx[f] = rnd<T>(s);
    }
    __syncthreads();

    // TF1 LSTM cell on x = [ctx, prev, z, h].
    matvec<T>(x, K, nullptr, 0, p.k, 4 * H,
              [&](int n, float acc) { gates[n] = acc + p.bk[n]; });
    __syncthreads();
    for (int j = tid; j < H; j += kThreads) {
      const float gi = gates[j], gj = gates[H + j];
      const float gf = gates[2 * H + j], go = gates[3 * H + j];
      const float cf = c[j] * sigmoid(gf + 1.0f) + sigmoid(gi) * tanhf(gj);
      c[j] = rnd<T>(cf);
      h[j] = rnd<T>(tanhf(cf) * sigmoid(go));
    }
    __syncthreads();

    // Deep output on [h, ctx], then the vocab logits.
    matvec<T>(h, H, ctx, F, p.wd, E,
              [&](int n, float acc) { dec[n] = rnd<T>(tanhf(acc + p.bd[n])); });
    __syncthreads();
    const float* g = p.gumbel + (b * kSteps + t) * V;
    const float* mb = p.mask_bias + (long)t * V;
    matvec<T>(dec, E, nullptr, 0, p.wv, V, [&](int n, float acc) {
      const float logit = acc + p.bv[n] + mb[n];
      yv[n] = (logit + g[n]) / p.tau;
    });
    __syncthreads();

    // y = softmax(ly); in hard mode the one-hot of its first maximum.
    float ym = -INFINITY;
    for (int n = tid; n < V; n += kThreads) ym = fmaxf(ym, yv[n]);
    ym = block_max(ym, red);
    float sy = 0.0f;
    for (int n = tid; n < V; n += kThreads) {
      const float e = expf(yv[n] - ym);
      yv[n] = e;
      sy += e;
    }
    sy = block_sum(sy, red);
    for (int n = tid; n < V; n += kThreads) yv[n] = yv[n] / sy;
    if (p.hard) {
      float pm = -INFINITY;
      for (int n = tid; n < V; n += kThreads) pm = fmaxf(pm, yv[n]);
      pm = block_max(pm, red);
      int first = V;
      for (int n = tid; n < V; n += kThreads)
        if (yv[n] == pm) first = min(first, n);
      first = block_min_int(first, red);
      for (int n = tid; n < V; n += kThreads) yv[n] = n == first ? 1.0f : 0.0f;
    }
    T* yo = p.y + (b * kSteps + t) * V;
    for (int n = tid; n < V; n += kThreads) {
      const T q = to_t<T>(yv[n]);
      yo[n] = q;
      yv[n] = ld(&q, 0);
    }
    __syncthreads();

    // Embedding feedback: prev = y @ emb.
    matvec<T>(yv, V, nullptr, 0, p.emb, E,
              [&](int n, float acc) { prev[n] = rnd<T>(acc); });
    __syncthreads();
  }
}

// Whether this call is the first on the current device for the instance
// whose bits are `done` (one bit per device; past 64 devices, every call is).
inline cudaError_t first_on_device(std::atomic<unsigned long long>& done, bool* first,
                                   int* device) {
  cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  *first = *device >= 64 || !(done.load(std::memory_order_relaxed) & (1ull << *device));
  return cudaSuccess;
}

template <typename T, int RT>
cudaError_t launch_tile(const Args<T>& a, int B, cudaStream_t stream) {
  const long bytes =
      smem_floats(a.R, a.F, a.A, a.H, a.E, a.Z, a.V, RT) * (long)sizeof(float);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  // The limit is an attribute of the function on one device: raise it to
  // the card's most on the first launch there, not on every launch.
  static std::atomic<unsigned long long> done{0};
  bool first = false;
  int dev = 0;
  cudaError_t err = first_on_device(done, &first, &dev);
  if (err != cudaSuccess) return err;
  if (first) {
    err = cudaFuncSetAttribute(fused_decode_kernel<T, RT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemLimit);
    if (err != cudaSuccess) return err;
    if (dev < 64) done.fetch_or(1ull << dev, std::memory_order_relaxed);
  }
  fused_decode_kernel<T, RT><<<B, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args<T>& a, int B, int row_tile, cudaStream_t stream) {
  switch (row_tile) {
    case 32: return launch_tile<T, 32>(a, B, stream);
    case 16: return launch_tile<T, 16>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
Args<T> make_args(const void* feats, const void* z, const void* gumbel,
                  const void* mask_bias, float tau, const void* wf, const void* wh,
                  const void* bh, const void* v, const void* wc, const void* bc,
                  const void* wi, const void* bi, const void* k, const void* bk,
                  const void* wd, const void* bd, const void* wv, const void* bv,
                  const void* emb, void* proj, void* y, int R, int F, int A, int H,
                  int E, int Z, int V, int hard) {
  Args<T> a;
  a.feats = static_cast<const T*>(feats);
  a.z = static_cast<const T*>(z);
  a.gumbel = static_cast<const float*>(gumbel);
  a.mask_bias = static_cast<const float*>(mask_bias);
  a.tau = tau;
  a.wf = static_cast<const T*>(wf);
  a.wh = static_cast<const T*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.v = static_cast<const T*>(v);
  a.wc = static_cast<const T*>(wc);
  a.bc = static_cast<const float*>(bc);
  a.wi = static_cast<const T*>(wi);
  a.bi = static_cast<const float*>(bi);
  a.k = static_cast<const T*>(k);
  a.bk = static_cast<const float*>(bk);
  a.wd = static_cast<const T*>(wd);
  a.bd = static_cast<const float*>(bd);
  a.wv = static_cast<const T*>(wv);
  a.bv = static_cast<const float*>(bv);
  a.emb = static_cast<const T*>(emb);
  a.proj = static_cast<T*>(proj);
  a.y = static_cast<T*>(y);
  a.R = R; a.F = F; a.A = A; a.H = H; a.E = E; a.Z = Z; a.V = V; a.hard = hard;
  return a;
}


// ----------------------------------------------------------------- batched

namespace batched {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kStages = 4;          // cp.async ring depth of every product
constexpr int kCols = 32;           // output columns per item of a weight product
constexpr int kUnits = 8;           // hidden units per item of the gates product
constexpr int kCtxCols = kThreads;  // features per item of the context phase
constexpr int kMarks = 32;          // timestamps the timed instance may record

// Products a tensor-core sum: 16 in the weight products, kProjSum in proj.
// proj feeds every score through tanh and the softmax over R, so a proj
// value that rounds to the other bf16 neighbour of plain's moves y: with
// sums of 16, 1.2e-4 of proj and 0.71 % of y differ from plain at vg1k
// widths (gate 0.5 %); of 8, 0.57 %; of 4, 0.54 %; of 2, 4.1e-5 and 0.37 %
// (H100), at 8 times the mma.sync count. Plain sums in float32 in k order,
// and sums of 2 added round-to-nearest follow that chain closely: exact
// sums do not (fp64 on the tensor cores, m8n8k4: 1.2e-4 and 0.63 %), nor do
// narrower products (operands split into 4-bit halves) or summing again in
// float32 the values near a bf16 rounding midpoint. The chain itself, fmaf
// in k order on the CUDA cores, matched plain's proj bit for bit (0.064 %
// of y) but took 166 us against 90 at vg1k widths in a first version. The
// weight products' sum width moves y by under 0.02 %.
constexpr int kProjSum = 2;

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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d = a . b as one fresh tensor-core sum (a zero accumulator), m16n8k16
// and m16n8k8. Not volatile: the products of independent tiles may be
// scheduled around the adds that consume them.
__device__ __forceinline__ void mma16(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

__device__ __forceinline__ void mma8(float* d, uint32_t a0, uint32_t a1, uint32_t b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.0f));
}

// acc[i][j] += af[i] . bfr[j] over one 16-deep step for each of a warp's
// MT x NTW tiles, as fresh tensor-core sums of KS products each (16 or 2),
// every one added to acc with one round-to-nearest float32 add. mma.sync
// adds the products of a sum with truncation, so a sum of 16 lands several
// float32 ulps from the rounded sum; sums of 2 follow a float32 sum in k
// order, at 8 times the mma.sync count: m16n8k8's, where lane 4g + t holds
// k = 2t and 2t + 1 of an 8-deep half, with the other lanes' A fragments
// zero. One tile row's masked fragments are live at a time.
template <int KS, int MT, int NTW>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NTW][4], const uint32_t (&af)[MT][4],
                                          const uint32_t (&bfr)[NTW][2]) {
  static_assert(KS == 16 || KS == 2, "products a sum");
  float h[4];
  if constexpr (KS == 16) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        mma16(h, af[i], bfr[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], h[e]);
      }
  } else {
    const int t = threadIdx.x & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool on = t == q;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const uint32_t a0 = on ? af[i][2 * half] : 0u, a1 = on ? af[i][2 * half + 1] : 0u;
#pragma unroll
          for (int j = 0; j < NTW; ++j) {
            mma8(h, a0, a1, bfr[j][half]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], h[e]);
          }
        }
      }
  }
}

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The activations of a product: x[m, k] = p[m * ld + k] for m < M and
// k < K, zero past them. Rows are 16-byte aligned and K % 8 == 0.
struct XOp {
  const bf16* p;
  int ld, M, K;
};

// The weights of a product: w[k, n] = p[k * ld + n] for k < K, zero past
// it. An item takes Eng::kNT chunks of 8 columns, chunk c from column
// col0 + c * cstep, zero where the chunk starts at N or past it. Rows are
// 16-byte aligned, and a chunk that starts before N is read whole: N % 8
// == 0, or the columns past N up to ld are zero padding.
struct WOp {
  const bf16* p;
  int ld, K, N, col0, cstep;
};

// One item of a product: C[kBM, kBN] = x @ w[:, the item's columns], float32
// sums on the tensor cores (mma.sync, bf16 in, KS products a tensor-core
// sum: mma_tiles). WM x WN warps tile the rows and columns, and WK groups
// of them split each slice's depth; the groups' sums are added in group
// order. K goes through a ring of kStages slices of BK, fed by cp.async,
// with one __syncthreads per slice; rows of the ring are padded by 8
// elements, so each 8-row ldmatrix phase hits 32 distinct banks. The sum of
// every output is taken in an order fixed by K alone: not by B, the item or
// the block, and the same in every run.
template <int MT, int NTW, int WM, int WN, int WK, int BK, int KS>
struct Eng {
  static constexpr int kBM = 16 * MT * WM;               // rows
  static constexpr int kNT = NTW * WN;                   // chunks of 8 columns
  static constexpr int kBN = 8 * kNT;                    // columns
  static constexpr int kKS = BK / (16 * WK);             // 16-deep steps of a warp per slice
  static constexpr int kLdA = BK + 8, kLdB = kBN + 8;    // padded rows, in elements
  static constexpr int kLdC = kBN + 8;  // the sums' rows: a half-warp's float2 on 32 banks
  static constexpr int kStage = kBM * kLdA + BK * kLdB;  // elements of one ring slot
  static constexpr int kRing = 2 * kStages * kStage;     // bytes
  static constexpr int kRed = 4 * WK * kBM * kLdC;       // bytes of the groups' sums
  static constexpr int kSmem = kRing > kRed ? kRing : kRed;
  static constexpr int kXLoads = kBM * BK / 8 / kThreads;  // 16-byte words a thread loads
  static constexpr int kWLoads = BK * kNT / kThreads;
  static_assert(WM * WN * WK == kWarps && kKS >= 1 && BK == 16 * WK * kKS, "warps");
  static_assert(kXLoads * kThreads * 8 == kBM * BK && kWLoads * kThreads == BK * kNT,
                "whole words per thread");

  // The sums, in shared memory (row stride kLdC), after a __syncthreads.
  __device__ static const float* run(const XOp& x, const WOp& w, unsigned char* smem_raw) {
    bf16* smem = reinterpret_cast<bf16*>(smem_raw);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wk = warp / (WM * WN), wm = warp % WM, wn = warp / WM % WN;
    const int steps = (x.K + BK - 1) / BK;
    __syncthreads();  // the block's last reader of shared memory is done

    auto load = [&](int s) {
      bf16* As = smem + s % kStages * kStage;
      bf16* Bs = As + kBM * kLdA;
      const int k0 = s * BK;
#pragma unroll
      for (int q = 0; q < kXLoads; ++q) {
        const int i = tid + q * kThreads;
        const int r = i / (BK / 8), c = i % (BK / 8) * 8;
        const bool ok = r < x.M && k0 + c < x.K;
        cp_async16(As + r * kLdA + c, ok ? x.p + (long)r * x.ld + k0 + c : x.p, ok);
      }
#pragma unroll
      for (int q = 0; q < kWLoads; ++q) {
        const int i = tid + q * kThreads;
        const int r = i / kNT, ch = i % kNT;
        const int k = k0 + r, n = w.col0 + ch * w.cstep;
        const bool ok = k < w.K && n < w.N;
        cp_async16(Bs + r * kLdB + ch * 8, ok ? w.p + (long)k * w.ld + n : w.p, ok);
      }
    };

    float acc[MT][NTW][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < steps) load(s);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<kStages - 2>();  // slice s has landed, for this thread
      __syncthreads();               // for every thread; slice s - 1's slot is free
      if (s + kStages - 1 < steps) load(s + kStages - 1);
      cp_async_commit();
      const bf16* As = smem + s % kStages * kStage;
      const bf16* Bs = As + kBM * kLdA;
#pragma unroll
      for (int q = 0; q < kKS; ++q) {
        const int kk = (wk * kKS + q) * 16;
        uint32_t af[MT][4], bfr[NTW][2];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x4(af[i], As + (wm * 16 * MT + i * 16 + (lane & 15)) * kLdA + kk +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NTW; ++j)
          ldmatrix_x2_trans(bfr[j], Bs + (kk + (lane & 15)) * kLdB + (wn * NTW + j) * 8);
        mma_tiles<KS>(acc, af, bfr);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the sums

    // Lane 4g + t holds rows g and g + 8, columns 2t and 2t + 1 of each
    // 16 x 8 tile (PTX's m16n8k16 layout).
    float* red = reinterpret_cast<float*>(smem_raw);
    const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NTW; ++j) {
        float* o = red + ((wk * kBM) + wm * 16 * MT + i * 16 + g) * kLdC + (wn * NTW + j) * 8 +
                   2 * t4;
        *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(o + 8 * kLdC) = make_float2(acc[i][j][2], acc[i][j][3]);
      }
    __syncthreads();
    if (WK > 1) {
      for (int e = tid; e < kBM * kBN; e += kThreads) {
        const int at = e / kBN * kLdC + e % kBN;
        float s = red[at];
#pragma unroll
        for (int q = 1; q < WK; ++q) s = __fadd_rn(s, red[q * kBM * kLdC + at]);
        red[at] = s;
      }
      __syncthreads();
    }
    return red;
  }
};

// Weight products over the batch: kCols columns an item, each slice's 128
// rows split over the 8 warps. MT 16-row tiles hold the batch.
template <int MT> using WEng = Eng<MT, 4, 1, 1, kWarps, 128, 16>;
// proj = feats @ wf: 64 x 64 tiles, 2 x 4 warps of 32 x 16, 32-deep slices
// (64-deep ones leave the MT = 2 instance 24 bytes of spills).
using PEng = Eng<2, 2, 2, 4, 1, 32, kProjSum>;
static_assert(WEng<2>::kBN == kCols && WEng<4>::kBN == kCols && kCols == 4 * kUnits,
              "an item of the gates product is the four gates of kUnits hidden units");

// Dynamic shared memory of the instance with MT row tiles: the larger
// product's ring (the attention weights of the context phase, R floats,
// reuse it).
template <int MT> constexpr int smem_bytes() {
  return WEng<MT>::kSmem > PEng::kSmem ? WEng<MT>::kSmem : PEng::kSmem;
}

struct Args {
  const bf16* feats;       // [B, R, F]
  const bf16* z;           // [B, Z]
  const float* gumbel;     // [B, 3, V]
  const float* mask_bias;  // [3, V]
  float tau;
  const bf16 *wf, *wh;
  const float* bh;
  const bf16 *v, *wc;
  const float* bc;
  const bf16* wi;
  const float* bi;
  const bf16* k;
  const float* bk;
  const bf16* wd;
  const float* bd;
  const bf16* wv;
  const float* bv;
  const bf16* emb;
  bf16* y;  // [B, 3, V]
  // Scratch, carved by layout():
  bf16* proj;     // [B * R, A]
  bf16* xg;       // [B, F + E + Z + H]: ctx | prev | z | h, the gates' input
  bf16* xd;       // [B, H + F]: h | ctx, the deep output's input (h also hp's)
  bf16* mean;     // [B, F]
  bf16* dec;      // [B, E]
  bf16* ysoft;    // [B, Vx]: soft y, zero past V, the soft feedback's input
  float* cst;     // [B, H]: c
  float* hp;      // [B, A]
  float* scores;  // [B, R]
  float* ly;      // [B, V]: (logits + g) / tau
  bf16* wvp;      // [E, Vx]: wv, zero past V, where V % 8 != 0
  int B, R, F, A, H, E, Z, V, hard;
};

// Byte offsets of the scratch arrays in one buffer, each 256-byte aligned;
// fused_decode.py's scratch_bytes() adds them up the same way.
struct Layout {
  long proj, xg, xd, mean, dec, ysoft, cst, hp, scores, ly, wvp, bytes;
};

inline Layout layout(int B, int R, int F, int A, int H, int E, int Z, int V) {
  long o = 0;
  auto take = [&o](long bytes) {
    const long at = o;
    o = (o + bytes + 255) / 256 * 256;
    return at;
  };
  Layout L;
  L.proj = take(2L * B * R * A);
  L.xg = take(2L * B * (F + E + Z + H));
  L.xd = take(2L * B * (H + F));
  L.mean = take(2L * B * F);
  L.dec = take(2L * B * E);
  L.ysoft = take(2L * B * ((V + 7) / 8 * 8));
  L.cst = take(4L * B * H);
  L.hp = take(4L * B * A);
  L.scores = take(4L * B * R);
  L.ly = take(4L * B * V);
  L.wvp = take(V % 8 ? 2L * E * ((V + 7) / 8 * 8) : 0);
  L.bytes = o;
  return L;
}

// alpha[r] = softmax(s)[r] over one row of R scores, by one warp.
__device__ void softmax_row(const float* s, int R, float* alpha, int lane) {
  float m = -INFINITY;
  for (int r = lane; r < R; r += 32) m = fmaxf(m, s[r]);
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float se = 0.0f;
  for (int r = lane; r < R; r += 32) {
    const float e = expf(s[r] - m);
    alpha[r] = e;
    se += e;
  }
  for (int o = 16; o > 0; o >>= 1) se += __shfl_xor_sync(0xffffffffu, se, o);
  for (int r = lane; r < R; r += 32) alpha[r] = alpha[r] / se;
}

// The index the one-hot takes: the smallest n among the maxima of the
// float32 y_n = expf(lr[n] - m) / se, as the Pallas kernel picks it (not
// the argmax of lr: values of lr close to each other can give one y). V when
// no y equals the maximum (a NaN row). Every thread of the block calls it.
__device__ int first_max(const float* lr, int V, float m, float se, float* red) {
  float ym = -INFINITY;
  for (int n = threadIdx.x; n < V; n += kThreads) ym = fmaxf(ym, expf(lr[n] - m) / se);
  ym = block_max(ym, red);
  int first = V;
  for (int n = threadIdx.x; n < V; n += kThreads)
    if (expf(lr[n] - m) / se == ym) first = min(first, n);
  return block_min_int(first, red);
}

// The whole decode in one cooperative launch; phases (a)-(h) are separated
// by grid-wide barriers. Work items of a phase go to the blocks in turn
// (item i to block i % gridDim.x). kTimed: block 0 records %globaltimer
// at the start, after every barrier and at its end into times.
template <int MT, bool kTimed>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(Args p, long long* times) {
  using WE = WEng<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x, bid = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int B = p.B, R = p.R, F = p.F, A = p.A, H = p.H, E = p.E, Z = p.Z, V = p.V;
  const int I = F + E + Z, K = I + H, HF = H + F, Vx = (V + 7) / 8 * 8, BR = B * R;
  const long gt = (long)bid * kThreads + tid, gn = (long)nb * kThreads;
  int mark = 0;
  auto stamp = [&] {
    if (kTimed && bid == 0 && tid == 0 && mark < kMarks) times[mark] = globaltimer();
    ++mark;
  };
  auto barrier = [&] {
    grid.sync();
    stamp();
  };
  // hp = rnd(h @ wh + bh), columns [n0, n0 + kCols); h is xd's first H.
  auto hp_item = [&](int n0) {
    const float* C = WE::run(XOp{p.xd, HF, B, H}, WOp{p.wh, A, H, A, n0, 8}, smem);
    for (int e = tid; e < WE::kBM * kCols; e += kThreads) {
      const int b = e / kCols, c = e % kCols, n = n0 + c;
      if (b < B && n < A) p.hp[(long)b * A + n] = rnd<bf16>(C[b * WE::kLdC + c] + p.bh[n]);
    }
  };
  // proj = rnd(feats @ wf), tile it of PEng's [B * R, A] tiles.
  const int ptn = (A + PEng::kBN - 1) / PEng::kBN;
  const int ptiles = (BR + PEng::kBM - 1) / PEng::kBM * ptn;
  auto proj_tile = [&](int it) {
    const int m0 = it / ptn * PEng::kBM, n0 = it % ptn * PEng::kBN;
    const float* C = PEng::run(XOp{p.feats + (long)m0 * F, F, BR - m0, F},
                             WOp{p.wf, A, F, A, n0, 8}, smem);
    for (int e = tid; e < PEng::kBM * PEng::kBN; e += kThreads) {
      const int r = e / PEng::kBN, c = e % PEng::kBN, n = n0 + c;
      if (m0 + r < BR && n < A)
        p.proj[(long)(m0 + r) * A + n] = __float2bfloat16(C[r * PEng::kLdC + c]);
    }
  };
  stamp();

  // (a) mean = rnd(sum_r feats / R); prev = 0 and z into the gates' input;
  // soft y's padding past V zeroed; wv copied with its rows padded to Vx
  // where V % 8 != 0.
  for (long i = gt; i < (long)B * F; i += gn) {
    const long b = i / F;
    const bf16* col = p.feats + b * R * F + (i - b * F);
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s += __bfloat162float(col[(long)r * F]);
    p.mean[i] = __float2bfloat16(s / (float)R);
  }
  for (long i = gt; i < (long)B * (E + Z); i += gn) {
    const long b = i / (E + Z), c = i - b * (E + Z);
    p.xg[b * K + F + c] = c < E ? __float2bfloat16(0.0f) : p.z[b * Z + c - E];
  }
  for (long i = gt; i < (long)B * (Vx - V); i += gn) {
    const long b = i / (Vx - V);
    p.ysoft[b * Vx + V + (i - b * (Vx - V))] = __float2bfloat16(0.0f);
  }
  if (V % 8)
    for (long i = gt; i < (long)E * Vx; i += gn) {
      const long k = i / Vx, n = i - k * Vx;
      p.wvp[i] = n < V ? p.wv[k * V + n] : __float2bfloat16(0.0f);
    }
  barrier();

  // c, h = rnd(tanh(mean @ wc | wi + bc | bi)), the first 2 * nh items, and
  // proj's tiles beside them.
  {
    const int nh = (H + kCols - 1) / kCols;
    for (int it = bid; it < 2 * nh + ptiles; it += nb) {
      if (it >= 2 * nh) {
        proj_tile(it - 2 * nh);
        continue;
      }
      const bool is_c = it < nh;
      const int n0 = (is_c ? it : it - nh) * kCols;
      const float* C =
          WE::run(XOp{p.mean, F, B, F}, WOp{is_c ? p.wc : p.wi, H, F, H, n0, 8}, smem);
      for (int e = tid; e < WE::kBM * kCols; e += kThreads) {
        const int b = e / kCols, c = e % kCols, n = n0 + c;
        if (b >= B || n >= H) continue;
        const float acc = C[b * WE::kLdC + c];
        if (is_c) {
          p.cst[(long)b * H + n] = rnd<bf16>(tanhf(acc + p.bc[n]));
        } else {
          const bf16 h = __float2bfloat16(tanhf(acc + p.bi[n]));
          p.xd[(long)b * HF + n] = h;
          p.xg[(long)b * K + I + n] = h;
        }
      }
    }
  }
  barrier();
  for (int it = bid; it < (A + kCols - 1) / kCols; it += nb) hp_item(it * kCols);
  barrier();

  // (c) scores[b, r] = sum_a rnd(tanh(rnd(proj + hp))) v: a warp takes 4
  // rows (b, r) at once, 8 lanes a row, 8 values of a a lane at a time. The
  // first off blocks, where fewer than nb, hold another workload of the
  // phase and take none.
  auto scores = [&](int off) {
    const int busy = off < nb ? off : 0;  // blocks that other items of the phase hold
    const int vb = bid - busy;
    if (vb < 0) return;
    const int sub = lane >> 3, l8 = lane & 7;
    for (int it0 = (vb * kWarps + warp) * 4; it0 < BR; it0 += (nb - busy) * kWarps * 4) {
      const int it = it0 + sub;
      float s = 0.0f;
      if (it < BR) {
        const bf16* pr = p.proj + (long)it * A;
        const float* hb = p.hp + (long)(it / R) * A;
#pragma unroll 4
        for (int a0 = l8 * 8; a0 < A; a0 += 64) {
          const uint4 raw = *reinterpret_cast<const uint4*>(pr + a0);
          const uint4 vraw = *reinterpret_cast<const uint4*>(p.v + a0);
          const float4 h0 = *reinterpret_cast<const float4*>(hb + a0);
          const float4 h1 = *reinterpret_cast<const float4*>(hb + a0 + 4);
          const bf16* q = reinterpret_cast<const bf16*>(&raw);
          const bf16* vq = reinterpret_cast<const bf16*>(&vraw);
          const float hv[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float u = rnd<bf16>(__bfloat162float(q[i]) + hv[i]);
            s = fmaf(rnd<bf16>(tanhf(u)), __bfloat162float(vq[i]), s);
          }
        }
      }
      for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (l8 == 0 && it < BR) p.scores[it] = s;
    }
  };
  // (d) alpha = softmax of row b's scores; ctx = rnd(alpha . feats), an
  // item per (b, slice of kCtxCols features); the first off blocks take
  // theirs last.
  auto context = [&](int off) {
    const int vb = (bid + nb - off % nb) % nb;
    float* alpha = reinterpret_cast<float*>(smem);
    const int nf = (F + kCtxCols - 1) / kCtxCols;
    for (int it = vb; it < B * nf; it += nb) {
      const int b = it / nf, f = it % nf * kCtxCols + tid;
      __syncthreads();  // the last item's readers of alpha are done
      if (warp == 0) softmax_row(p.scores + (long)b * R, R, alpha, lane);
      __syncthreads();
      if (f < F) {
        const bf16* col = p.feats + (long)b * R * F + f;
        float s = 0.0f;
        for (int r = 0; r < R; ++r) s = fmaf(alpha[r], __bfloat162float(col[(long)r * F]), s);
        const bf16 ctx = __float2bfloat16(s);  // ctx, rounded
        p.xg[(long)b * K + f] = ctx;
        p.xd[(long)b * HF + H + f] = ctx;
      }
    }
  };

  // Step 0's scores and context; step t + 1's run beside step t's logits
  // and sampling, which do not touch what they read or write.
  scores(0);
  barrier();
  context(0);
  barrier();
  for (int t = 0; t < kSteps; ++t) {
    // (e) gates = [ctx, prev, z, h] @ k + bk: an item is kUnits hidden units
    // j and their columns j, H + j, 2H + j and 3H + j, so the TF1 cell (i, j,
    // f, o; forget bias 1.0) runs in its epilogue and writes c and h.
    for (int it = bid; it < H / kUnits; it += nb) {
      const int j0 = it * kUnits;
      const float* C = WE::run(XOp{p.xg, K, B, K}, WOp{p.k, 4 * H, K, 4 * H, j0, H}, smem);
      for (int e = tid; e < WE::kBM * kUnits; e += kThreads) {
        const int b = e / kUnits, u = e % kUnits, j = j0 + u;
        if (b >= B) continue;
        const float* g = C + b * WE::kLdC + u;
        const float gi = g[0] + p.bk[j], gj = g[kUnits] + p.bk[H + j];
        const float gf = g[2 * kUnits] + p.bk[2 * H + j], go = g[3 * kUnits] + p.bk[3 * H + j];
        float* c = p.cst + (long)b * H + j;
        const float cf =
            __fadd_rn(__fmul_rn(*c, sigmoid(gf + 1.0f)), __fmul_rn(sigmoid(gi), tanhf(gj)));
        *c = rnd<bf16>(cf);  // c, rounded
        const bf16 h = __float2bfloat16(__fmul_rn(tanhf(cf), sigmoid(go)));  // h, rounded
        p.xd[(long)b * HF + j] = h;
      }
    }
    barrier();

    // (f) dec = rnd(tanh([h, ctx] @ wd + bd)); hp for the next step.
    {
      const int ne = (E + kCols - 1) / kCols;
      const int items = ne + (t + 1 < kSteps ? (A + kCols - 1) / kCols : 0);
      for (int it = bid; it < items; it += nb) {
        if (it >= ne) {
          hp_item((it - ne) * kCols);
          continue;
        }
        const int n0 = it * kCols;
        const float* C = WE::run(XOp{p.xd, HF, B, HF}, WOp{p.wd, E, HF, E, n0, 8}, smem);
        for (int e = tid; e < WE::kBM * kCols; e += kThreads) {
          const int b = e / kCols, c = e % kCols, n = n0 + c;
          if (b < B && n < E)
            p.dec[(long)b * E + n] = __float2bfloat16(tanhf(C[b * WE::kLdC + c] + p.bd[n]));
        }
      }
    }
    barrier();

    // (g) ly = (dec @ wv + bv + mask + g) / tau, kCols columns an item; h
    // into the gates' input for the next step; the next step's scores.
    {
      const bf16* wv = V % 8 ? p.wvp : p.wv;
      const int ldv = V % 8 ? Vx : V;
      for (int it = bid; it < (V + kCols - 1) / kCols; it += nb) {
        const int n0 = it * kCols;
        const float* C = WE::run(XOp{p.dec, E, B, E}, WOp{wv, ldv, E, V, n0, 8}, smem);
        for (int e = tid; e < WE::kBM * kCols; e += kThreads) {
          const int b = e / kCols, c = e % kCols, n = n0 + c;
          if (b >= B || n >= V) continue;
          const float logit = C[b * WE::kLdC + c] + p.bv[n] + p.mask_bias[(long)t * V + n];
          p.ly[(long)b * V + n] = (logit + p.gumbel[((long)b * kSteps + t) * V + n]) / p.tau;
        }
      }
      for (long i = gt; i < (long)B * H; i += gn) {
        const long b = i / H, j = i - b * H;
        p.xg[b * K + I + j] = p.xd[b * HF + j];
      }
      if (t + 1 < kSteps) scores((V + kCols - 1) / kCols);
    }
    barrier();

    // (h) y = softmax(ly), a block per row; in hard mode the one-hot of its
    // first maximum, and prev = that row of emb, which is rnd(y @ emb) bit
    // for bit; in soft mode prev = rnd(y @ emb) after one more barrier. The
    // next step's context beside them.
    for (int b = bid; b < B; b += nb) {
      const float* lr = p.ly + (long)b * V;
      bf16* yo = p.y + ((long)b * kSteps + t) * V;
      float m = -INFINITY;
      for (int n = tid; n < V; n += kThreads) m = fmaxf(m, lr[n]);
      m = block_max(m, red);
      float se = 0.0f;
      for (int n = tid; n < V; n += kThreads) se += expf(lr[n] - m);
      se = block_sum(se, red);
      if (p.hard) {
        const int first = first_max(lr, V, m, se, red);
        for (int n = tid; n < V; n += kThreads) yo[n] = __float2bfloat16(n == first ? 1.0f : 0.0f);
        for (int e = tid; e < E; e += kThreads)
          p.xg[(long)b * K + F + e] =
              first < V ? p.emb[(long)first * E + e] : __float2bfloat16(0.0f);
      } else {
        for (int n = tid; n < V; n += kThreads) {
          const bf16 q = __float2bfloat16(expf(lr[n] - m) / se);
          yo[n] = q;
          p.ysoft[(long)b * Vx + n] = q;
        }
      }
    }
    if (t + 1 < kSteps) context(B);
    if (!p.hard) {
      barrier();
      for (int it = bid; it < (E + kCols - 1) / kCols; it += nb) {
        const int n0 = it * kCols;
        const float* C = WE::run(XOp{p.ysoft, Vx, B, Vx}, WOp{p.emb, E, V, E, n0, 8}, smem);
        for (int e = tid; e < WE::kBM * kCols; e += kThreads) {
          const int b = e / kCols, c = e % kCols, n = n0 + c;
          if (b < B && n < E) p.xg[(long)b * K + F + n] = __float2bfloat16(C[b * WE::kLdC + c]);
        }
      }
    }
    if (t + 1 < kSteps) barrier();
  }
  stamp();
}

// One cooperative launch of the instance with MT row tiles. On a device's
// first launch of it: the card must take cooperative launches, the
// shared-memory limit is raised, and the blocks that can be co-resident are
// counted; a grid larger than that is refused, never launched.
template <int MT, bool kTimed>
cudaError_t launch(const Args& a, long long* times, int grid, cudaStream_t s) {
  auto kernel = decode_kernel<MT, kTimed>;
  constexpr int smem = smem_bytes<MT>();
  static std::atomic<unsigned long long> done{0};
  static std::atomic<int> capacity[64];
  bool first = false;
  int dev = 0;
  cudaError_t err = first_on_device(done, &first, &dev);
  if (err != cudaSuccess) return err;
  int cap = dev < 64 ? capacity[dev].load(std::memory_order_relaxed) : 0;
  if (first) {
    int coop = 0, sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cap = per_sm * sms;
    if (dev < 64) {
      capacity[dev].store(cap, std::memory_order_relaxed);
      done.fetch_or(1ull << dev, std::memory_order_relaxed);
    }
  }
  if (grid < 1 || grid > cap) return cudaErrorCooperativeLaunchTooLarge;
  Args args = a;
  void* params[] = {&args, &times};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid),
                                    dim3(kThreads), params, (size_t)smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The checks and the launch behind both C entries of the batched instance.
cudaError_t entry(int hard, int B, int R, int F, int A, int H, int E, int Z, int V,
                  const void* feats, const void* z, const void* gumbel, const void* mask_bias,
                  float tau, const void* wf, const void* wh, const void* bh, const void* v,
                  const void* wc, const void* bc, const void* wi, const void* bi, const void* k,
                  const void* bk, const void* wd, const void* bd, const void* wv, const void* bv,
                  const void* emb, void* scratch, void* y, int mt, int grid, int threads,
                  int stages, int smem, long long scratch_bytes, long long* times,
                  cudaStream_t s) {
  if (B < 1 || B > 16 * mt || R < 1 || V < 1 || F < 8 || A < 8 || H < 8 || E < 8 || Z < 0 ||
      F % 8 || A % 8 || H % 8 || E % 8 || Z % 8 || 4 * R > smem)
    return cudaErrorInvalidValue;
  if (threads != kThreads || stages != kStages) return cudaErrorInvalidValue;
  const Layout L = layout(B, R, F, A, H, E, Z, V);
  if (scratch_bytes != L.bytes || reinterpret_cast<uintptr_t>(scratch) % 256 != 0)
    return cudaErrorInvalidValue;
  for (const void* p : {feats, z, wf, wh, v, wc, wi, k, wd, wv, emb})
    if (!aligned16(p)) return cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Args a;
  a.feats = static_cast<const bf16*>(feats);
  a.z = static_cast<const bf16*>(z);
  a.gumbel = static_cast<const float*>(gumbel);
  a.mask_bias = static_cast<const float*>(mask_bias);
  a.tau = tau;
  a.wf = static_cast<const bf16*>(wf);
  a.wh = static_cast<const bf16*>(wh);
  a.bh = static_cast<const float*>(bh);
  a.v = static_cast<const bf16*>(v);
  a.wc = static_cast<const bf16*>(wc);
  a.bc = static_cast<const float*>(bc);
  a.wi = static_cast<const bf16*>(wi);
  a.bi = static_cast<const float*>(bi);
  a.k = static_cast<const bf16*>(k);
  a.bk = static_cast<const float*>(bk);
  a.wd = static_cast<const bf16*>(wd);
  a.bd = static_cast<const float*>(bd);
  a.wv = static_cast<const bf16*>(wv);
  a.bv = static_cast<const float*>(bv);
  a.emb = static_cast<const bf16*>(emb);
  a.y = static_cast<bf16*>(y);
  a.proj = reinterpret_cast<bf16*>(base + L.proj);
  a.xg = reinterpret_cast<bf16*>(base + L.xg);
  a.xd = reinterpret_cast<bf16*>(base + L.xd);
  a.mean = reinterpret_cast<bf16*>(base + L.mean);
  a.dec = reinterpret_cast<bf16*>(base + L.dec);
  a.ysoft = reinterpret_cast<bf16*>(base + L.ysoft);
  a.cst = reinterpret_cast<float*>(base + L.cst);
  a.hp = reinterpret_cast<float*>(base + L.hp);
  a.scores = reinterpret_cast<float*>(base + L.scores);
  a.ly = reinterpret_cast<float*>(base + L.ly);
  a.wvp = reinterpret_cast<bf16*>(base + L.wvp);
  a.B = B; a.R = R; a.F = F; a.A = A; a.H = H; a.E = E; a.Z = Z; a.V = V; a.hard = hard;
  const bool timed = times != nullptr;
  if (mt == 2 && smem == smem_bytes<2>())
    return timed ? launch<2, true>(a, times, grid, s) : launch<2, false>(a, times, grid, s);
  if (mt == 4 && smem == smem_bytes<4>())
    return timed ? launch<4, true>(a, times, grid, s) : launch<4, false>(a, times, grid, s);
  return cudaErrorInvalidValue;
}

}  // namespace batched

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. row_tile: the feature rows staged at a
// time, 32 or 16, as fused_decode.plan() picks it. All pointers are device pointers
// to contiguous arrays; `proj` is caller-allocated scratch of B*R*A elements
// of the compute type. Returns the launch's cudaError_t (0 on success).
extern "C" cudaError_t sgg_fused_decode(
    int dtype, int hard, int row_tile, int B, int R, int F, int A, int H, int E, int Z, int V,
    const void* feats, const void* z, const void* gumbel, const void* mask_bias,
    float tau, const void* wf, const void* wh, const void* bh, const void* v,
    const void* wc, const void* bc, const void* wi, const void* bi, const void* k,
    const void* bk, const void* wd, const void* bd, const void* wv, const void* bv,
    const void* emb, void* proj, void* y, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch(make_args<float>(feats, z, gumbel, mask_bias, tau, wf, wh, bh, v, wc, bc,
                                   wi, bi, k, bk, wd, bd, wv, bv, emb, proj, y, R, F, A,
                                   H, E, Z, V, hard),
                  B, row_tile, s);
  if (dtype == 1)
    return launch(make_args<__nv_bfloat16>(feats, z, gumbel, mask_bias, tau, wf, wh, bh, v,
                                           wc, bc, wi, bi, k, bk, wd, bd, wv, bv, emb, proj,
                                           y, R, F, A, H, E, Z, V, hard),
                  B, row_tile, s);
  return cudaErrorInvalidValue;
}


// The batched bf16 instance at the launch fused_decode.plan() gives: mt
// 16-row tiles of the batch (2 or 4), the grid (at most the blocks the card
// holds at once), threads, ring depth and dynamic shared memory, and the
// scratch buffer of scratch_bytes (256-byte aligned) that fused_decode.py's
// scratch_bytes() sizes. feats, z and the bf16 weights are 16-byte aligned;
// F, A, H, E and Z are multiples of 8; B <= 16 * mt. A plan that names no
// instance below, or whose shared memory, grid or scratch is not that
// instance's, is refused (cudaErrorInvalidValue, or
// cudaErrorCooperativeLaunchTooLarge for a grid that cannot be co-resident)
// and nothing is launched.
extern "C" cudaError_t sgg_fused_decode_batched(
    int hard, int B, int R, int F, int A, int H, int E, int Z, int V, const void* feats,
    const void* z, const void* gumbel, const void* mask_bias, float tau, const void* wf,
    const void* wh, const void* bh, const void* v, const void* wc, const void* bc,
    const void* wi, const void* bi, const void* k, const void* bk, const void* wd,
    const void* bd, const void* wv, const void* bv, const void* emb, void* scratch, void* y,
    int mt, int grid, int threads, int stages, int smem, long long scratch_bytes,
    void* stream) {
  return batched::entry(hard, B, R, F, A, H, E, Z, V, feats, z, gumbel, mask_bias, tau, wf, wh,
                        bh, v, wc, bc, wi, bi, k, bk, wd, bd, wv, bv, emb, scratch, y, mt, grid,
                        threads, stages, smem, scratch_bytes, nullptr,
                        static_cast<cudaStream_t>(stream));
}

// Check-only: the same launch of the timed instance, whose block 0 writes
// %globaltimer (ns) at its start, after every grid barrier and at its end
// into times (at least 32 int64). The wrapper never calls it.
extern "C" cudaError_t sgg_fused_decode_batched_timed(
    int hard, int B, int R, int F, int A, int H, int E, int Z, int V, const void* feats,
    const void* z, const void* gumbel, const void* mask_bias, float tau, const void* wf,
    const void* wh, const void* bh, const void* v, const void* wc, const void* bc,
    const void* wi, const void* bi, const void* k, const void* bk, const void* wd,
    const void* bd, const void* wv, const void* bv, const void* emb, void* scratch, void* y,
    int mt, int grid, int threads, int stages, int smem, long long scratch_bytes,
    void* times, void* stream) {
  if (times == nullptr) return cudaErrorInvalidValue;
  return batched::entry(hard, B, R, F, A, H, E, Z, V, feats, z, gumbel, mask_bias, tau, wf, wh,
                        bh, v, wc, bc, wi, bi, k, bk, wd, bd, wv, bv, emb, scratch, y, mt, grid,
                        threads, stages, smem, scratch_bytes, static_cast<long long*>(times),
                        static_cast<cudaStream_t>(stream));
}
