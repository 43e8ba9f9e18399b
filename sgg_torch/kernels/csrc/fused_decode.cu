// Fused 3-step triple decode for Hopper (sm_90a), one thread block per batch row.
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
// biases, the mask and the Gumbel noise are float32.
//
// What bounds it: at the generate shapes (B=64, R=196, F=512, H=512, V=210,
// bf16) one launch must read about 21 MB (8 MB of weights, 13 MB of features),
// about 6 us at 3.35 TB/s; the arithmetic (4.7 GFLOP) is under 5 us on the
// tensor cores. At the resnet50 widths (B=32, R=49, F=2048, V=8192) one
// launch must read about 39 MB, about 12 us. This first version is simple
// rather than fast: the weights (too large for one SM's shared memory) are
// read from global memory, where they stay in the 50 MB L2, by every block;
// products run on the CUDA cores;
// proj goes to a global scratch buffer that the caller allocates; the feature
// rows are staged through shared memory in tiles of RT rows. RT is chosen at
// launch from the widths (sgg_fused_decode_row_tile): 32 where its shared
// memory fits one block, as at vg1k widths (R = 196, F = 512), else 16, as at
// resnet50 widths (F = 2048), where 32 rows would need 328 KB and 16 need
// 197 KB. The tile only stages rows: proj does not depend on it.
//
// Plain C interface for ctypes: no PyTorch headers, so nvcc builds it in
// seconds. The entry returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowTiles[] = {32, 16};  // feature rows staged at a time, by preference
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

// The largest preferred row tile whose shared memory fits a block, or 0.
inline int pick_row_tile(int R, int F, int A, int H, int E, int Z, int V) {
  for (int rt : kRowTiles)
    if (smem_floats(R, F, A, H, E, Z, V, rt) * (long)sizeof(float) <= kSmemLimit) return rt;
  return 0;
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

template <typename T, int RT>
cudaError_t launch_tile(const Args<T>& a, int B, cudaStream_t stream) {
  const long bytes =
      smem_floats(a.R, a.F, a.A, a.H, a.E, a.Z, a.V, RT) * (long)sizeof(float);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_decode_kernel<T, RT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. row_tile: the value of
// sgg_fused_decode_row_tile at these widths. All pointers are device pointers
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

// Feature rows the launch stages at a time at these widths: 32 or 16,
// whichever is the larger whose shared memory fits one block; 0 if neither
// does.
extern "C" int sgg_fused_decode_row_tile(int R, int F, int A, int H, int E, int Z, int V) {
  return pick_row_tile(R, F, A, H, E, Z, V);
}
