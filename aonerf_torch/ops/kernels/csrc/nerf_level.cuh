// Device code shared by the fused NeRF level (fused_render.cu, K1, the
// forward) and its training side (fused_train.cu: K1s, the forward that saves
// the activations, and K2, the weight gradient), for Hopper (sm_90a).
//
// Both walk a block's rays in chunks of kRows samples packed across ray
// boundaries, run the 8x256 MLP on a chunk with its activation in shared
// memory and the weights streamed in 32-row K-slices through a cp.async
// double buffer, and integrate each ray with one warp (a prefix sum of
// log(max(1 - alpha + 1e-10, 1e-10)) with a carry across 32-sample steps).
// The training forward also saves each chunk's activations to a per-row
// scratch (`Spill`, kSpill floats per sample) by bulk copies out of the
// shared activation tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aonerf {

constexpr int kWidth = 256;      // trunk width
constexpr int kCondWidth = 128;  // view-branch width
constexpr int kPos = 63;         // encoded sample features
constexpr int kPosPad = 64;
constexpr int kView = 27;        // encoded view-direction features
constexpr int kRows = 64;        // rows (samples) per chunk
constexpr int kSlice = 32;       // weight rows per staged K-slice
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Saved activations per sample: h0..h7, the bottleneck, the view hidden layer.
constexpr int kSpillBtl = 8 * kWidth;
constexpr int kSpillView = kSpillBtl + kWidth;
constexpr int kSpill = kSpillView + kCondWidth;

struct Weights {
  const float *w0, *b0, *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
  const float *w5x, *w5i, *b5, *w6, *b6, *w7, *b7;
  const float *wd, *bd, *wb, *bb, *wva, *wvb, *bv, *wr, *br;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;  // n == 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bulk copies out of shared memory (Hopper's copy engine). The generic-proxy
// writes a thread made to shared memory become visible to the async proxy
// after fence_proxy_async and a barrier. bulk_store_row copies `bytes` (a
// multiple of 16, both addresses 16-byte aligned) from shared memory to
// device memory in the calling thread's current bulk group, which
// bulk_commit closes, under the L2 policy `policy` (evict_first_policy: the
// copied lines are the first to leave L2, so a stream of them does not evict
// the weights every chunk re-reads). bulk_wait_read returns once every
// committed group of the thread has finished reading shared memory,
// bulk_wait_all once their writes are done.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}
__device__ __forceinline__ void bulk_store_row(float* dst, const float* src, int bytes, uint64_t policy) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
               "r"(s), "r"(bytes), "l"(policy)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Stage rows [k0, k0+kSlice) of the (K, N) row-major weight W into buf
// (kSlice x N); rows past K are zero-filled.
template <int N>
__device__ __forceinline__ void stage_slice(float* buf, const float* __restrict__ W, int k0, int K) {
  constexpr int kVec = N / 4;
#pragma unroll
  for (int i = threadIdx.x; i < kSlice * kVec; i += kThreads) {
    const int kk = i / kVec, c = (i % kVec) * 4;
    const int k = k0 + kk;
    const bool valid = k < K;
    cp_async16(buf + kk * N + c, valid ? W + (size_t)k * N + c : W, valid);
  }
  cp_async_commit();
}

// acc[i][j] += sum_k A[row_i][k] * W[k][col_j] over k < K, for this thread's
// rows 8*warp + i and columns 4*lane + (j%4) + 128*(j/4). A is (kRows x lda)
// in shared memory; columns of A at or past K must be finite (they meet the
// zero-filled weight rows). Ends with a barrier: every thread has finished
// reading A and wbuf when it returns. With Spill, thread 0's bulk copies of
// the previous layer's activation have also finished reading it by then, so
// the caller may overwrite it.
template <int N, bool Spill = false>
__device__ __forceinline__ void gemm_acc(float (&acc)[8][N / 32], const float* A, int lda, int K,
                                         const float* __restrict__ W, float* wbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_slices = (K + kSlice - 1) / kSlice;
  const float* a_base = A + (warp * 8) * lda;
  stage_slice<N>(wbuf, W, 0, K);
  for (int s = 0; s < n_slices; ++s) {
    const float* cur = wbuf + (s & 1) * kSlice * kWidth;
    if (s + 1 < n_slices) {
      stage_slice<N>(wbuf + ((s + 1) & 1) * kSlice * kWidth, W, (s + 1) * kSlice, K);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* a_s = a_base + s * kSlice;
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = *reinterpret_cast<const float4*>(a_s + i * lda + kk);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* wrow = cur + (kk + q) * N + lane * 4;
        const float4 b0 = *reinterpret_cast<const float4*>(wrow);
        float4 b1 = b0;
        if constexpr (N == 256) b1 = *reinterpret_cast<const float4*>(wrow + 128);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = q == 0 ? a[i].x : q == 1 ? a[i].y : q == 2 ? a[i].z : a[i].w;
          acc[i][0] = fmaf(av, b0.x, acc[i][0]);
          acc[i][1] = fmaf(av, b0.y, acc[i][1]);
          acc[i][2] = fmaf(av, b0.z, acc[i][2]);
          acc[i][3] = fmaf(av, b0.w, acc[i][3]);
          if constexpr (N == 256) {
            acc[i][4] = fmaf(av, b1.x, acc[i][4]);
            acc[i][5] = fmaf(av, b1.y, acc[i][5]);
            acc[i][6] = fmaf(av, b1.z, acc[i][6]);
            acc[i][7] = fmaf(av, b1.w, acc[i][7]);
          }
        }
      }
    }
    if constexpr (Spill) {
      if (s + 1 == n_slices && threadIdx.x == 0) bulk_wait_read();
    }
    __syncthreads();
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[8][N / 32]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < N / 32; ++j) acc[i][j] = 0.f;
}

// act[row][col] = (relu)(acc + bias[col] (+ cterm[ray(row)][col])), then a
// barrier so the next layer reads the whole new activation. With Spill,
// thread 0 then copies the rows below valid_rows (N floats each) to
// spill + row * kSpill by bulk copies, one committed group; the next
// gemm_acc<N, true> waits for them to finish reading act.
template <int N, bool Spill>
__device__ __forceinline__ void store_act(const float (&acc)[8][N / 32], const float* __restrict__ bias,
                                          bool relu, float* act, const float* cterm, int row0,
                                          int S, int n_rows, float* spill, int valid_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float b[N / 32];
#pragma unroll
  for (int j = 0; j < N / 32; ++j) b[j] = __ldg(bias + lane * 4 + (j % 4) + 128 * (j / 4));
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
    const float* ct = nullptr;
    if (cterm != nullptr) {
      const int local = min(row0 + r, n_rows - 1);  // padded rows reuse the last ray
      ct = cterm + (local / S) * kCondWidth;
    }
#pragma unroll
    for (int h = 0; h < N / 128; ++h) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = h * 4 + q;
        float x = acc[i][j] + b[j];
        if (ct != nullptr) x += ct[lane * 4 + q + 128 * h];
        v[q] = relu ? fmaxf(x, 0.f) : x;
      }
      *reinterpret_cast<float4*>(act + r * kWidth + h * 128 + lane * 4) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  if constexpr (Spill) fence_proxy_async();
  __syncthreads();
  if constexpr (Spill) {
    if (threadIdx.x == 0) {
      const uint64_t policy = evict_first_policy();
      for (int r = 0; r < valid_rows; ++r)
        bulk_store_row(spill + (size_t)r * kSpill, act + r * kWidth, N * 4, policy);
      bulk_commit();
    }
  }
}

// One 256x256 (or K x 256) layer with ReLU, in place over act.
template <bool Spill>
__device__ __forceinline__ void dense_relu(const float* A, int lda, int K, const float* W,
                                           const float* bias, float* act, float* wbuf, float* spill,
                                           int valid_rows) {
  float acc[8][8];
  zero<256>(acc);
  gemm_acc<256, Spill>(acc, A, lda, K, W, wbuf);
  store_act<256, Spill>(acc, bias, true, act, nullptr, 0, 1, 1, spill, valid_rows);
}

// Per-ray view-condition term: cterm[g][n] = venc[ray0+g] . wvb[:, n].
__device__ __forceinline__ void view_terms(const float* __restrict__ venc, const float* __restrict__ wvb,
                                           float* cterm, int ray0, int ray_tile) {
  for (int i = threadIdx.x; i < ray_tile * kCondWidth; i += kThreads) {
    const int g = i / kCondWidth, n = i % kCondWidth;
    const float* v = venc + (size_t)(ray0 + g) * kView;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kView; ++k) s = fmaf(__ldg(v + k), __ldg(wvb + k * kCondWidth + n), s);
    cterm[i] = s;
  }
}

// The MLP on the chunk of rows [row0, row0 + kRows) of the block's n_rows
// packed samples: raw sigma to sig[row], raw rgb to rgb[3 row]. With Spill,
// each layer's activation of the valid rows also goes to the saved-activation
// rows at `spill` (already offset to the chunk's first row). Ends with a
// barrier.
template <bool Spill>
__device__ __forceinline__ void forward_chunk(const float* __restrict__ xenc, const Weights& w,
                                              float* act, float* xs, float* wbuf, const float* cterm,
                                              float* sig, float* rgb, size_t row_base, int row0,
                                              int n_rows, int S, float* spill) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int valid_rows = min(kRows, n_rows - row0);
  // Encoded inputs of this chunk; padded rows and the pad column are 0.
  const float* xg = xenc + (row_base + row0) * kPos;
  for (int i = threadIdx.x; i < kRows * kPosPad; i += kThreads) {
    const int r = i / kPosPad, c = i % kPosPad;
    xs[i] = (r < valid_rows && c < kPos) ? __ldg(xg + r * kPos + c) : 0.f;
  }
  __syncthreads();

  dense_relu<Spill>(xs, kPosPad, kPos, w.w0, w.b0, act, wbuf, spill, valid_rows);
  dense_relu<Spill>(act, kWidth, kWidth, w.w1, w.b1, act, wbuf, spill + kWidth, valid_rows);
  dense_relu<Spill>(act, kWidth, kWidth, w.w2, w.b2, act, wbuf, spill + 2 * kWidth, valid_rows);
  dense_relu<Spill>(act, kWidth, kWidth, w.w3, w.b3, act, wbuf, spill + 3 * kWidth, valid_rows);
  dense_relu<Spill>(act, kWidth, kWidth, w.w4, w.b4, act, wbuf, spill + 4 * kWidth, valid_rows);
  {  // skip layer: relu(h . w5x + x_enc . w5i + b5)
    float a5[8][8];
    zero<256>(a5);
    gemm_acc<256>(a5, act, kWidth, kWidth, w.w5x, wbuf);
    gemm_acc<256, Spill>(a5, xs, kPosPad, kPos, w.w5i, wbuf);
    store_act<256, Spill>(a5, w.b5, true, act, nullptr, 0, 1, 1, spill + 5 * kWidth, valid_rows);
  }
  dense_relu<Spill>(act, kWidth, kWidth, w.w6, w.b6, act, wbuf, spill + 6 * kWidth, valid_rows);
  dense_relu<Spill>(act, kWidth, kWidth, w.w7, w.b7, act, wbuf, spill + 7 * kWidth, valid_rows);

  // Density head (256 -> 1), one warp per row.
  const float bd = __ldg(w.bd);
  for (int r = warp; r < valid_rows; r += kWarps) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(act[r * kWidth + lane + 32 * i], __ldg(w.wd + lane + 32 * i), s);
    s = warp_sum(s);
    if (lane == 0) sig[row0 + r] = s + bd;
  }
  {  // bottleneck (no activation), in place; gemm_acc's first barrier
     // orders it after the density reads
    float ab[8][8];
    zero<256>(ab);
    gemm_acc<256, Spill>(ab, act, kWidth, kWidth, w.wb, wbuf);
    store_act<256, Spill>(ab, w.bb, false, act, nullptr, 0, 1, 1, spill + kSpillBtl, valid_rows);
  }
  {  // view layer: relu(btl . wva + cterm[ray] + bv) -> act[:, :128]
    float av[8][4];
    zero<128>(av);
    gemm_acc<128, Spill>(av, act, kWidth, kWidth, w.wva, wbuf);
    store_act<128, Spill>(av, w.bv, true, act, cterm, row0, S, n_rows, spill + kSpillView, valid_rows);
  }
  // rgb head (128 -> 3), one warp per row.
  for (int r = warp; r < valid_rows; r += kWarps) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lane + 32 * i;
      const float v = act[r * kWidth + k];
      s0 = fmaf(v, __ldg(w.wr + k * 3 + 0), s0);
      s1 = fmaf(v, __ldg(w.wr + k * 3 + 1), s1);
      s2 = fmaf(v, __ldg(w.wr + k * 3 + 2), s2);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float* o = rgb + (size_t)(row0 + r) * 3;
      o[0] = s0 + __ldg(w.br + 0);
      o[1] = s1 + __ldg(w.br + 1);
      o[2] = s2 + __ldg(w.br + 2);
    }
  }
  __syncthreads();  // the next chunk overwrites xs and act
}

// The integrator's per-sample terms for sample s (< S) of a ray with
// t-values tr and direction norm dnorm.
struct SampleAlpha {
  float ts = 0.f, dist = 0.f, expterm = 1.f, alpha = 0.f, logv = 0.f;
};

__device__ __forceinline__ SampleAlpha sample_alpha(const float* __restrict__ tr, int s, int S,
                                                    float dnorm, float raw_sigma) {
  SampleAlpha a;
  a.ts = __ldg(tr + s);
  const float dist = (s + 1 < S) ? (__ldg(tr + s + 1) - a.ts) : 1e10f;
  a.dist = dist * dnorm;
  const float sigma = fmaxf(raw_sigma, 0.f);
  a.expterm = expf(-sigma * a.dist);
  a.alpha = 1.f - a.expterm;
  a.logv = logf(fmaxf(1.f - a.alpha + 1e-10f, 1e-10f));
  return a;
}

// Transmittance of each lane's sample in a 32-sample step: exp(carry + the
// exclusive warp prefix sum of logv). Advances carry by the step's total.
// Every lane of the warp must call it.
__device__ __forceinline__ float warp_transmittance(float logv, float& carry) {
  const int lane = threadIdx.x & 31;
  float inc = logv;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  float excl = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) excl = 0.f;
  const float trans = expf(carry + excl);
  carry += __shfl_sync(kFull, inc, 31);
  return trans;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// The integrator forward of the block's rays [ray0, ray0 + ray_tile), one
// warp per ray, from the raw sigma sig[g S + s] and raw rgb rgb[3 (g S + s)]
// of the ray's samples: weights (R,S), then comp (R,3), acc and depth (R).
__device__ __forceinline__ void integrate_rays(const float* __restrict__ t, const float* __restrict__ rays_d,
                                               const float* sig, const float* rgb, int ray0, int ray_tile,
                                               int S, int white_bkgd, float* __restrict__ comp,
                                               float* __restrict__ acc_out, float* __restrict__ depth,
                                               float* __restrict__ weights_out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < ray_tile; g += kWarps) {
    const int ray = ray0 + g;
    const float* tr = t + (size_t)ray * S;
    const float dx = __ldg(rays_d + ray * 3), dy = __ldg(rays_d + ray * 3 + 1),
                dz = __ldg(rays_d + ray * 3 + 2);
    const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
    float carry = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, acc_w = 0.f, dep = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      SampleAlpha a;
      if (s < S) a = sample_alpha(tr, s, S, dnorm, sig[g * S + s]);
      const float wgt = a.alpha * warp_transmittance(a.logv, carry);
      if (s < S) {
        weights_out[(size_t)ray * S + s] = wgt;
        const float* raw = rgb + (size_t)(g * S + s) * 3;
        c0 = fmaf(wgt, sigmoid(raw[0]), c0);
        c1 = fmaf(wgt, sigmoid(raw[1]), c1);
        c2 = fmaf(wgt, sigmoid(raw[2]), c2);
        acc_w += wgt;
        dep = fmaf(wgt, a.ts, dep);
      }
    }
    c0 = warp_sum(c0);
    c1 = warp_sum(c1);
    c2 = warp_sum(c2);
    acc_w = warp_sum(acc_w);
    dep = warp_sum(dep);
    if (lane == 0) {
      const float bg = white_bkgd ? 1.f - acc_w : 0.f;
      comp[ray * 3 + 0] = c0 + bg;
      comp[ray * 3 + 1] = c1 + bg;
      comp[ray * 3 + 2] = c2 + bg;
      acc_out[ray] = acc_w;
      depth[ray] = dep;
    }
  }
}

// Shared memory (bytes) of the forward walk for ray_tile rays of S samples:
// activation, encoded input, weight slices, per-ray view terms, per-sample
// raw sigma and rgb.
inline size_t forward_smem_bytes(int S, int ray_tile) {
  return sizeof(float) * ((size_t)kRows * kWidth + (size_t)kRows * kPosPad +
                          2 * (size_t)kSlice * kWidth + (size_t)ray_tile * kCondWidth +
                          4 * (size_t)ray_tile * S);
}

}  // namespace aonerf
