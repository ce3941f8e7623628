// Weight gradient of the fused NeRF level for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel aonerf/ops/kernels/fused_train.py::_bwd_kernel
// (launched by _fused_level_bwd_impl). Given the level's inputs and the
// cotangents of its four outputs (comp, acc, depth, weights), it returns the
// gradients of the 26 weights of fused_render.cu's level; the inputs get none
// (coarse t-values are parameter-free, fine t-values are detached).
//
// What bounds it: arithmetic. Per sample, the forward (589,952 multiply-adds),
// the weight products h^T . delta (589,952) and the input products
// delta . W^T (557,696; none for w0 and w5i) make 1.74 M multiply-adds, i.e.
// 3.48 MFLOP: >= 20.5 ms for 2048 rays x 193 samples at the H100's
// 67 TFLOP/s fp32 peak outside the tensor cores.
//
// Three kernels, in order on one stream:
//  1. level_bwd_forward_kernel: K1's forward walk (nerf_level.cuh) over the
//     block's rays, saving every chunk's activations (h0..h7, bottleneck,
//     view hidden: kSpill = 2432 floats a sample) to a per-row scratch in
//     device memory. A 64-row chunk's eight trunk activations are 512 KB, more
//     than a block's 227 KB of shared memory, where the TPU kept a whole tile
//     in VMEM; and the integrator backward needs every sample of a ray before
//     the first chunk's MLP backward can start. Spilling once costs 9.7 KB a
//     sample of writes and the same of reads (~7.7 GB at 2048 x 193, ~2.3 ms
//     at 3.35 TB/s), less than recomputing the forward a second time
//     (~1/3 more arithmetic). Then one warp per ray runs the integrator
//     forward and backward: g_w from the cotangents, and
//     g_alpha = g_w T - suffix(g_w w) / max(1 - alpha + 1e-10, 1e-10) with
//     the suffix sum taken right to left by a warp scan (a direct sum, never
//     a difference of prefix sums, which would cancel where v is tiny). It
//     writes g_raw_sigma and g_raw_rgb per sample.
//  2. level_bwd_weights_kernel: per 64-row chunk, reads the saved activations
//     back into shared memory and runs the head, view and trunk backward
//     (ReLU masks from the saved activations, the skip layer split into w5x
//     and w5i). delta . W^T uses gemm_acc with the transposed weights
//     streamed like the forward's. h^T . delta is computed by each thread
//     for an 8x8 (or 8x4) tile of dW over the chunk's 64 rows and added to
//     the block's own partial set.
//  3. reduce_partials_kernel: sums the blocks' partial sets in block order.
//
// The accumulation across blocks. The TPU kernel adds each grid step's dW in
// place, which relies on the grid running in order. Here blocks run
// concurrently, so each block owns an fp32 partial set of every gradient
// (kPartialFloats floats, 2.38 MB; 305 MB for 128 blocks) that only it
// writes, and a second kernel reduces them in a fixed order. The result is
// deterministic: the same inputs give the same bits on every run. The cost is
// the partial set's read-modify-write once per chunk (~4.8 MB a chunk), the
// largest byte stream of the backward; atomics into fewer copies that fit in
// L2 are the later alternative.
//
// fp32 FMA on the CUDA cores throughout, no tensor cores.

#include "nerf_level.cuh"

namespace {

using namespace aonerf;

enum Grad {
  G_W0, G_B0, G_W1, G_B1, G_W2, G_B2, G_W3, G_B3, G_W4, G_B4,
  G_W5X, G_W5I, G_B5, G_W6, G_B6, G_W7, G_B7,
  G_WD, G_BD, G_WB, G_BB, G_WVA, G_WVB, G_BV, G_WR, G_BR, kNumGrads
};
constexpr int kGradSize[kNumGrads] = {
    kPos * kWidth, kWidth, kWidth * kWidth, kWidth, kWidth * kWidth, kWidth,
    kWidth * kWidth, kWidth, kWidth * kWidth, kWidth,
    kWidth * kWidth, kPos * kWidth, kWidth, kWidth * kWidth, kWidth, kWidth * kWidth, kWidth,
    kWidth, 1, kWidth * kWidth, kWidth, kWidth * kCondWidth, kView * kCondWidth, kCondWidth,
    kCondWidth * 3, 3};
constexpr int pad4(int n) { return (n + 3) / 4 * 4; }
// Offset of gradient G in a partial set; each gradient starts 16-byte aligned.
template <int G>
struct Off {
  static constexpr int value = Off<G - 1>::value + pad4(kGradSize[G - 1]);
};
template <>
struct Off<0> {
  static constexpr int value = 0;
};
constexpr int kPartialFloats = Off<kNumGrads>::value;

// Transposed (out, in) copies of the weights whose input gradient is needed.
struct WeightsT {
  const float *w1, *w2, *w3, *w4, *w5x, *w6, *w7, *wb, *wva;
};

__global__ void __launch_bounds__(kThreads, 1)
level_bwd_forward_kernel(const float* __restrict__ t, const float* __restrict__ rays_d,
                         const float* __restrict__ venc, const float* __restrict__ xenc, Weights w,
                         const float* __restrict__ g_comp, const float* __restrict__ g_acc,
                         const float* __restrict__ g_depth, const float* __restrict__ g_weights,
                         float* __restrict__ saved, float* __restrict__ grow, int S, int ray_tile,
                         int white_bkgd) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                          // kRows x kWidth
  float* xs = act + kRows * kWidth;           // kRows x kPosPad
  float* wbuf = xs + kRows * kPosPad;         // 2 x kSlice x kWidth
  float* cterm = wbuf + 2 * kSlice * kWidth;  // ray_tile x kCondWidth
  float* sig = cterm + ray_tile * kCondWidth; // ray_tile*S raw sigma
  float* rgb = sig + ray_tile * S;            // ray_tile*S x 3 raw rgb, then (T, g_w, g_w w)

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;

  view_terms(venc, w.wvb, cterm, ray0, ray_tile);
  for (int row0 = 0; row0 < n_rows; row0 += kRows)
    forward_chunk<true>(xenc, w, act, xs, wbuf, cterm, sig, rgb, row_base, row0, n_rows, S,
                        saved + (row_base + row0) * kSpill);

  // Integrator forward and backward, one warp per ray.
  for (int g = warp; g < ray_tile; g += kWarps) {
    const int ray = ray0 + g;
    const float* tr = t + (size_t)ray * S;
    const float dx = __ldg(rays_d + ray * 3), dy = __ldg(rays_d + ray * 3 + 1),
                dz = __ldg(rays_d + ray * 3 + 2);
    const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
    const float gc0 = __ldg(g_comp + ray * 3), gc1 = __ldg(g_comp + ray * 3 + 1),
                gc2 = __ldg(g_comp + ray * 3 + 2);
    const float ga = __ldg(g_acc + ray), gd = __ldg(g_depth + ray);
    float* gr = grow + ((size_t)ray * S) * 4;

    // Left to right: weights, then g_w = dL/dw and g_raw_rgb per sample.
    float carry = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      SampleAlpha a;
      if (s < S) a = sample_alpha(tr, s, S, dnorm, sig[g * S + s]);
      const float trans = warp_transmittance(a.logv, carry);
      if (s < S) {
        const float wgt = a.alpha * trans;
        float* raw = rgb + (size_t)(g * S + s) * 3;
        const float r0 = sigmoid(raw[0]), r1 = sigmoid(raw[1]), r2 = sigmoid(raw[2]);
        float gw = gc0 * r0 + gc1 * r1 + gc2 * r2;
        if (white_bkgd) gw -= gc0 + gc1 + gc2;
        gw += ga + gd * a.ts + __ldg(g_weights + (size_t)ray * S + s);
        gr[s * 4 + 1] = gc0 * wgt * (r0 * (1.f - r0));
        gr[s * 4 + 2] = gc1 * wgt * (r1 * (1.f - r1));
        gr[s * 4 + 3] = gc2 * wgt * (r2 * (1.f - r2));
        raw[0] = trans;
        raw[1] = gw;
        raw[2] = gw * wgt;
      }
    }
    // Right to left: suffix_i = sum_{j > i} g_w_j w_j, then g_raw_sigma.
    float later = 0.f;  // sum over the 32-sample steps already passed
    for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
      const int s = s0 + lane;
      const float* st = rgb + (size_t)(g * S + s) * 3;
      const float gww = s < S ? st[2] : 0.f;
      float x = __shfl_down_sync(kFull, gww, 1);  // the next lane's term
      if (lane == 31) x = 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_down_sync(kFull, x, o);
        if (lane + o < 32) x += y;
      }
      const float suffix = later + x;
      later += warp_sum(gww);
      if (s < S) {
        const float raw_sigma = sig[g * S + s];
        const SampleAlpha a = sample_alpha(tr, s, S, dnorm, raw_sigma);
        const float v = fmaxf(1.f - a.alpha + 1e-10f, 1e-10f);
        const float g_alpha = st[1] * st[0] - suffix / v;
        gr[s * 4] = raw_sigma > 0.f ? g_alpha * a.expterm * a.dist : 0.f;
      }
    }
  }
}

// H[r][c] = rows[r * kSpill + c] for c < N and r < valid_rows, else 0.
template <int N>
__device__ __forceinline__ void load_rows(float* H, const float* __restrict__ rows, int valid_rows) {
  constexpr int kVec = N / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid_rows) v = *reinterpret_cast<const float4*>(rows + (size_t)r * kSpill + c);
    *reinterpret_cast<float4*>(H + r * kWidth + c) = v;
  }
}

// The chunk's encoded inputs as (kRows x kPosPad), pad rows and column zero.
__device__ __forceinline__ void load_xenc(float* H, const float* __restrict__ xg, int valid_rows) {
  for (int i = threadIdx.x; i < kRows * kPosPad; i += kThreads) {
    const int r = i / kPosPad, c = i % kPosPad;
    H[i] = (r < valid_rows && c < kPos) ? __ldg(xg + r * kPos + c) : 0.f;
  }
}

__device__ __forceinline__ void add_to(float* p, float v, bool first) { *p = first ? v : *p + v; }

// P[k][n] (+)= sum over the chunk's rows r of H[r][k] * D[r][n], k < K,
// n < N (P row-major (K, N)). Each warp owns 8 rows of P per 64-row pass,
// each lane 4 (N = 128) or 8 (N = 256) columns. Reads shared memory only.
template <int N>
__device__ __forceinline__ void dw_product(const float* H, int ldh, int K, const float* D,
                                           float* __restrict__ P, bool first) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += kWarps * 8) {
    const int kb = k0 + warp * 8;
    if (kb >= K) continue;  // warp-uniform
    float acc[8][N / 32];
    zero<N>(acc);
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(H + r * ldh + kb);
      const float4 a1 = *reinterpret_cast<const float4*>(H + r * ldh + kb + 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float4 b0 = *reinterpret_cast<const float4*>(D + r * kWidth + lane * 4);
      float4 b1 = b0;
      if constexpr (N == 256) b1 = *reinterpret_cast<const float4*>(D + r * kWidth + 128 + lane * 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i][0] = fmaf(a[i], b0.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b0.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b0.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b0.w, acc[i][3]);
        if constexpr (N == 256) {
          acc[i][4] = fmaf(a[i], b1.x, acc[i][4]);
          acc[i][5] = fmaf(a[i], b1.y, acc[i][5]);
          acc[i][6] = fmaf(a[i], b1.z, acc[i][6]);
          acc[i][7] = fmaf(a[i], b1.w, acc[i][7]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int k = kb + i;
      if (k >= K) continue;
#pragma unroll
      for (int h = 0; h < N / 128; ++h) {
        float4* p = reinterpret_cast<float4*>(P + (size_t)k * N + h * 128 + lane * 4);
        float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
        if (!first) {
          const float4 o = *p;
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        *p = v;
      }
    }
  }
}

// Bias gradient: P[c] (+)= sum over the chunk's rows of D[r][c], c < N.
template <int N>
__device__ __forceinline__ void col_sums(const float* D, float* __restrict__ P, bool first) {
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) s += D[r * kWidth + c];
    add_to(P + c, s, first);
  }
}

// D[r][c] = (acc + gs[r] vec[c]) * (M[r][c] > 0) for this thread's gemm_acc
// tile; the rank-1 term and the mask are optional. Ends with a barrier.
__device__ __forceinline__ void store_delta(const float (&acc)[8][8], float* D, const float* M,
                                            const float* gs, const float* __restrict__ vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float vv[8] = {};
  if (vec != nullptr) {
#pragma unroll
    for (int j = 0; j < 8; ++j) vv[j] = __ldg(vec + lane * 4 + (j % 4) + 128 * (j / 4));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp * 8 + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = h * 4 + q, c = h * 128 + lane * 4 + q;
        float x = acc[i][j];
        if (vec != nullptr) x = fmaf(gs[r], vv[j], x);
        if (M != nullptr && !(M[r * kWidth + c] > 0.f)) x = 0.f;
        v[q] = x;
      }
      *reinterpret_cast<float4*>(D + r * kWidth + h * 128 + lane * 4) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
}

// One trunk layer i backward, delta_i in D: db_i, then H <- h_{i-1} (saved
// rows `prev`), dW_i = h_{i-1}^T delta_i, and
// delta_{i-1} = (delta_i . W_i^T) * (h_{i-1} > 0) into D.
__device__ __forceinline__ void trunk_step(float* D, float* H, float* wbuf, const float* prev,
                                           int valid_rows, const float* WT, float* Pw, float* Pb,
                                           bool first) {
  col_sums<kWidth>(D, Pb, first);
  load_rows<kWidth>(H, prev, valid_rows);
  __syncthreads();
  dw_product<kWidth>(H, kWidth, kWidth, D, Pw, first);
  float acc[8][8];
  zero<256>(acc);
  gemm_acc<256>(acc, D, kWidth, kWidth, WT, wbuf);
  store_delta(acc, D, H, nullptr, nullptr);
}

__global__ void __launch_bounds__(kThreads, 1)
level_bwd_weights_kernel(const float* __restrict__ venc, const float* __restrict__ xenc, Weights w,
                         WeightsT wt, const float* __restrict__ saved, const float* __restrict__ grow,
                         float* __restrict__ partials, int S, int ray_tile) {
  extern __shared__ __align__(16) float smem[];
  float* D = smem;                        // kRows x kWidth: the current delta
  float* H = D + kRows * kWidth;          // kRows x kWidth: a saved activation
  float* wbuf = H + kRows * kWidth;       // 2 x kSlice x kWidth
  float* gc = wbuf + 2 * kSlice * kWidth; // ray_tile x kCondWidth: per-ray sum of delta_v
  float* gs = gc + ray_tile * kCondWidth; // kRows: g_raw_sigma
  float* grgb = gs + kRows;               // kRows x 3: g_raw_rgb

  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;
  float* P = partials + (size_t)blockIdx.x * kPartialFloats;
  const int tid = threadIdx.x;

  for (int i = tid; i < ray_tile * kCondWidth; i += kThreads) gc[i] = 0.f;

  for (int row0 = 0; row0 < n_rows; row0 += kRows) {
    const bool first = row0 == 0;
    const int valid_rows = min(kRows, n_rows - row0);
    const float* sv = saved + (row_base + row0) * kSpill;
    const float* gr = grow + (row_base + row0) * 4;
    for (int i = tid; i < kRows * 4; i += kThreads) {
      const int r = i / 4, c = i % 4;
      const float v = r < valid_rows ? gr[i] : 0.f;
      if (c == 0) gs[r] = v; else grgb[r * 3 + c - 1] = v;
    }
    load_rows<kCondWidth>(H, sv + kSpillView, valid_rows);  // hv
    __syncthreads();

    // rgb head: dWr = hv^T g_raw_rgb, dbr.
    if (tid < kCondWidth) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < kRows; ++r) {
        const float h = H[r * kWidth + tid];
        s0 = fmaf(h, grgb[r * 3], s0);
        s1 = fmaf(h, grgb[r * 3 + 1], s1);
        s2 = fmaf(h, grgb[r * 3 + 2], s2);
      }
      float* p = P + Off<G_WR>::value + tid * 3;
      add_to(p, s0, first);
      add_to(p + 1, s1, first);
      add_to(p + 2, s2, first);
    } else if (tid < kCondWidth + 3) {
      const int j = tid - kCondWidth;
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += grgb[r * 3 + j];
      add_to(P + Off<G_BR>::value + j, s, first);
    }
    // delta_v = (g_raw_rgb . wr^T) * (hv > 0) -> D[:, :128]
    for (int i = tid; i < kRows * kCondWidth; i += kThreads) {
      const int r = i / kCondWidth, c = i % kCondWidth;
      const float g = grgb[r * 3] * __ldg(w.wr + c * 3) + grgb[r * 3 + 1] * __ldg(w.wr + c * 3 + 1) +
                      grgb[r * 3 + 2] * __ldg(w.wr + c * 3 + 2);
      D[r * kWidth + c] = H[r * kWidth + c] > 0.f ? g : 0.f;
    }
    __syncthreads();
    // dbv, and the per-ray sum of delta_v for wvb (one thread per column,
    // rows in order: deterministic).
    if (tid < kCondWidth) {
      float s = 0.f;
      for (int r = 0; r < valid_rows; ++r) {
        const float d = D[r * kWidth + tid];
        s += d;
        gc[((row0 + r) / S) * kCondWidth + tid] += d;
      }
      add_to(P + Off<G_BV>::value + tid, s, first);
    }
    load_rows<kWidth>(H, sv + kSpillBtl, valid_rows);  // bottleneck
    __syncthreads();
    dw_product<kCondWidth>(H, kWidth, kWidth, D, P + Off<G_WVA>::value, first);
    {  // g_btl = delta_v . wva^T -> D
      float acc[8][8];
      zero<256>(acc);
      gemm_acc<256>(acc, D, kWidth, kCondWidth, wt.wva, wbuf);
      store_delta(acc, D, nullptr, nullptr, nullptr);
    }
    // bottleneck and density heads: dWb = h7^T g_btl, dWd = h7^T g_raw_sigma.
    col_sums<kWidth>(D, P + Off<G_BB>::value, first);
    load_rows<kWidth>(H, sv + 7 * kWidth, valid_rows);  // h7
    __syncthreads();
    dw_product<kWidth>(H, kWidth, kWidth, D, P + Off<G_WB>::value, first);
    {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(H[r * kWidth + tid], gs[r], s);
      add_to(P + Off<G_WD>::value + tid, s, first);
      if (tid == 0) {
        float b = 0.f;
        for (int r = 0; r < kRows; ++r) b += gs[r];
        add_to(P + Off<G_BD>::value, b, first);
      }
    }
    {  // delta_7 = (g_btl . wb^T + g_raw_sigma wd^T) * (h7 > 0) -> D
      float acc[8][8];
      zero<256>(acc);
      gemm_acc<256>(acc, D, kWidth, kWidth, wt.wb, wbuf);
      store_delta(acc, D, H, gs, w.wd);
    }
    trunk_step(D, H, wbuf, sv + 6 * kWidth, valid_rows, wt.w7, P + Off<G_W7>::value, P + Off<G_B7>::value, first);
    trunk_step(D, H, wbuf, sv + 5 * kWidth, valid_rows, wt.w6, P + Off<G_W6>::value, P + Off<G_B6>::value, first);
    // skip layer 5: dW5i = x_enc^T delta_5, dW5x = h4^T delta_5.
    col_sums<kWidth>(D, P + Off<G_B5>::value, first);
    load_xenc(H, xenc + (row_base + row0) * kPos, valid_rows);
    __syncthreads();
    dw_product<kWidth>(H, kPosPad, kPos, D, P + Off<G_W5I>::value, first);
    __syncthreads();
    load_rows<kWidth>(H, sv + 4 * kWidth, valid_rows);  // h4
    __syncthreads();
    dw_product<kWidth>(H, kWidth, kWidth, D, P + Off<G_W5X>::value, first);
    {
      float acc[8][8];
      zero<256>(acc);
      gemm_acc<256>(acc, D, kWidth, kWidth, wt.w5x, wbuf);
      store_delta(acc, D, H, nullptr, nullptr);
    }
    trunk_step(D, H, wbuf, sv + 3 * kWidth, valid_rows, wt.w4, P + Off<G_W4>::value, P + Off<G_B4>::value, first);
    trunk_step(D, H, wbuf, sv + 2 * kWidth, valid_rows, wt.w3, P + Off<G_W3>::value, P + Off<G_B3>::value, first);
    trunk_step(D, H, wbuf, sv + 1 * kWidth, valid_rows, wt.w2, P + Off<G_W2>::value, P + Off<G_B2>::value, first);
    trunk_step(D, H, wbuf, sv, valid_rows, wt.w1, P + Off<G_W1>::value, P + Off<G_B1>::value, first);
    // layer 0: dW0 = x_enc^T delta_0.
    col_sums<kWidth>(D, P + Off<G_B0>::value, first);
    load_xenc(H, xenc + (row_base + row0) * kPos, valid_rows);
    __syncthreads();
    dw_product<kWidth>(H, kPosPad, kPos, D, P + Off<G_W0>::value, first);
    __syncthreads();  // the next chunk overwrites gs, grgb, H and D
  }

  // dWvb = venc^T (per-ray sum of delta_v), once per block.
  for (int i = tid; i < kView * kCondWidth; i += kThreads) {
    const int k = i / kCondWidth, n = i % kCondWidth;
    float s = 0.f;
    for (int g = 0; g < ray_tile; ++g)
      s = fmaf(__ldg(venc + (size_t)(ray0 + g) * kView + k), gc[g * kCondWidth + n], s);
    P[Off<G_WVB>::value + i] = s;
  }
}

// out[i] = sum over blocks b, in order, of partials[b][i].
__global__ void reduce_partials_kernel(const float* __restrict__ partials, int n_blocks,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kPartialFloats) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += partials[(size_t)b * kPartialFloats + i];
  out[i] = s;
}

size_t weights_smem_bytes(int ray_tile) {
  return sizeof(float) * (3 * (size_t)kRows * kWidth + (size_t)ray_tile * kCondWidth + 4 * (size_t)kRows);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

}  // namespace

extern "C" {

// Floats in one block's partial set (and in the reduced output): the 26
// gradients in the order of the arguments below, each padded to 4 floats.
int aonerf_fused_level_bwd_partial_floats() { return kPartialFloats; }

// Saved-activation floats per sample of the scratch `saved`.
int aonerf_fused_level_bwd_saved_floats() { return kSpill; }

// Launches the level's weight gradient on `stream`. Pointers are device
// pointers to contiguous fp32 arrays: the level's inputs, its 26 weights in
// the flax (in, out) layout, the transposes (out, in) of w1..w4, w5x, w6,
// w7, wb and wva, the cotangents g_comp (R,3), g_acc (R), g_depth (R),
// g_weights (R,S); scratch `saved` (R*S*kSpill), `grow` (R*S*4) and
// `partials` ((R/ray_tile) * kPartialFloats); the output `out`
// (kPartialFloats). n_rays % ray_tile == 0. Returns the first launch error
// (0 on success).
int aonerf_fused_level_bwd(const float* t, const float* rays_d, const float* venc, const float* xenc,
                           const float* w0, const float* b0, const float* w1, const float* b1,
                           const float* w2, const float* b2, const float* w3, const float* b3,
                           const float* w4, const float* b4, const float* w5x, const float* w5i,
                           const float* b5, const float* w6, const float* b6, const float* w7,
                           const float* b7, const float* wd, const float* bd, const float* wb,
                           const float* bb, const float* wva, const float* wvb, const float* bv,
                           const float* wr, const float* br, const float* w1t, const float* w2t,
                           const float* w3t, const float* w4t, const float* w5xt, const float* w6t,
                           const float* w7t, const float* wbt, const float* wvat,
                           const float* g_comp, const float* g_acc, const float* g_depth,
                           const float* g_weights, float* saved, float* grow, float* partials,
                           float* out, int n_rays, int S, int ray_tile, int white_bkgd, void* stream) {
  if (n_rays <= 0 || S <= 0 || ray_tile <= 0 || n_rays % ray_tile != 0) return cudaErrorInvalidValue;
  const size_t smem_a = forward_smem_bytes(S, ray_tile), smem_b = weights_smem_bytes(ray_tile);
  cudaError_t err = set_smem((const void*)level_bwd_forward_kernel, smem_a);
  if (err != cudaSuccess) return err;
  err = set_smem((const void*)level_bwd_weights_kernel, smem_b);
  if (err != cudaSuccess) return err;
  Weights w{w0, b0, w1, b1, w2, b2, w3, b3, w4, b4, w5x, w5i, b5, w6, b6, w7, b7,
            wd, bd, wb, bb, wva, wvb, bv, wr, br};
  WeightsT wt{w1t, w2t, w3t, w4t, w5xt, w6t, w7t, wbt, wvat};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = n_rays / ray_tile;
  level_bwd_forward_kernel<<<n_blocks, kThreads, smem_a, s>>>(
      t, rays_d, venc, xenc, w, g_comp, g_acc, g_depth, g_weights, saved, grow, S, ray_tile, white_bkgd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  level_bwd_weights_kernel<<<n_blocks, kThreads, smem_b, s>>>(venc, xenc, w, wt, saved, grow, partials, S,
                                                              ray_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_partials_kernel<<<(kPartialFloats + kThreads - 1) / kThreads, kThreads, 0, s>>>(partials, n_blocks, out);
  return cudaGetLastError();
}

}  // extern "C"
