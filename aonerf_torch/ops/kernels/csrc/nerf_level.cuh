// Device code shared by the fused NeRF level (fused_render.cu, K1, the
// forward) and its training side (fused_train.cu: K1s, the forward that saves
// the activations, and K2, the weight gradient), for Hopper (sm_90a).
//
// The forward walk (K1 and K1s) takes a block's rays in chunks of kRows
// samples packed across ray boundaries and runs the 8x256 MLP on a chunk with
// its activation in shared memory. Every 256- and 128-wide product runs on
// the tensor cores in 3xTF32 (mma.sync m16n8k8, fp32 accuracy) through
// gemm_wt, the product K2's B1 also runs: A from the shared tile, the weight
// transposed (out x in) in device memory and streamed in 32-column K-slices
// through a cp.async double buffer. The 1- and 3-wide heads and the per-ray
// view term stay on fp32 FMA. Each ray is then integrated by one warp (a
// prefix sum of log(max(1 - alpha + 1e-10, 1e-10)) with a carry across
// 32-sample steps). The training forward also saves each chunk's activations
// to a per-row scratch (`Spill`, kSpill floats per sample) by bulk copies out
// of the shared activation tile.

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
constexpr int kSlice = 32;       // K (reduction) columns per staged weight slice
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Saved activations per sample: h0..h7, the bottleneck, the view hidden layer.
constexpr int kSpillBtl = 8 * kWidth;
constexpr int kSpillView = kSpillBtl + kWidth;
constexpr int kSpill = kSpillView + kCondWidth;
// Row strides in shared memory, all 4 mod 32 so that the mma fragments' loads
// (8 rows x 4 columns a warp) hit 32 different banks: a 256-wide activation
// tile, the encoded-input tile (K padded to 64), a staged weight slice.
constexpr int kAct = kWidth + 4;
constexpr int kXs = kPosPad + 4;
constexpr int kWs = kSlice + 4;
// k8 steps (3 mma each) that one fresh accumulator sums in the forward's
// products (B1 keeps 4, 12 mma). The tensor cores truncate as they add into
// the accumulator, so a longer run loses more, and the forward's error
// compounds over eight layers: at the train step's shapes on the H100
// (tools/torch_fwd_accuracy.py), the saved activations' rms error against
// fp64 is 1.6-2.3x the fp32 plain version's with 4 steps, 0.91-1.15x with
// 2, 0.67-0.78x with 1; K1s takes 10.9 / 11.5 / 12.3 ms at S = 193
// (tools/torch_train_compare.py, in turns). 2 is the longest run, and so
// the fastest, that is as accurate as fp32.
constexpr int kFwdRun = 2;

// The 26 weights in the flax (in, out) layout, biases (1, out).
struct Weights {
  const float *w0, *b0, *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
  const float *w5x, *w5i, *b5, *w6, *b6, *w7, *b7;
  const float *wd, *bd, *wb, *bb, *wva, *wvb, *bv, *wr, *br;
};

// The forward's copy of its 11 tensor-core product weights: each transposed
// (out x in, row-major), K = in padded to a multiple of kSlice (w0 and w5i:
// 256 x 64, column 63 zero), packed in this order into one buffer of
// kWtFloats that the wrapper rebuilds every launch from the flax weights.
struct WeightsT {
  const float *w0, *w1, *w2, *w3, *w4, *w5x, *w5i, *w6, *w7, *wb, *wva;
};
constexpr int kWtTrunk = kWidth * kWidth, kWtIn = kWidth * kPosPad;
constexpr int kWtFloats = 2 * kWtIn + 8 * kWtTrunk + kCondWidth * kWidth;

inline WeightsT unpack_weights_t(const float* wt) {
  WeightsT w;
  const float** dst[] = {&w.w0, &w.w1, &w.w2, &w.w3, &w.w4, &w.w5x, &w.w5i, &w.w6, &w.w7, &w.wb, &w.wva};
  const int size[] = {kWtIn, kWtTrunk, kWtTrunk, kWtTrunk, kWtTrunk, kWtTrunk, kWtIn, kWtTrunk, kWtTrunk,
                      kWtTrunk, kCondWidth * kWidth};
  for (int i = 0; i < 11; ++i) {
    *dst[i] = wt;
    wt += size[i];
  }
  return w;
}

// The forward walk's shared memory for ray_tile rays of S samples: the
// chunk's activation (kRows x kAct) and encoded input (kRows x kXs), the
// weight-slice double buffer (2 x kWidth x kWs), per-ray view terms, and
// per-sample raw sigma and rgb. 215,296 bytes at ray_tile 16, S = 193.
struct ForwardSmem {
  float *act, *xs, *wbuf, *cterm, *sig, *rgb;
};

__device__ __forceinline__ ForwardSmem carve_forward_smem(float* smem, int S, int ray_tile) {
  ForwardSmem m;
  m.act = smem;
  m.xs = m.act + kRows * kAct;
  m.wbuf = m.xs + kRows * kXs;
  m.cterm = m.wbuf + 2 * kWidth * kWs;
  m.sig = m.cterm + ray_tile * kCondWidth;
  m.rgb = m.sig + ray_tile * S;
  return m;
}

inline size_t forward_smem_bytes(int S, int ray_tile) {
  return sizeof(float) * ((size_t)kRows * kAct + (size_t)kRows * kXs + 2 * (size_t)kWidth * kWs +
                          (size_t)ray_tile * kCondWidth + 4 * (size_t)ray_tile * S);
}

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

// ------------------------------------------------------------ 3xTF32 mma.sync

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away from
// zero: half a TF32 ulp added to the magnitude, the 13 low bits cleared), on
// the integer pipe. Finite inputs only.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = big + small with both TF32; x - big is exact in fp32, and what small
// drops is at most 2^-22 |x|.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a . b for one m16n8k8 TF32 tile. Fragments (g = lane / 4, t = lane % 4):
// A (row, k) at a[0] (g, t), a[1] (g+8, t), a[2] (g, t+4), a[3] (g+8, t+4);
// B (k, col) at b0 (t, g), b1 (t+4, g); d (row, col) at d[0] (g, 2t),
// d[1] (g, 2t+1), d[2] (g+8, 2t), d[3] (g+8, 2t+1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32: d += a_small b_big + a_big b_small + a_big b_big, the small terms
// first (as CUTLASS orders them); a_small b_small (~2^-22 of the product) is
// dropped.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// The tensor cores add into their fp32 accumulator with truncation, so one
// accumulator's error grows with the number of mma into it, in one direction.
// Every product gives each short run of mma (3 Run in gemm_wt, 24 in K2's B2)
// a fresh accumulator and adds it into the running sum with fp32 adds.
template <int M, int N>
__device__ __forceinline__ void add_into(float (&acc)[M][N][4], const float (&part)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] += part[i][j][c];
}

template <int M, int N>
__device__ __forceinline__ void zero_acc(float (&acc)[M][N][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
}

// A chunk's kRows x N product: warp w owns rows 32 (w / 4) + [0, 32) and
// columns (N / 4) (w % 4) + [0, N / 4), as 2 x (N / 32) m16n8 tiles (N = 256:
// 32 x 64 a warp; N = 128: 32 x 32).
template <int N>
using ChunkAcc = float[2][N / 32][4];

// Stage columns [k0, k0 + kSlice) of W (N x K, row-major) into buf (N rows
// of stride kWs), as one committed cp.async group.
template <int N>
__device__ __forceinline__ void stage_wt(float* buf, const float* __restrict__ W, int K, int k0) {
  constexpr int kVec = kSlice / 4;
  for (int i = threadIdx.x; i < N * kVec; i += kThreads) {
    const int n = i / kVec, c = (i % kVec) * 4;
    cp_async16(buf + n * kWs + c, W + (size_t)n * K + k0 + c, true);
  }
  cp_async_commit();
}

// acc += A[:, :K] . W^T in 3xTF32, A (kRows x Lda) in shared memory, W (N x
// K, K % kSlice == 0) row-major in device memory: B(k, n) = W[n][k] is read
// as the "col" operand, through a cp.async double buffer of K-slices in wbuf
// (2 x kWidth x kWs). K2's B1 passes a weight in its flax (in, out) layout
// (so it multiplies by the transpose); the forward passes the transposed copy
// (out x in, WeightsT), so it multiplies by the weight. A fresh accumulator
// sums each Run k8 steps (3 Run mma) and is added into acc in fp32. Every
// cp.async group committed before the call has landed by the first barrier.
// Ends with a barrier: every thread has finished reading A and wbuf when it
// returns. With Spill, thread 0's bulk copies of the previous layer's
// activation have also finished reading it by then, so the caller may
// overwrite it.
template <int N, int Lda, bool Spill = false, int Run = kSlice / 8>
__device__ __forceinline__ void gemm_wt(ChunkAcc<N>& acc, const float* A, int K, const float* __restrict__ W,
                                        float* wbuf) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 32, c0 = (warp & 3) * (N / 4);
  const int n_slices = K / kSlice;
  stage_wt<N>(wbuf, W, K, 0);
  for (int s = 0; s < n_slices; ++s) {
    const float* ws = wbuf + (s & 1) * kWidth * kWs;
    if (s + 1 < n_slices) {
      stage_wt<N>(wbuf + ((s + 1) & 1) * kWidth * kWs, W, K, (s + 1) * kSlice);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int k0 = 0; k0 < kSlice; k0 += 8 * Run) {
      ChunkAcc<N> part;
      zero_acc(part);
#pragma unroll
      for (int kk = k0; kk < k0 + 8 * Run; kk += 8) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* p = A + (r0 + 16 * mi + g) * Lda + s * kSlice + kk + t;
          split_tf32(p[0], ab[mi][0], as[mi][0]);
          split_tf32(p[8 * Lda], ab[mi][1], as[mi][1]);
          split_tf32(p[4], ab[mi][2], as[mi][2]);
          split_tf32(p[8 * Lda + 4], ab[mi][3], as[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < N / 32; ++ni) {
          const float* q = ws + (c0 + 8 * ni + g) * kWs + kk + t;
          uint32_t bb[2], bs[2];
          split_tf32(q[0], bb[0], bs[0]);
          split_tf32(q[4], bb[1], bs[1]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_3xtf32(part[mi][ni], ab[mi], as[mi], bb, bs);
        }
      }
      add_into(acc, part);
    }
    if constexpr (Spill) {
      if (s + 1 == n_slices && threadIdx.x == 0) bulk_wait_read();
    }
    __syncthreads();
  }
}

// act[r][c] = (relu)(acc + bias[c] (+ cterm[ray(r)][c])) for this thread's
// fragment elements (stride kAct), in place over the product's input, then a
// barrier so the next layer reads the whole new activation. With Spill,
// thread 0 then copies the rows below valid_rows (N floats each) to
// spill + row * kSpill by bulk copies, one committed group; the next
// gemm_wt<..., true> waits for them to finish reading act.
template <int N, bool Spill>
__device__ __forceinline__ void store_act(const ChunkAcc<N>& acc, const float* __restrict__ bias, bool relu,
                                          float* act, const float* cterm, int row0, int S, int n_rows,
                                          float* spill, int valid_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp >> 2) * 32 + (lane >> 2), c0 = (warp & 3) * (N / 4) + 2 * (lane & 3);
  const float* ct[2][2] = {};  // the view term of each fragment row's ray
  if (cterm != nullptr) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int local = min(row0 + r0 + 16 * mi + 8 * h, n_rows - 1);  // padded rows reuse the last ray
        ct[mi][h] = cterm + (local / S) * kCondWidth;
      }
  }
#pragma unroll
  for (int ni = 0; ni < N / 32; ++ni) {
    const int c = c0 + 8 * ni;
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0 = acc[mi][ni][2 * h] + b0, x1 = acc[mi][ni][2 * h + 1] + b1;
        if (cterm != nullptr) {
          x0 += ct[mi][h][c];
          x1 += ct[mi][h][c + 1];
        }
        if (relu) {
          x0 = fmaxf(x0, 0.f);
          x1 = fmaxf(x1, 0.f);
        }
        *reinterpret_cast<float2*>(act + (r0 + 16 * mi + 8 * h) * kAct + c) = make_float2(x0, x1);
      }
  }
  if constexpr (Spill) fence_proxy_async();
  __syncthreads();
  if constexpr (Spill) {
    if (threadIdx.x == 0) {
      const uint64_t policy = evict_first_policy();
      for (int r = 0; r < valid_rows; ++r)
        bulk_store_row(spill + (size_t)r * kSpill, act + r * kAct, N * 4, policy);
      bulk_commit();
    }
  }
}

// One 256-wide layer with ReLU, act = relu(A[:, :K] . W + bias), in place
// (Wt = W transposed, 256 x K).
template <int Lda, bool Spill>
__device__ __forceinline__ void dense_relu(const float* A, int K, const float* Wt, const float* bias, float* act,
                                           float* wbuf, float* spill, int valid_rows) {
  ChunkAcc<kWidth> acc;
  zero_acc(acc);
  gemm_wt<kWidth, Lda, Spill, kFwdRun>(acc, A, K, Wt, wbuf);
  store_act<kWidth, Spill>(acc, bias, true, act, nullptr, 0, 1, 1, spill, valid_rows);
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
// packed samples: raw sigma to sig[row], raw rgb to rgb[3 row]. Biases and
// the narrow heads come from w, the product weights from wt. With Spill,
// each layer's activation of the valid rows also goes to the saved-activation
// rows at `spill` (already offset to the chunk's first row). Ends with a
// barrier.
template <bool Spill>
__device__ __forceinline__ void forward_chunk(const float* __restrict__ xenc, const Weights& w, const WeightsT& wt,
                                              const ForwardSmem& m, size_t row_base, int row0, int n_rows, int S,
                                              float* spill) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int valid_rows = min(kRows, n_rows - row0);
  float* act = m.act;
  // Encoded inputs of this chunk; padded rows and the pad column are 0.
  const float* xg = xenc + (row_base + row0) * kPos;
  for (int i = threadIdx.x; i < kRows * kPosPad; i += kThreads) {
    const int r = i / kPosPad, c = i % kPosPad;
    m.xs[r * kXs + c] = (r < valid_rows && c < kPos) ? __ldg(xg + r * kPos + c) : 0.f;
  }
  __syncthreads();

  dense_relu<kXs, Spill>(m.xs, kPosPad, wt.w0, w.b0, act, m.wbuf, spill, valid_rows);
  dense_relu<kAct, Spill>(act, kWidth, wt.w1, w.b1, act, m.wbuf, spill + kWidth, valid_rows);
  dense_relu<kAct, Spill>(act, kWidth, wt.w2, w.b2, act, m.wbuf, spill + 2 * kWidth, valid_rows);
  dense_relu<kAct, Spill>(act, kWidth, wt.w3, w.b3, act, m.wbuf, spill + 3 * kWidth, valid_rows);
  dense_relu<kAct, Spill>(act, kWidth, wt.w4, w.b4, act, m.wbuf, spill + 4 * kWidth, valid_rows);
  {  // skip layer: relu(h . w5x + x_enc . w5i + b5), one accumulator
    ChunkAcc<kWidth> a5;
    zero_acc(a5);
    gemm_wt<kWidth, kAct, false, kFwdRun>(a5, act, kWidth, wt.w5x, m.wbuf);
    gemm_wt<kWidth, kXs, Spill, kFwdRun>(a5, m.xs, kPosPad, wt.w5i, m.wbuf);
    store_act<kWidth, Spill>(a5, w.b5, true, act, nullptr, 0, 1, 1, spill + 5 * kWidth, valid_rows);
  }
  dense_relu<kAct, Spill>(act, kWidth, wt.w6, w.b6, act, m.wbuf, spill + 6 * kWidth, valid_rows);
  dense_relu<kAct, Spill>(act, kWidth, wt.w7, w.b7, act, m.wbuf, spill + 7 * kWidth, valid_rows);

  // Density head (256 -> 1), one warp per row.
  const float bd = __ldg(w.bd);
  for (int r = warp; r < valid_rows; r += kWarps) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(act[r * kAct + lane + 32 * i], __ldg(w.wd + lane + 32 * i), s);
    s = warp_sum(s);
    if (lane == 0) m.sig[row0 + r] = s + bd;
  }
  {  // bottleneck (no activation), in place; gemm_wt's first barrier orders
     // it after the density reads
    ChunkAcc<kWidth> ab;
    zero_acc(ab);
    gemm_wt<kWidth, kAct, Spill, kFwdRun>(ab, act, kWidth, wt.wb, m.wbuf);
    store_act<kWidth, Spill>(ab, w.bb, false, act, nullptr, 0, 1, 1, spill + kSpillBtl, valid_rows);
  }
  {  // view layer: relu(btl . wva + cterm[ray] + bv) -> act[:, :128]
    ChunkAcc<kCondWidth> av;
    zero_acc(av);
    gemm_wt<kCondWidth, kAct, Spill, kFwdRun>(av, act, kWidth, wt.wva, m.wbuf);
    store_act<kCondWidth, Spill>(av, w.bv, true, act, m.cterm, row0, S, n_rows, spill + kSpillView, valid_rows);
  }
  // rgb head (128 -> 3), one warp per row.
  for (int r = warp; r < valid_rows; r += kWarps) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lane + 32 * i;
      const float v = act[r * kAct + k];
      s0 = fmaf(v, __ldg(w.wr + k * 3 + 0), s0);
      s1 = fmaf(v, __ldg(w.wr + k * 3 + 1), s1);
      s2 = fmaf(v, __ldg(w.wr + k * 3 + 2), s2);
    }
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      float* o = m.rgb + (size_t)(row0 + r) * 3;
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

}  // namespace aonerf
