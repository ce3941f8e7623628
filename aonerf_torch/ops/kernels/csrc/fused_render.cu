// Fused NeRF level for Hopper (sm_90a): 8x256 MLP + heads + volume integrator.
//
// Replaces the Pallas TPU kernel aonerf/ops/kernels/fused_render.py::_kernel
// (launched by fused_render_level). For a group of whole rays it evaluates the
// NeRF MLP on every sample and composites the level, writing only
// comp (R,3), acc (R), depth (R) and weights (R,S) to device memory. No
// (rows, 256) activation ever leaves the SM.
//
// What bounds it: arithmetic. One sample costs ~0.59 M multiply-adds
// (63x256 + 4x256x256 + (256+63)x256 + 2x256x256 + 256x(1+256) + 256x128 +
// 128x3), i.e. ~1.18 MFLOP, against ~260 bytes of input (63 encoded floats
// + t). At the fine level (4096 rays x 193 samples) that is ~0.93 TFLOP, so
// >= 13.9 ms at the H100's 67 TFLOP/s fp32 (non-tensor-core) peak; the bytes
// (~0.2 GB) would take ~0.06 ms at 3.35 TB/s.
//
// What the design does about it:
//  * fp32 FMA on the CUDA cores, no tensor cores, no TF32 (the TPU kernel's
//    default dot_bf16=False path; bf16/wgmma come later).
//  * One block (256 threads) owns `ray_tile` whole rays and walks their
//    ray_tile*S samples in chunks of 64 rows, packed across ray boundaries so
//    only the last chunk is padded (S = 65 or 193 is not a multiple of 64).
//  * The chunk's activation (64 x 256 fp32 = 64 KB) stays in shared memory.
//    Each thread keeps an 8-row x 8-column output tile in registers, so a
//    layer is written back over its own input once every thread has finished
//    reading it: one activation buffer, no ping-pong.
//  * The weights (~2.4 MB for one MLP) do not fit in shared memory. Each layer
//    streams 32-row K-slices (32 KB) through a double buffer with cp.async
//    while the previous slice is multiplied; the whole set stays hot in L2.
//    Per slice a thread does 64 FMAs per 2 float4 weight loads and 8 float4
//    activation loads that the warp broadcasts.
//  * The skip layer is a split matmul, w5x . h + w5i . x_enc, into the same
//    accumulators; the encoded input chunk is kept beside the activation.
//  * The view-condition term venc . wvb is computed once per ray and added to
//    that ray's rows in the view layer's epilogue.
//  * The 1-wide density head and the 3-wide rgb head are warp dot products.
//    Per-sample raw sigma and rgb wait in shared memory until the block's
//    rays are done; then one warp per ray integrates: alpha, a warp prefix sum
//    of log(max(1 - alpha + 1e-10, 1e-10)) with a carry across 32-sample
//    steps (the TPU kernel's triangular matmul), weights, rgb, acc, depth.
//
// Shared memory: 64x256 activation + 64x64 encoded input + 2x32x256 weight
// slices + ray_tile x (128 + 4 S) per-ray values, 205 KB at ray_tile=16,
// S=193. One block per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// reading A and wbuf when it returns.
template <int N>
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
// barrier so the next layer reads the whole new activation.
template <int N>
__device__ __forceinline__ void store_act(const float (&acc)[8][N / 32], const float* __restrict__ bias,
                                          bool relu, float* act, const float* cterm, int row0,
                                          int S, int n_rows) {
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
      *reinterpret_cast<float4*>(act + r * kWidth + h * 128 + lane * 4) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
}

// One 256x256 (or K x 256) layer with ReLU, in place over act.
__device__ __forceinline__ void dense_relu(const float* A, int lda, int K, const float* W,
                                           const float* bias, float* act, float* wbuf) {
  float acc[8][8];
  zero<256>(acc);
  gemm_acc<256>(acc, A, lda, K, W, wbuf);
  store_act<256>(acc, bias, true, act, nullptr, 0, 1, 1);
}

__global__ void __launch_bounds__(kThreads, 1)
fused_render_level_kernel(const float* __restrict__ t, const float* __restrict__ rays_d,
                          const float* __restrict__ venc, const float* __restrict__ xenc,
                          Weights w, float* __restrict__ comp, float* __restrict__ acc_out,
                          float* __restrict__ depth, float* __restrict__ weights_out, int S,
                          int ray_tile, int white_bkgd) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                          // kRows x kWidth
  float* xs = act + kRows * kWidth;           // kRows x kPosPad
  float* wbuf = xs + kRows * kPosPad;         // 2 x kSlice x kWidth
  float* cterm = wbuf + 2 * kSlice * kWidth;  // ray_tile x kCondWidth
  float* sig = cterm + ray_tile * kCondWidth; // ray_tile*S raw sigma
  float* rgb = sig + ray_tile * S;            // ray_tile*S x 3 raw rgb

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;

  // Per-ray view-condition term: cterm[g][n] = venc[ray0+g] . wvb[:, n].
  for (int i = threadIdx.x; i < ray_tile * kCondWidth; i += kThreads) {
    const int g = i / kCondWidth, n = i % kCondWidth;
    const float* v = venc + (size_t)(ray0 + g) * kView;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kView; ++k) s = fmaf(__ldg(v + k), __ldg(w.wvb + k * kCondWidth + n), s);
    cterm[i] = s;
  }

  for (int row0 = 0; row0 < n_rows; row0 += kRows) {
    const int valid_rows = min(kRows, n_rows - row0);
    // Encoded inputs of this chunk; padded rows and the pad column are 0.
    const float* xg = xenc + (row_base + row0) * kPos;
    for (int i = threadIdx.x; i < kRows * kPosPad; i += kThreads) {
      const int r = i / kPosPad, c = i % kPosPad;
      xs[i] = (r < valid_rows && c < kPos) ? __ldg(xg + r * kPos + c) : 0.f;
    }
    __syncthreads();

    dense_relu(xs, kPosPad, kPos, w.w0, w.b0, act, wbuf);
    dense_relu(act, kWidth, kWidth, w.w1, w.b1, act, wbuf);
    dense_relu(act, kWidth, kWidth, w.w2, w.b2, act, wbuf);
    dense_relu(act, kWidth, kWidth, w.w3, w.b3, act, wbuf);
    dense_relu(act, kWidth, kWidth, w.w4, w.b4, act, wbuf);
    {  // skip layer: relu(h . w5x + x_enc . w5i + b5)
      float a5[8][8];
      zero<256>(a5);
      gemm_acc<256>(a5, act, kWidth, kWidth, w.w5x, wbuf);
      gemm_acc<256>(a5, xs, kPosPad, kPos, w.w5i, wbuf);
      store_act<256>(a5, w.b5, true, act, nullptr, 0, 1, 1);
    }
    dense_relu(act, kWidth, kWidth, w.w6, w.b6, act, wbuf);
    dense_relu(act, kWidth, kWidth, w.w7, w.b7, act, wbuf);

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
      gemm_acc<256>(ab, act, kWidth, kWidth, w.wb, wbuf);
      store_act<256>(ab, w.bb, false, act, nullptr, 0, 1, 1);
    }
    {  // view layer: relu(btl . wva + cterm[ray] + bv) -> act[:, :128]
      float av[8][4];
      zero<128>(av);
      gemm_acc<128>(av, act, kWidth, kWidth, w.wva, wbuf);
      store_act<128>(av, w.bv, true, act, cterm, row0, S, n_rows);
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

  // Integrator, one warp per ray.
  for (int g = warp; g < ray_tile; g += kWarps) {
    const int ray = ray0 + g;
    const float* tr = t + (size_t)ray * S;
    const float dx = __ldg(rays_d + ray * 3), dy = __ldg(rays_d + ray * 3 + 1),
                dz = __ldg(rays_d + ray * 3 + 2);
    const float dnorm = sqrtf(dx * dx + dy * dy + dz * dz);
    float carry = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f, acc_w = 0.f, dep = 0.f;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      float alpha = 0.f, logv = 0.f, ts = 0.f;
      if (s < S) {
        ts = __ldg(tr + s);
        float dist = (s + 1 < S) ? (__ldg(tr + s + 1) - ts) : 1e10f;
        dist = dist * dnorm;
        const float sigma = fmaxf(sig[g * S + s], 0.f);
        alpha = 1.f - expf(-sigma * dist);
        logv = logf(fmaxf(1.f - alpha + 1e-10f, 1e-10f));
      }
      float inc = logv;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      float excl = __shfl_up_sync(kFull, inc, 1);
      if (lane == 0) excl = 0.f;
      const float wgt = alpha * expf(carry + excl);
      carry += __shfl_sync(kFull, inc, 31);
      if (s < S) {
        weights_out[(size_t)ray * S + s] = wgt;
        const float* raw = rgb + (size_t)(g * S + s) * 3;
        c0 = fmaf(wgt, 1.f / (1.f + expf(-raw[0])), c0);
        c1 = fmaf(wgt, 1.f / (1.f + expf(-raw[1])), c1);
        c2 = fmaf(wgt, 1.f / (1.f + expf(-raw[2])), c2);
        acc_w += wgt;
        dep = fmaf(wgt, ts, dep);
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

// Shared memory (bytes) one block needs for ray_tile rays of S samples.
size_t smem_bytes(int S, int ray_tile) {
  return sizeof(float) * ((size_t)kRows * kWidth + (size_t)kRows * kPosPad +
                          2 * (size_t)kSlice * kWidth + (size_t)ray_tile * kCondWidth +
                          4 * (size_t)ray_tile * S);
}

}  // namespace

extern "C" {

// Launches one level on `stream`. Pointers are device pointers to contiguous
// fp32 arrays, weights in the flax (in, out) layout. n_rays % ray_tile == 0.
// Returns cudaGetLastError() after the launch (0 on success).
int aonerf_fused_render_level(const float* t, const float* rays_d, const float* venc,
                              const float* xenc, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              const float* w3, const float* b3, const float* w4, const float* b4,
                              const float* w5x, const float* w5i, const float* b5,
                              const float* w6, const float* b6, const float* w7, const float* b7,
                              const float* wd, const float* bd, const float* wb, const float* bb,
                              const float* wva, const float* wvb, const float* bv,
                              const float* wr, const float* br, float* comp, float* acc,
                              float* depth, float* weights, int n_rays, int S, int ray_tile,
                              int white_bkgd, void* stream) {
  if (n_rays <= 0 || S <= 0 || ray_tile <= 0 || n_rays % ray_tile != 0) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, ray_tile);
  // Refused when smem exceeds what a block may have (227 KB on Hopper).
  cudaError_t err = cudaFuncSetAttribute(fused_render_level_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  Weights w{w0, b0, w1, b1, w2, b2, w3, b3, w4, b4, w5x, w5i, b5, w6, b6, w7, b7,
            wd, bd, wb, bb, wva, wvb, bv, wr, br};
  fused_render_level_kernel<<<n_rays / ray_tile, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, rays_d, venc, xenc, w, comp, acc, depth, weights, S, ray_tile, white_bkgd);
  return cudaGetLastError();
}

}  // extern "C"
