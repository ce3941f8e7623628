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
// S=193. One block per SM. The chunk walk, the weight streaming and the
// integrator live in nerf_level.cuh, shared with the training forward K1s
// (fused_train.cu), which computes the same bits and also saves the
// activations. K1 serves and validates; training runs K1s.

#include "nerf_level.cuh"

namespace {

using namespace aonerf;

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

  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;

  view_terms(venc, w.wvb, cterm, ray0, ray_tile);
  for (int row0 = 0; row0 < n_rows; row0 += kRows)
    forward_chunk<false>(xenc, w, act, xs, wbuf, cterm, sig, rgb, row_base, row0, n_rows, S, nullptr);

  integrate_rays(t, rays_d, sig, rgb, ray0, ray_tile, S, white_bkgd, comp, acc_out, depth, weights_out);
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
  const size_t smem = forward_smem_bytes(S, ray_tile);
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
