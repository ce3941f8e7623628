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
// + t). At the fine level (4096 rays x 193 samples) that is ~0.93 TFLOP. All
// but the 1- and 3-wide heads (640 of 589,952 multiply-adds a sample) run on
// the tensor cores in 3xTF32, three TF32 products each: >= 5.66 ms at the
// H100's 495 TFLOP/s TF32 peak (1.91 ms at S = 65). In plain fp32 on the CUDA
// cores the same work needs >= 13.9 ms at 67 TFLOP/s. The bytes (~0.2 GB)
// would take ~0.06 ms at 3.35 TB/s.
//
// What the design does about it:
//  * 3xTF32 on the tensor cores (mma.sync m16n8k8): each fp32 operand is split
//    into a TF32 big and small part and small.big + big.small + big.big
//    accumulate in fp32, so the products keep fp32's accuracy; every 16
//    deep (6 mma, kFwdRun) a fresh accumulator starts and fp32 adds fold it
//    into the running sum, since the tensor cores truncate as they
//    accumulate (a fresh one every 32 deep, as K2's B1 has, left the
//    activations twice fp32's error against fp64). The
//    product is gemm_wt (nerf_level.cuh), the one K2's B1 runs: the weights
//    are read transposed (out x in, K-major; the wrapper rebuilds the 2.4 MB
//    copy every launch), so the weight is the mma's "col" operand.
//  * One block (256 threads) owns `ray_tile` whole rays and walks their
//    ray_tile*S samples in chunks of 64 rows, packed across ray boundaries so
//    only the last chunk is padded (S = 65 or 193 is not a multiple of 64).
//    A block's shared memory and registers allow one block a SM, and the
//    chunks of a block run one after another, so the wrapper picks the tile
//    per launch (fused_render.py::choose_ray_tile): of the tiles of at most
//    16 rays that divide the launch and fit, the fewest waves (ceil(blocks /
//    132)) x chunks a block, ties to the larger. 16 at 2048 and 4096 rays;
//    2 at the fast preset's 256 (128 blocks of 3 / 7 chunks at S = 65 / 193,
//    where 16 rays a block gave 16 blocks of 17 / 49); 15 at the test path's
//    3840 (256 blocks). A row's outputs depend on no other row, so the tile
//    moves no bit.
//  * The chunk's activation (64 x 256 fp32, rows padded to 260 floats so the
//    A fragments' loads are conflict-free) stays in shared memory. Each warp
//    keeps a 32-row x 64-column output tile (32 x 32 in the 128-wide view
//    layer) in registers, so a layer is written back over its own input once
//    every thread has finished reading it: one activation buffer.
//  * The weights (~2.4 MB for one MLP) do not fit in shared memory, and
//    every 64-row chunk reads all of them from L2 in the same order. One
//    TMA stream per block (WeightRing, nerf_level.cuh) walks that order as
//    16-deep K-slices of the transposed copies (one 2D tensor map per
//    weight, encoded by the launcher for every launch) through a 5-stage
//    ring, wrapping from chunk to chunk, with one mbarrier wait per slice
//    and refills issued 4 slices ahead across layer boundaries.
//  * The skip layer is a split product, w5x . h + w5i . x_enc (K padded to
//    64, the pad column of x_enc and of w5i^T zero), into one accumulator;
//    the encoded input chunk is kept beside the activation.
//  * The view-condition term venc . wvb is computed once per ray and added to
//    that ray's rows in the view layer's epilogue.
//  * The 1-wide density head and the 3-wide rgb head are warp dot products
//    in fp32. Per-sample raw sigma and rgb wait in shared memory until the
//    block's rays are done; then one warp per ray integrates: alpha, a warp
//    prefix sum of log(max(1 - alpha + 1e-10, 1e-10)) with a carry across
//    32-sample steps (the TPU kernel's triangular matmul), weights, rgb, acc,
//    depth.
//
// Shared memory: the 83 KB weight ring, 64x260 activation + 64x68 encoded
// input + ray_tile x (128 + 4 S) per-ray values, 224,640 bytes at
// ray_tile=16, S=193. One block per SM. The chunk walk, the product and the
// integrator live in nerf_level.cuh, shared with the training forward K1s
// (fused_train.cu), which computes the same bits and also saves the
// activations. K1 serves and validates; training runs K1s.
//
// bf16 mode (dot_bf16, the TPU kernel's argument of that name): the same
// walk on bf16-rounded inputs and activations, a second instantiation of the
// kernel picked by the launcher. Its products run on native bf16 tensor
// cores (gemm_bf16, nerf_level.cuh: mma.sync m16n8k16 bf16, fp32
// accumulators, a fresh one for each mma's 16 consecutive K-columns, the
// groups of the TF32 walk it replaced) with B from a ring of 32-deep slices
// of the wrapper's bf16 pack of the transposed weights (`wt` as bf16, each
// 32-column block permuted for the fragments; half the bytes and half the
// slices of the fp32 stream) and A packed to bf16 pairs from the fp32
// activation tile; each log term of the
// transmittance is rounded to bf16 before the prefix sum. Bound: operations,
// the products at 989 TFLOP/s, 0.32 / 0.96 ms at 4096 rays x S = 65 / 193
// (0.020 / 0.060 ms at 256).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8, printed by chip_smoke.py's build
// phase on the H100): 216 registers in fp32, 173 in bf16 mode, no spill.
// Measured there (NVIDIA H100 80GB HBM3, 700 W; tools/torch_train_compare.py,
// in turns with the parent tree): fp32 17.8 / 6.3 ms at 4096 rays x S = 193 /
// 65, ~32% / ~31% of the 3xTF32 bound; what bounds it is the product's own
// instruction stream (mma.sync with the TF32 split of every fragment), not
// the staging: a ring of 3, 4 or 5 stages takes the same time, one of 2
// stages ~20% more. bf16 mode 6.41-6.43 / 2.30-2.33 ms at 4096 rays (the
// TF32 walk on bf16 values it replaced 9.92-9.97 / 3.51), 15% of its bound
// at S = 193; at 256 rays and the chosen tile of 2, 0.443-0.446 / 0.191-0.196
// ms of device time (the TF32 walk, 16 rays a block: 4.67-4.86 / 1.64-1.73).

#include "nerf_level.cuh"

namespace {

using namespace aonerf;

template <bool Bf16>
__global__ void __launch_bounds__(kThreads, 1)
fused_render_level_kernel(const float* __restrict__ t, const float* __restrict__ rays_d,
                          const float* __restrict__ venc, const float* __restrict__ xenc, Weights w,
                          const __grid_constant__ WeightMaps maps, float* __restrict__ comp,
                          float* __restrict__ acc_out, float* __restrict__ depth,
                          float* __restrict__ weights_out, int S, int ray_tile, int white_bkgd) {
  extern __shared__ __align__(16) float smem[];
  const ForwardSmem m = carve_forward_smem(smem, S, ray_tile);
  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;

  FwdRing<Bf16> ring(m.ring, maps.m, n_rows);
  view_terms<Bf16>(venc, w.wvb, m.cterm, ray0, ray_tile);
  for (int row0 = 0; row0 < n_rows; row0 += kRows)
    forward_chunk<false, Bf16>(xenc, w, ring, m, row_base, row0, n_rows, S, SpillTo<Bf16>{});

  integrate_rays<Bf16>(t, rays_d, m.sig, m.rgb, ray0, ray_tile, S, white_bkgd, comp, acc_out, depth, weights_out);
}

}  // namespace

extern "C" {

// The encoded widths this library was built for: kPos (xenc's features) and
// kView (venc's).
int aonerf_fused_render_pos_dim() { return kPos; }
int aonerf_fused_render_view_dim() { return kView; }

// Floats of the packed transposed product weights `wt` (FwdSchedule), and
// bytes of their bf16 pack (FwdBf16Schedule), which bf16 mode takes.
int aonerf_fused_render_wt_floats() { return kWtFloats; }
int aonerf_fused_render_wt_bf16_bytes() {
  return schedule_floats<FwdBf16Schedule>() * (int)sizeof(FwdBf16Schedule::Elem);
}

// Shared memory of a block of ray_tile rays of S samples.
int aonerf_fused_render_smem_bytes(int S, int ray_tile) { return (int)forward_smem_bytes(S, ray_tile); }

// Launches one level on `stream`. Pointers are device pointers to contiguous
// fp32 arrays: the level's inputs, its 26 weights in the flax (in, out)
// layout (the kernel reads their biases and narrow heads), and `wt`, the
// packed transposed copies of its 11 product weights (FwdSchedule,
// kWtFloats, 16-byte aligned), over which it encodes the TMA maps of this
// launch. With dot_bf16 != 0 it launches the bf16 mode, which takes `wt` as
// the bf16 pack of the same copies (FwdBf16Schedule, kWtFloats bf16) and the
// narrow heads (wd, wr, wvb) already rounded to bf16. n_rays % ray_tile ==
// 0. Returns cudaGetLastError() after the launch (0 on success), or
// kMapError + the driver's CUresult if a tensor map was refused.
int aonerf_fused_render_level(const float* t, const float* rays_d, const float* venc,
                              const float* xenc, const float* w0, const float* b0,
                              const float* w1, const float* b1, const float* w2, const float* b2,
                              const float* w3, const float* b3, const float* w4, const float* b4,
                              const float* w5x, const float* w5i, const float* b5,
                              const float* w6, const float* b6, const float* w7, const float* b7,
                              const float* wd, const float* bd, const float* wb, const float* bb,
                              const float* wva, const float* wvb, const float* bv,
                              const float* wr, const float* br, const void* wt, float* comp, float* acc,
                              float* depth, float* weights, int n_rays, int S, int ray_tile,
                              int white_bkgd, int dot_bf16, void* stream) {
  if (n_rays <= 0 || S <= 0 || ray_tile <= 0 || n_rays % ray_tile != 0) return cudaErrorInvalidValue;
  const size_t smem = forward_smem_bytes(S, ray_tile);
  auto* kernel = dot_bf16 ? fused_render_level_kernel<true> : fused_render_level_kernel<false>;
  // Refused when smem exceeds what a block may have (227 KB on Hopper).
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  WeightMaps maps;
  if (int map_err = encode_forward_maps(maps, wt, dot_bf16 != 0)) return map_err;
  Weights w{w0, b0, w1, b1, w2, b2, w3, b3, w4, b4, w5x, w5i, b5, w6, b6, w7, b7,
            wd, bd, wb, bb, wva, wvb, bv, wr, br};
  kernel<<<n_rays / ray_tile, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, rays_d, venc, xenc, w, maps, comp, acc, depth, weights, S, ray_tile, white_bkgd);
  return cudaGetLastError();
}

}  // extern "C"
