// The training side of the fused NeRF level for Hopper (sm_90a): the forward
// that saves what the backward needs (K1s), and the weight gradient (K2).
//
// Replaces the Pallas TPU kernel aonerf/ops/kernels/fused_train.py::_bwd_kernel
// (launched by _fused_level_bwd_impl), and, on the training path, the forward
// aonerf/ops/kernels/fused_render.py::_kernel that make_fused_level runs
// before it. The TPU backward recomputes the forward in VMEM; on the H100 the
// training forward saves the activations instead, so each step runs each
// level's MLP forward once. Given the level's inputs and the cotangents of
// its four outputs (comp, acc, depth, weights), K2 returns the gradients of
// the 26 weights; the inputs get none (coarse t-values are parameter-free,
// fine t-values are detached).
//
// Five kernels, in order on one stream. Per sample: the forward, 589,952
// multiply-adds; the input products delta . W^T, 557,696; the weight products
// h^T . delta, 589,952. At 2048 rays x 193 samples (395,264 rows):
//
//  K1s. level_fwd_spill_kernel (3xTF32 tensor cores; bound by operations,
//     2.83 ms at 495/3 TFLOP/s, 6.96 ms were it fp32 FMA at 67 TFLOP/s, over
//     its 3.85 GB of spill, 1.15 ms at 3.35 TB/s): K1's forward walk
//     (nerf_level.cuh: every 256- and 128-wide product through gemm_wt on the
//     weights' transposed copies `wt`, streamed by TMA through the block's
//     5-stage weight ring) over the block's ray_tile rays, and
//     K1's integrator forward, so comp/acc/depth/weights are K1's bits. Every
//     valid row's activations (h0..h7, bottleneck, view hidden: kSpill =
//     2432 floats) go to the scratch `saved`: after each layer's epilogue has
//     written the activation into the shared tile, thread 0 copies its rows
//     out with one cp.async.bulk (1 KB, 512 B for the view layer) per row,
//     and waits for them to finish reading shared memory only before the
//     next epilogue overwrites the tile; the copy engine moves the 3.85 GB
//     while the warps run the next layer's product. The copies carry an
//     L2::evict_first policy. Every block re-reads all 2.4 MB of weights per
//     64-row chunk from L2 (the ring's TMA loads), and the spill writes ~84
//     MB through L2 between two reads of one layer's slice; without the
//     policy the weights were evicted and came back from HBM, which cost the
//     fp32-FMA walk 2.0 / 5.8 ms over K1 at S = 65 / 193 on the H100, with
//     bulk copies and per-thread stores alike; with it, 0.06 / 0.3 ms. Each
//     sample's raw sigma and rgb go to `raw` (4 floats). Spilling beats
//     recomputing: a 64-row chunk's eight trunk activations (512 KB) do not
//     fit in shared memory, and the integrator backward needs a whole ray
//     before any chunk's MLP backward.
//  I. level_bwd_integrator_kernel (bound by bytes, 16 MB): one warp per ray
//     runs the integrator forward and backward from `raw`: g_w from the
//     cotangents, g_alpha = g_w T - suffix(g_w w) / max(1 - alpha + 1e-10,
//     1e-10) with the suffix sum taken right to left by a warp scan (a direct
//     sum, never a difference of prefix sums, which would cancel where v is
//     tiny), and g_raw_sigma, g_raw_rgb per sample to `grow`.
//  B1. level_bwd_delta_kernel (3xTF32 tensor cores; bound by operations,
//     2.67 ms at 495/3 TFLOP/s, over its 7.7 GB of bytes, 2.30 ms): the
//     block's rays again, in 64-row chunks, from the rgb head down in the
//     order of fused_level_bwd_ref: delta_v, g_btl, delta_7 (with the rank-1
//     g_raw_sigma wd^T term), delta_6 .. delta_0, the ReLU masks from the
//     saved activations. Each delta goes to the scratch `delta` (kSpill
//     floats a sample, laid out like `saved`). delta . W^T is a 64 x 256
//     product on mma.sync m16n8k8 TF32 (gemm_wt, in nerf_level.cuh, which the
//     forward walk also runs): B(k, n) = W[n][k] is the "col" operand read
//     from W's flax (in, out) layout, which is K-major for this product, so
//     B1 needs no transposed copy of any weight. The block's weight stream
//     (B1Schedule: wva, wb, w7 .. w1, 136 16-deep K-slices a chunk) runs
//     through a 5-stage TMA ring of 16-deep slices, as the forward's does;
//     each saved activation H a chunk's product masks with is loaded by
//     cp.async under the product before it and waited for before the
//     product's closing barrier. The narrow head products (wr, br,
//     wd, bd; wvb through the per-ray sum of delta_v, rows in order) stay on
//     fp32 FMA (N = 3 and 1 fit no tensor-core tile; 0.1% of the work), each
//     chunk's sum added to the thread's running sum, written once per block to
//     its narrow set (kNarrowFloats). Shared memory 225,408 bytes at
//     ray_tile 16 (the 83 KB ring, D and H, the per-ray and per-row terms).
//  B1 in bf16 mode. level_bwd_delta_kernel<true>: the same chain on native
//     bf16 products (gemm_bf16: mma.sync m16n8k16, half the mma of the TF32
//     k8 walk it replaced) from a ring of 32-deep slices of the wrapper's
//     bf16 pack of its weights. What bounds it is bytes: the saved bf16
//     values at 2 bytes and the fp32 deltas it writes, 1.73 ms at 3.35 TB/s
//     at S = 193 (its products 0.45 ms at 989 TFLOP/s); as laid out, both
//     in fp32, 7.7 GB, 2.30 ms. Its ray tile is chosen per launch (below).
//  B2. level_bwd_dw_kernel (3xTF32 tensor cores; bound by operations,
//     2.82 ms at 495/3 TFLOP/s, over its 7.6 GB, 2.27 ms): every dW_l = H^T
//     Delta_l (H from `saved`, or xenc for w0 and w5i) as a split-K product
//     over the sample rows. A block owns one kDwM x kDwN = 64 x 128 tile of
//     one dW and one of kRanges = 16 fixed row ranges (72 tiles x 16 ranges =
//     1152 blocks, two per SM), keeps the tile's sums in registers across the
//     range, and writes it once to that range's partial set; no partial is
//     ever read back while it accumulates. The range count does not depend on
//     the card, so neither does the result. Thread 0 loads each 32-row stage
//     of H (64 columns) and Delta (128) by TMA into a 3-stage ring, one full
//     barrier a stage; its boxes are 8 columns wider than the tile, so the
//     rows land at strides 72 and 136 (8 mod 32) and every fragment read is a
//     conflict-free 16-byte load (the m16 and n8 tiles' rows and columns are
//     interleaved to make them so). One pass a stage splits H into TF32 pairs
//     once (the parent split each value in each of the four warps that read
//     it); Delta is split in registers. Hopper's wgmma takes TF32 only
//     K-major, and here K is the sample row, which is the major dimension of
//     both H^T and Delta; so B2 uses mma.sync, not wgmma after a transpose.
//     H is read from device memory once per column tile of dW (twice for N =
//     256) and Delta once per row tile (four times for K = 256); the blocks
//     that share those rows run side by side, so the repeats come mostly from
//     L2. mma.sync m16n8k8 TF32 itself issues at most one every 6 clocks a
//     SM sub-partition on the H100 (~300 TFLOP/s, PERF.md), which puts B2's
//     floor near 1.5 / 4.6 ms at 2048 rays x S = 65 / 193.
//  B2 in bf16 mode. level_bwd_dw_bf16_kernel, for the weight products of
//     the Pallas _bwd_kernel with dot_bf16 (its _dot_t, bf16 operands, fp32
//     sums): the same tiles, ranges and partial sets as the fp32 B2 on
//     native bf16 products, mma.sync m16n8k16 (half the mma of a TF32 k8
//     walk; at 989 TFLOP/s its products take 0.47 ms at S = 193). What
//     bounds it is bytes: the saved activations are bf16 values (2 bytes
//     each) and the deltas fp32 (the bias sums need them), 1.73 ms at 3.35
//     TB/s at S = 193; but both scratches are laid out in fp32, 7.6 GB (2.28
//     ms), and every block stages those fp32 rows through shared memory and
//     rounds them there (cp.async and TMA cannot convert). Each block loads
//     its rows by TMA into a 4-stage ring of 32-row fp32 stages (one wait a
//     step); one pass a step rounds the stage to a bf16 tile in the layout
//     ldmatrix.trans reads and sums the bias tile from the fp32 deltas; no
//     fragment is converted. Both operands are K-major here (K is the sample
//     row), which ldmatrix.trans turns into mma.sync's fragments. 112,672
//     bytes of shared memory, two blocks a SM. On the H100
//     (tools/torch_train_compare.py, in turns): 1.37-1.39 / 4.35-4.38 ms at
//     2048 rays x S = 65 / 193, 40% of the 2-byte bound at S = 193, against
//     2.31-2.32 / 6.67-6.71 for the TF32 walk on bf16 values it replaced.
//     Clusters of the four M tiles of a column tile, each Delta row
//     multicast to the four, took B2 to 3.91-3.92 ms at S = 193, but the
//     bf16 train step did not resolve that gain (10 pairs in turns), so the
//     blocks stay independent. What the rounding pass and the products add
//     goes through shared memory (~92 KB a block a step). Below the layout's
//     2.28 ms only a bf16 layout of `saved` and `delta` (K1s, B1) would go.
//  R. level_bwd_reduce_kernel: sums the 16 partial sets (38 MB, which L2
//     holds) and the B1 blocks' narrow sets, each in a fixed order.
//
// 3xTF32 (K1s, B1, B2; the helpers live in nerf_level.cuh): each fp32
// operand x is split into big = tf32(x) and small = tf32(x - big), and
// small.big + big.small + big.big accumulate in fp32 (the small terms first,
// as CUTLASS orders them); the dropped small.small is ~2^-22 of the product,
// so the products keep fp32's accuracy. The tensor cores' accumulation
// truncates, so each run of 6 (K1s), 12 (B1) or 24 (B2) mma has a fresh
// accumulator that fp32 adds fold into the running sum.
//
// bf16 mode (dot_bf16, the TPU kernels' argument of that name; K1s and B1
// have a second instantiation, B2 a kernel of its own, the integrator
// backward and the reduction serve both modes): every product takes
// bf16-rounded operands (to nearest, ties to even) and sums in fp32. K1s
// runs K1's bf16 walk (native bf16 mma.sync m16n8k16 from the bf16 weight
// ring, nerf_level.cuh's gemm_bf16; the wrapper passes the bf16 pack of the
// transposed weights and the narrow heads rounded) and spills the rounded
// activations, which the TPU backward keeps in bf16, in the fp32 layout. B1
// runs the same gemm_bf16 on its delta tile D (fp32 layout, bf16 values),
// from a ring of 32-deep slices of the wrapper's bf16 pack of its nine
// flax-layout weights (B1Bf16Schedule, 68 slices a chunk where the fp32
// stream has 136), each fresh accumulator summing kB1Bf16Run k16 steps; it
// reads no other weight but wd and wr, which come rounded. The integrator
// backward stays fp32 and recomputes the transmittance in fp32 from `raw`,
// as the TPU backward does.
// B1 keeps every delta in fp32 in the scratch, which B2's bias sums read, and
// in its own per-ray sum for wvb; only a product's operand is rounded: the
// shared tile D that feeds the next product gets the rounded delta, and the
// narrow head products round g_raw_sigma, g_raw_rgb and the per-ray sum as
// they read them. B2 in bf16 is a kernel of its own (above): it rounds H and
// Delta once a step into bf16 tiles, and sums the bias tile from the fp32
// stage. Every bf16 product is mma.sync m16n8k16 bf16, whose sums group
// otherwise than the TF32 walk on bf16 values that each replaced, so the
// bf16 outputs differ in their bits from that walk's and are held to the
// bf16 rule; every fp32 output keeps its bits.
//
// K1s runs at the ray tile its wrapper chooses (fused_render.py::
// choose_ray_tile: 2 at the fast preset's batch of 224, 16 at 2048); its
// outputs do not depend on the tile. B1's per-block head sums set K2's
// summation order and so its bits: fp32 K2 keeps 16 rays a block unless
// the caller names a tile; bf16 K2, held to the rule, takes the tile the
// same rule chooses over B1's shared memory (2 at 224 rays: 112 blocks of 3
// / 7 chunks where 16 gave 14 blocks of 17 / 49; 16 at 2048). B1's deltas,
// and so B2's gradients, do not depend on the tile.
//
// Deterministic: no atomics, every sum in a fixed order, so the same inputs
// give the same bits on every call.
//
// Scratch at 2048 x 193: saved and delta 3.85 GB each (saved lives from K1s
// to K2), raw and grow 6.3 MB each, partials 16 x 2.38 MB, narrow 128 x 16.4
// KB.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8, printed by chip_smoke.py's build
// phase on the H100): K1s 220 registers, no spill (174 in bf16 mode); the integrator backward
// 39; B1 255 registers, 20 bytes of spill stores and 20 of spill loads
// (24-byte stack frame), in bf16 see PERF.md; B2 128 registers (capped by
// __launch_bounds__(256, 2)), 24 bytes of spill stores and loads (16-byte
// stack frame; the two stores sit before its main loop), and in bf16 124,
// no spill; the reduction 31 registers.
//
// Measured there (NVIDIA H100 80GB HBM3, 700 W; tools/torch_train_compare.py,
// 2048 rays, S = 65 / 193): K1s 3.33-3.40 / 9.51-9.77 ms, B1 3.26-3.31 /
// 9.15-9.22 ms, ~29% of their 3xTF32 bounds. What bounds K1s and B1 is the
// product's own instruction stream (mma.sync with the TF32 split of every
// fragment), not the staging: a ring of 3, 4 or 5 stages gives K1s the same
// time (B1 takes 3% more with 3), one of 2 stages 24% (K1s) and 36% (B1)
// more. K1s in bf16 mode (in turns with the parent tree, PR 14): 1.30-1.34 /
// 3.65-3.68 ms at 2048 rays (the TF32 walk on bf16 values it replaced
// 2.07-2.08 / 5.62-5.67), 0.205-0.207 / 0.491-0.497 ms of device time at the
// fast preset's 224 rays and tile 2 (the parent, 16 rays a block:
// 1.87-1.88 / 5.32-5.39). B1 in bf16 on the TF32 walk it replaced: 2.16 /
// 6.14-6.21 ms at 2048 and 2.03 / 5.84 at 224 (one wave of 14 blocks); on
// gemm_bf16, PERF.md section 6. B2 in fp32: 2.559-2.582 / 8.014-8.224 ms,
// in turns with the cp.async double buffer it replaced, 3.153-3.188 /
// 9.138-9.169 (fp32 torch.mm over the same products 3.074 / 8.683 in
// chip_smoke.py). One block a SM (255 registers, a ring of 3 or 4
// stages) was slower at both S. With two blocks a SM, a stage of both takes
// ~2,300 clocks of each sub-partition's tensor pipe (384 mma at 6 clocks)
// and ~2,300 of the SM's shared memory (~293 KB at 128 bytes a clock: TMA
// writes, the split pass, the fragment reads); at the ~1.7 GHz that
// tools/torch_mma_rate.py ran at, the kernel takes ~1.75x either.

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

// The output (and each row range's partial set): the 26 gradients in order,
// each starting 16-byte aligned.
struct Layout {
  int off[kNumGrads + 1];
  int size[kNumGrads];
};
constexpr Layout make_layout() {
  Layout l{};
  for (int g = 0; g < kNumGrads; ++g) {
    l.size[g] = kGradSize[g];
    l.off[g + 1] = l.off[g] + (kGradSize[g] + 3) / 4 * 4;
  }
  return l;
}
constexpr Layout kLayout = make_layout();
constexpr int kPartialFloats = kLayout.off[kNumGrads];
__constant__ Layout c_layout = make_layout();

// Pass B1. The delta scratch holds kSpill floats a sample, shaped like the
// saved rows: delta_0..delta_7 at l * kWidth, the bottleneck's gradient at
// kSpillBtl, delta_v at kSpillView. D and H (kRows x kAct) use the forward's
// activation stride, the weight ring its stages (nerf_level.cuh).
// A B1 block's narrow partial set: the head gradients summed over its rays.
constexpr int kNarrowWd = 0, kNarrowBd = kNarrowWd + kWidth, kNarrowWr = kNarrowBd + 4,
              kNarrowBr = kNarrowWr + kCondWidth * 3, kNarrowWvb = kNarrowBr + 4,
              kNarrowFloats = kNarrowWvb + kView * kCondWidth;

// Pass B2. dW = H^T . Delta for one layer, split over kRanges fixed ranges of
// sample rows; a block owns a kDwM x kDwN tile of one dW and one range, and
// sums the range kDwStep rows at a time (in fp32, each step's products into
// a fresh accumulator; ranges are whole steps).
constexpr int kRanges = 16;
constexpr int kDwM = 64, kDwN = 128, kDwStep = 64;
// B2 in fp32: kDwRows rows a ring stage (kDwStep / kDwRows stages a step), a
// ring of kDwStages stages, each H's kDwHs and then Delta's kDwDs columns a
// row (strides 8 mod 32: conflict-free float4 fragment reads), one stage's H
// split into TF32 pairs in fragment order (kDwSplitWords), and the stages'
// full barriers, after up to kRingAlign bytes of alignment: 97,304 bytes,
// two blocks a SM.
constexpr int kDwRows = 32, kDwStages = 3;
constexpr int kDwHs = kDwM + 8, kDwDs = kDwN + 8;
constexpr int kDwStageFloats = kDwRows * (kDwHs + kDwDs);
constexpr int kDwStageBytes = kDwStageFloats * (int)sizeof(float);
constexpr int kDwSplitWords = (kDwRows / 8) * 2 * 4 * 32 * 4;  // [k8 step][row half][4][lane][4]
constexpr size_t kDwSmemBytes = kRingAlign + (size_t)kDwStages * kDwStageBytes + sizeof(uint32_t) * kDwSplitWords +
                                kDwStages * sizeof(uint64_t);
static_assert(kDwStep % kDwRows == 0 && kDwRows % 8 == 0, "a step is whole stages of whole k8 steps");
static_assert((kDwRows / 8) * 2 * 32 == kThreads, "the split pass: one thread a (k8 step, row half, lane)");
static_assert(kDwStageBytes % 128 == 0 && (kDwRows * kDwHs * 4) % 128 == 0, "TMA destinations 128-byte aligned");
constexpr int kX = -1;  // h_off of the products whose H is the encoded input
// B2 in bf16 mode: kDw16Step rows a step, a ring of kDw16Stages fp32 stages
// (H's kDwM then Delta's kDwN columns a row, unpadded), one bf16 tile of the
// step (row strides 72 and 136 bf16, 144 and 272 bytes: the 8 rows of an
// ldmatrix fall in 8 different 16-byte bank groups) and the stages' full
// barriers, after up to kRingAlign bytes of alignment: 112,672 bytes, two
// blocks a SM.
constexpr int kDw16Step = 32, kDw16Stages = 4;
constexpr int kDw16Stage = kDw16Step * (kDwM + kDwN);
constexpr int kDw16Hs = kDwM + 8, kDw16Ds = kDwN + 8;
constexpr size_t kDw16SmemBytes = kRingAlign + sizeof(float) * kDw16Stages * kDw16Stage +
                                 sizeof(uint16_t) * kDw16Step * (kDw16Hs + kDw16Ds) + kDw16Stages * sizeof(uint64_t);
static_assert(kDw16Stages * kDw16Stage >= (kThreads / 32) * kDwN, "the bias tile's row groups fit in the ring");

// One weight product: dW[grad] (K x N) = H^T . Delta over all sample rows,
// H the saved columns [h_off, h_off + K) (or xenc), Delta the scratch columns
// [d_off, d_off + N); with bias >= 0, also the bias gradient sum(Delta).
struct DwProduct {
  int grad, bias, h_off, K, d_off, N;
};
#define AONERF_DW_PRODUCTS                                                                            \
  {G_W0, G_B0, kX, kPos, 0, kWidth}, {G_W1, G_B1, 0, kWidth, kWidth, kWidth},                        \
      {G_W2, G_B2, kWidth, kWidth, 2 * kWidth, kWidth},                                              \
      {G_W3, G_B3, 2 * kWidth, kWidth, 3 * kWidth, kWidth},                                          \
      {G_W4, G_B4, 3 * kWidth, kWidth, 4 * kWidth, kWidth},                                          \
      {G_W5X, G_B5, 4 * kWidth, kWidth, 5 * kWidth, kWidth}, {G_W5I, -1, kX, kPos, 5 * kWidth, kWidth}, \
      {G_W6, G_B6, 5 * kWidth, kWidth, 6 * kWidth, kWidth},                                          \
      {G_W7, G_B7, 6 * kWidth, kWidth, 7 * kWidth, kWidth},                                          \
      {G_WB, G_BB, 7 * kWidth, kWidth, kSpillBtl, kWidth},                                           \
      {G_WVA, G_BV, kSpillBtl, kWidth, kSpillView, kCondWidth}
constexpr DwProduct kProducts[] = {AONERF_DW_PRODUCTS};
__constant__ DwProduct c_products[] = {AONERF_DW_PRODUCTS};
constexpr int kNumProducts = sizeof(kProducts) / sizeof(kProducts[0]);
__host__ __device__ constexpr int m_tiles(const DwProduct& p) { return (p.K + kDwM - 1) / kDwM; }
__host__ __device__ constexpr int product_tiles(const DwProduct& p) { return m_tiles(p) * (p.N / kDwN); }
constexpr int count_tiles() {
  int n = 0;
  for (int p = 0; p < kNumProducts; ++p) n += product_tiles(kProducts[p]);
  return n;
}
constexpr int kDwTiles = count_tiles();  // 72

// K1s: K1's forward walk over the block's ray_tile rays, saving every valid
// row's activations to `saved` (kSpill floats a sample), then K1's integrator
// forward (comp, acc, depth, weights, the same bits as K1's) and each
// sample's raw sigma and rgb to `raw` (4 floats a sample) for the
// integrator backward.
template <bool Bf16>
__global__ void __launch_bounds__(kThreads, 1)
level_fwd_spill_kernel(const float* __restrict__ t, const float* __restrict__ rays_d,
                       const float* __restrict__ venc, const float* __restrict__ xenc, Weights w,
                       const __grid_constant__ WeightMaps maps, float* __restrict__ comp,
                       float* __restrict__ acc_out, float* __restrict__ depth, float* __restrict__ weights_out,
                       float* __restrict__ saved, float* __restrict__ raw,
                       int S, int ray_tile, int white_bkgd) {
  extern __shared__ __align__(16) float smem[];
  const ForwardSmem m = carve_forward_smem(smem, S, ray_tile);
  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;

  FwdRing<Bf16> ring(m.ring, maps.m, n_rows);
  view_terms<Bf16>(venc, w.wvb, m.cterm, ray0, ray_tile);
  for (int row0 = 0; row0 < n_rows; row0 += kRows)
    forward_chunk<true, Bf16>(xenc, w, ring, m, row_base, row0, n_rows, S, saved + (row_base + row0) * kSpill);
  // forward_chunk ended with a barrier: sig and rgb are complete
  const float *sig = m.sig, *rgb = m.rgb;
  for (int i = threadIdx.x; i < n_rows; i += kThreads)
    *reinterpret_cast<float4*>(raw + (row_base + i) * 4) = make_float4(sig[i], rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
  integrate_rays<Bf16>(t, rays_d, sig, rgb, ray0, ray_tile, S, white_bkgd, comp, acc_out, depth, weights_out);
  if (threadIdx.x == 0) bulk_wait_all();  // the last chunk's spill has landed
}

// The integrator forward and backward, one warp per ray (kWarps rays a
// block), from the raw sigma and rgb that K1s saved: g_w from the
// cotangents, g_alpha = g_w T - suffix(g_w w) / max(1 - alpha + 1e-10, 1e-10)
// with the suffix sum taken right to left by a warp scan (a direct sum, never
// a difference of prefix sums, which would cancel where v is tiny), and
// g_raw_sigma, g_raw_rgb per sample to `grow`. Each warp keeps its ray's
// (T, g_w, g_w w) in 3 S floats of shared memory between the two sweeps.
__global__ void __launch_bounds__(kThreads)
level_bwd_integrator_kernel(const float* __restrict__ t, const float* __restrict__ rays_d,
                            const float* __restrict__ raw, const float* __restrict__ g_comp,
                            const float* __restrict__ g_acc, const float* __restrict__ g_depth,
                            const float* __restrict__ g_weights, float* __restrict__ grow, int n_rays, int S,
                            int white_bkgd) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= n_rays) return;  // whole warps; no block barrier below
  float* st_ray = smem + (size_t)warp * S * 3;
  const float* rw = raw + (size_t)ray * S * 4;
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
    if (s < S) a = sample_alpha(tr, s, S, dnorm, __ldg(rw + s * 4));
    const float trans = warp_transmittance(a.logv, carry);
    if (s < S) {
      const float wgt = a.alpha * trans;
      const float r0 = sigmoid(__ldg(rw + s * 4 + 1)), r1 = sigmoid(__ldg(rw + s * 4 + 2)),
                  r2 = sigmoid(__ldg(rw + s * 4 + 3));
      float gw = gc0 * r0 + gc1 * r1 + gc2 * r2;
      if (white_bkgd) gw -= gc0 + gc1 + gc2;
      gw += ga + gd * a.ts + __ldg(g_weights + (size_t)ray * S + s);
      gr[s * 4 + 1] = gc0 * wgt * (r0 * (1.f - r0));
      gr[s * 4 + 2] = gc1 * wgt * (r1 * (1.f - r1));
      gr[s * 4 + 3] = gc2 * wgt * (r2 * (1.f - r2));
      float* st = st_ray + s * 3;
      st[0] = trans;
      st[1] = gw;
      st[2] = gw * wgt;
    }
  }
  __syncwarp();
  // Right to left: suffix_i = sum_{j > i} g_w_j w_j, then g_raw_sigma.
  float later = 0.f;  // sum over the 32-sample steps already passed
  for (int s0 = ((S - 1) / 32) * 32; s0 >= 0; s0 -= 32) {
    const int s = s0 + lane;
    const float* st = st_ray + s * 3;
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
      const float raw_sigma = __ldg(rw + s * 4);
      const SampleAlpha a = sample_alpha(tr, s, S, dnorm, raw_sigma);
      const float v = fmaxf(1.f - a.alpha + 1e-10f, 1e-10f);
      const float g_alpha = st[1] * st[0] - suffix / v;
      gr[s * 4] = raw_sigma > 0.f ? g_alpha * a.expterm * a.dist : 0.f;
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 4 : 0;  // n == 0 zero-fills
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(n));
}

// ------------------------------------------------------- pass B1: the deltas

// D[r][c] = (acc + gs[r] wd[c]) * (M[r][c] > 0), the rank-1 term when wd is
// given and the mask when M is; rows below valid_rows also to the scratch
// rows dst + r * kSpill + c. With Bf16 the scratch gets the fp32 delta and D,
// the next product's operand, the delta rounded to bf16, and the rank-1
// product rounds g_raw_sigma. Ends with a barrier.
template <bool Bf16>
__device__ __forceinline__ void store_delta(const ChunkAcc<kWidth>& acc, float* D, const float* M, const float* gs,
                                            const float* __restrict__ wd, float* __restrict__ dst,
                                            int valid_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp >> 2) * 32 + (lane >> 2), c0 = (warp & 3) * 64 + 2 * (lane & 3);
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int c = c0 + 8 * ni;
    float v0 = 0.f, v1 = 0.f;
    if (wd != nullptr) {
      v0 = __ldg(wd + c);
      v1 = __ldg(wd + c + 1);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * mi + 8 * h;
        float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
        if (wd != nullptr) {
          x0 = fmaf(operand<Bf16>(gs[r]), v0, x0);
          x1 = fmaf(operand<Bf16>(gs[r]), v1, x1);
        }
        if (M != nullptr) {
          if (!(M[r * kAct + c] > 0.f)) x0 = 0.f;
          if (!(M[r * kAct + c + 1] > 0.f)) x1 = 0.f;
        }
        *reinterpret_cast<float2*>(D + r * kAct + c) = make_float2(operand<Bf16>(x0), operand<Bf16>(x1));
        if (r < valid_rows) *reinterpret_cast<float2*>(dst + (size_t)r * kSpill + c) = make_float2(x0, x1);
      }
  }
  __syncthreads();
}

// H[r][c] = rows[r * kSpill + c] for c < N and r < valid_rows, else 0, as
// one committed cp.async group.
template <int N>
__device__ __forceinline__ void load_rows(float* H, const float* __restrict__ rows, int valid_rows) {
  constexpr int kVec = N / 4;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const bool valid = r < valid_rows;
    cp_async16(H + r * kAct + c, valid ? rows + (size_t)r * kSpill + c : rows, valid);
  }
  cp_async_commit();
}

// After one of B1's products: this thread's cp.async group (the next saved
// activation H, loaded under the product) has landed, and after the barrier
// every thread's has, and every warp has finished reading D, which the
// epilogue overwrites.
__device__ __forceinline__ void delta_product_done() {
  cp_async_wait<0>();
  __syncthreads();
}

// B1's weight stream: B1Schedule's fp32 flax-layout weights, or in bf16 mode
// their bf16 pack (B1Bf16Schedule).
template <bool Bf16>
using B1Ring = WeightRing<std::conditional_t<Bf16, B1Bf16Schedule, B1Schedule>>;

// acc += D[:, :K] . W^T, W the next product of B1's stream: 3xTF32 through
// gemm_wt in fp32, native bf16 through gemm_bf16 in bf16 mode (D holds the
// rounded delta there).
template <bool Bf16>
__device__ __forceinline__ void delta_product(ChunkAcc<kWidth>& acc, const float* D, int K, B1Ring<Bf16>& ring) {
  if constexpr (Bf16) gemm_bf16<kWidth, kAct, kB1Bf16Run>(acc, D, K, ring);
  else gemm_wt<kWidth, kAct, 4>(acc, D, K, ring);
}

// `maps` holds B1Schedule's weights (wva, wb, w7, w6, w5x, w4, w3, w2, w1)
// in their flax layout, or in bf16 mode B1Bf16Schedule's pack of them (wd
// and wr come rounded to bf16 then).
template <bool Bf16>
__global__ void __launch_bounds__(kThreads, 1)
level_bwd_delta_kernel(const float* __restrict__ venc, const float* __restrict__ wd, const float* __restrict__ wr,
                       const __grid_constant__ WeightMaps maps, const float* __restrict__ saved,
                       const float* __restrict__ grow, float* __restrict__ delta, float* __restrict__ narrow, int S,
                       int ray_tile) {
  extern __shared__ __align__(16) float smem[];
  float* ring_buf = ring_base(smem);                     // the weight ring and its barriers
  float* D = ring_buf + kRingBytes / sizeof(float);      // kRows x kAct: the current delta
  float* H = D + kRows * kAct;                           // kRows x kAct: a saved activation
  float* gc = H + kRows * kAct;                          // ray_tile x kCondWidth: per-ray sum of delta_v
  float* gs = gc + ray_tile * kCondWidth;                // kRows: g_raw_sigma
  float* grgb = gs + kRows;                              // kRows x 3: g_raw_rgb

  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;
  B1Ring<Bf16> ring(ring_buf, maps.m, n_rows);

  for (int i = tid; i < ray_tile * kCondWidth; i += kThreads) gc[i] = 0.f;
  // This thread's head gradients over the block's rows, each chunk's sum
  // added in chunk order: wd[tid]; wr[tid][0..2] (tid < 128); bd (tid 128)
  // or br[tid - 129] (tid 129..131).
  float n_wd = 0.f, n_wr0 = 0.f, n_wr1 = 0.f, n_wr2 = 0.f, n_b = 0.f;

  for (int row0 = 0; row0 < n_rows; row0 += kRows) {
    const int valid_rows = min(kRows, n_rows - row0);
    const float* sv = saved + (row_base + row0) * kSpill;
    float* dv = delta + (row_base + row0) * kSpill;
    const float* gr = grow + (row_base + row0) * 4;
    for (int i = tid; i < kRows * 4; i += kThreads) {
      const int r = i / 4, c = i % 4;
      const float v = r < valid_rows ? gr[i] : 0.f;
      if (c == 0) gs[r] = v; else grgb[r * 3 + c - 1] = v;
    }
    load_rows<kCondWidth>(H, sv + kSpillView, valid_rows);  // hv
    cp_async_wait<0>();
    __syncthreads();

    // Heads: wr += hv^T g_raw_rgb, br, bd.
    if (tid < kCondWidth) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < kRows; ++r) {
        const float h = operand<Bf16>(H[r * kAct + tid]);
        s0 = fmaf(h, operand<Bf16>(grgb[r * 3]), s0);
        s1 = fmaf(h, operand<Bf16>(grgb[r * 3 + 1]), s1);
        s2 = fmaf(h, operand<Bf16>(grgb[r * 3 + 2]), s2);
      }
      n_wr0 += s0;
      n_wr1 += s1;
      n_wr2 += s2;
    } else if (tid == kCondWidth) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += gs[r];
      n_b += s;
    } else if (tid < kCondWidth + 4) {
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s += grgb[r * 3 + tid - kCondWidth - 1];
      n_b += s;
    }
    // delta_v = (g_raw_rgb . wr^T) * (hv > 0) -> D[:, :128]
    for (int i = tid; i < kRows * kCondWidth; i += kThreads) {
      const int r = i / kCondWidth, c = i % kCondWidth;
      const float g = operand<Bf16>(grgb[r * 3]) * __ldg(wr + c * 3) +
                      operand<Bf16>(grgb[r * 3 + 1]) * __ldg(wr + c * 3 + 1) +
                      operand<Bf16>(grgb[r * 3 + 2]) * __ldg(wr + c * 3 + 2);
      D[r * kAct + c] = H[r * kAct + c] > 0.f ? g : 0.f;
    }
    __syncthreads();
    // The per-ray sum of delta_v for wvb (one thread per column, rows in
    // order), and delta_v to the scratch.
    if (tid < kCondWidth) {
      for (int r = 0; r < valid_rows; ++r) gc[((row0 + r) / S) * kCondWidth + tid] += D[r * kAct + tid];
    }
    for (int i = tid; i < valid_rows * (kCondWidth / 4); i += kThreads) {
      const int r = i / (kCondWidth / 4), c = (i % (kCondWidth / 4)) * 4;
      *reinterpret_cast<float4*>(dv + (size_t)r * kSpill + kSpillView + c) =
          *reinterpret_cast<const float4*>(D + r * kAct + c);
    }
    if constexpr (Bf16) {  // the product's operand: delta_v rounded, once the fp32 reads above are done
      __syncthreads();
      for (int i = tid; i < kRows * kCondWidth; i += kThreads) {
        float* x = D + (i / kCondWidth) * kAct + i % kCondWidth;
        *x = round_bf16(*x);
      }
      __syncthreads();
    }
    load_rows<kWidth>(H, sv + 7 * kWidth, valid_rows);  // h7, lands under the product
    ChunkAcc<kWidth> acc;
    zero_acc(acc);  // g_btl = delta_v . wva^T
    delta_product<Bf16>(acc, D, kCondWidth, ring);
    delta_product_done();
    store_delta<Bf16>(acc, D, nullptr, nullptr, nullptr, dv + kSpillBtl, valid_rows);
    {  // density head: wd += h7^T g_raw_sigma
      float s = 0.f;
      for (int r = 0; r < kRows; ++r) s = fmaf(operand<Bf16>(H[r * kAct + tid]), operand<Bf16>(gs[r]), s);
      n_wd += s;
    }
    zero_acc(acc);  // delta_7 = (g_btl . wb^T + g_raw_sigma wd^T) * (h7 > 0)
    delta_product<Bf16>(acc, D, kWidth, ring);
    delta_product_done();
    store_delta<Bf16>(acc, D, H, gs, wd, dv + 7 * kWidth, valid_rows);
    for (int l = 6; l >= 0; --l) {  // delta_l = (delta_{l+1} . W_{l+1}^T) * (h_l > 0), W_5 = w5x
      load_rows<kWidth>(H, sv + l * kWidth, valid_rows);
      zero_acc(acc);
      delta_product<Bf16>(acc, D, kWidth, ring);
      delta_product_done();
      store_delta<Bf16>(acc, D, H, nullptr, nullptr, dv + l * kWidth, valid_rows);
    }
  }

  float* nw = narrow + (size_t)blockIdx.x * kNarrowFloats;
  nw[kNarrowWd + tid] = n_wd;
  if (tid < kCondWidth) {
    nw[kNarrowWr + tid * 3] = n_wr0;
    nw[kNarrowWr + tid * 3 + 1] = n_wr1;
    nw[kNarrowWr + tid * 3 + 2] = n_wr2;
  } else if (tid == kCondWidth) {
    nw[kNarrowBd] = n_b;
  } else if (tid < kCondWidth + 4) {
    nw[kNarrowBr + tid - kCondWidth - 1] = n_b;
  }
  // wvb = venc^T (per-ray sum of delta_v); the last chunk's barriers ordered gc.
  for (int i = tid; i < kView * kCondWidth; i += kThreads) {
    const int k = i / kCondWidth, n = i % kCondWidth;
    float s = 0.f;
    for (int g = 0; g < ray_tile; ++g)
      s = fmaf(operand<Bf16>(__ldg(venc + (size_t)(ray0 + g) * kView + k)), operand<Bf16>(gc[g * kCondWidth + n]), s);
    nw[kNarrowWvb + i] = s;
  }
}

// ------------------------------------------------ pass B2: the weight products

// Block b of either B2 kernel: row range q = b / kDwTiles, tile b % kDwTiles
// in product order (within a product, the M tiles of one column tile are
// neighbours, so the blocks that read the same delta rows run together). The
// block sums rows [lo, hi) of the range into its tile and writes the tile,
// and the bias tile when it holds the first M rows, once to range q's partial
// set.
struct DwBlock {
  DwProduct P;
  int q, m0, n0, lo, hi;
  bool with_bias;
};
__device__ __forceinline__ DwBlock dw_block(int n_total, int rows_per_range) {
  DwBlock b;
  int tile = blockIdx.x % kDwTiles;
  b.q = blockIdx.x / kDwTiles;
  int p = 0;
  while (tile >= product_tiles(c_products[p])) tile -= product_tiles(c_products[p++]);
  b.P = c_products[p];
  const int mt = m_tiles(b.P);
  b.m0 = (tile % mt) * kDwM;
  b.n0 = (tile / mt) * kDwN;
  b.lo = min(n_total, b.q * rows_per_range);
  b.hi = min(n_total, b.lo + rows_per_range);
  b.with_bias = b.P.bias >= 0 && b.m0 == 0;
  return b;
}

// The bf16 B2's tile sums (warp w: rows 32 (w / 4) + [0, 32), columns 32 (w
// % 4) + [0, 32), as 2 x 4 m16n8 accumulators) to range q's partial set.
__device__ __forceinline__ void store_dw_tile(const DwBlock& B, const float (&tot)[2][4][4], float* partials) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr0 = (warp >> 2) * 32, wc0 = (warp & 3) * 32;
  float* gw = partials + (size_t)B.q * kPartialFloats + c_layout.off[B.P.grad];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = B.m0 + wr0 + 16 * mi + 8 * h + g;
      if (m >= B.P.K) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = B.n0 + wc0 + 8 * ni + 2 * t;
        *reinterpret_cast<float2*>(gw + (size_t)m * B.P.N + n) = make_float2(tot[mi][ni][2 * h], tot[mi][ni][2 * h + 1]);
      }
    }
}

// Both B2 kernels' tensor maps over `saved` (h) and `delta` (d): n_total
// rows of kSpill fp32 columns, rows past n_total (and columns past kSpill)
// read as zeros.
struct DwMaps {
  CUtensorMap h;
  CUtensorMap d;
};

// Each thread's cp.async copies issued so far arrive, once they have landed,
// on the barrier (one of the arrivals its count expects).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// B2 in fp32: 3xTF32 mma.sync, the tile's sums in registers across the
// range. A block whose H is a saved layer has thread 0 load, by TMA, each
// stage's kDwRows rows of H (a box kDwHs columns wide from column m0) and of
// Delta (kDwDs wide from n0) into the next slot of a ring of kDwStages
// stages, each with a full barrier that takes the stage's bytes. The boxes
// are 8 columns wider than the tile, so TMA's dense rows land at padded
// strides; the 8 columns past the tile (the next columns of the row, or
// zeros past kSpill) are never read. The tiles whose H is xenc (w0, w5i)
// stage by cp.async (xenc's 63-float rows are no TMA box; the pad column
// zeroed), each thread's copies arriving on the same full barrier. Rows at
// or past hi read as zeros: TMA fills rows past n_total, and only the last
// range ends before its last step does.
//
// Once stage s has landed, and after a barrier by which every warp has left
// stage s - 1 (whose slot thread 0 then refills with stage s + kDwStages -
// 1, so the ring needs no empty barrier), one pass splits the stage's H
// into TF32 pairs (split_tf32, the same bits wherever it runs) in the order
// the warps read A's fragments, each value once where every warp that reads
// it split it in the parent; a second barrier, then the stage's products.
// Warp w owns rows 32 (w / 4) + [0, 32) and columns 32 (w % 4) + [0, 32) of
// the tile, as 2 x 4 m16n8 tiles, with the m16 tiles' rows and the n8
// tiles' columns interleaved so that every fragment read is 16 bytes: lane
// (g, t) takes A of m16 tile mi (row g: H column wr0 + 4g + 2mi; row g + 8:
// column wr0 + 4g + 2mi + 1) as two uint4 of pairs a k8 step, and B of n8
// tile ni (column g: Delta column wc0 + 4g + ni) as the float4s of Delta
// columns wc0 + 4g + [0, 4) in rows kk + t and kk + t + 4, split in
// registers. The 8 lanes of a quarter warp read 16 consecutive bytes each
// (the pairs) or start 8t + 4g floats apart mod 32 (Delta at stride kDwDs):
// conflict-free. Each element of dW still sums the products of the same rows
// at the same positions of the same k8 steps, mma after mma, into a fresh
// accumulator a kDwStep-row step, as before; only its place in an mma tile
// moved. Lane (g, t) ends holding dW rows wr0 + 4g + [0, 4) x columns wc0 +
// 8t + [0, 8).
__global__ void __launch_bounds__(kThreads, 2)
level_bwd_dw_kernel(const __grid_constant__ DwMaps maps, const float* __restrict__ xenc,
                    const float* __restrict__ delta, float* __restrict__ partials, int n_total,
                    int rows_per_range) {
  extern __shared__ __align__(16) float smem[];
  float* ring = ring_base(smem);  // kDwStages stages
  uint32_t* hsp = reinterpret_cast<uint32_t*>(ring + kDwStages * kDwStageFloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(hsp + kDwSplitWords);
  const DwBlock B = dw_block(n_total, rows_per_range);
  const DwProduct& P = B.P;
  const bool tma = P.h_off != kX;
  const int lo = B.lo, hi = B.hi;
  constexpr int kPerStep = kDwStep / kDwRows;
  const int n_groups = hi > lo ? (hi - lo + kDwStep - 1) / kDwStep : 0;
  const int n_stages = n_groups * kPerStep;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDwStages; ++i) mbar_init(&full[i], tma ? 1 : kThreads);
    mbar_init_fence();
  }
  __syncthreads();

  // Stage t's rows into ring slot t % kDwStages: by TMA from thread 0, or,
  // for xenc's tiles, by cp.async from every thread, each thread's copies
  // arriving on the slot's barrier (nothing past the range).
  auto stage = [&](int t) {
    if (t >= n_stages) return;
    const int slot = t % kDwStages;
    float* hs = ring + slot * kDwStageFloats;
    float* ds = hs + kDwRows * kDwHs;
    const int s0 = lo + t * kDwRows;
    if (tma) {
      if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&full[slot], kDwStageBytes);
        tma_load_2d(hs, &maps.h, &full[slot], P.h_off + B.m0, s0);
        tma_load_2d(ds, &maps.d, &full[slot], P.d_off + B.n0, s0);
      }
      return;
    }
    for (int i = threadIdx.x; i < kDwRows * kDwM; i += kThreads) {
      const int r = i / kDwM, c = i % kDwM;
      const bool valid = s0 + r < hi && c < kPos;
      cp_async4(hs + r * kDwHs + c, valid ? xenc + (size_t)(s0 + r) * kPos + c : xenc, valid);
    }
    for (int i = threadIdx.x; i < kDwRows * (kDwN / 4); i += kThreads) {
      const int r = i / (kDwN / 4), c = (i % (kDwN / 4)) * 4;
      const bool valid = s0 + r < hi;
      cp_async16(ds + r * kDwDs + c, valid ? delta + (size_t)(s0 + r) * kSpill + P.d_off + B.n0 + c : delta, valid);
    }
    cp_async_arrive(&full[slot]);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr0 = (warp >> 2) * 32, wc0 = (warp & 3) * 32;
  const int b_off = t * kDwDs + wc0 + 4 * g;

  // Stage s's H split into hsp, [k8 step][row half][big of m16 tile 0, its
  // small, big of 1, small][lane][4]: thread i the fragments of lane i % 32
  // of the warps on row half (i / 32) % 2 in k8 step i / 64.
  auto split_h = [&](int s) {
    const int ks = threadIdx.x >> 6, half = (threadIdx.x >> 5) & 1;
    const float* p = ring + (s % kDwStages) * kDwStageFloats + (ks * 8 + t) * kDwHs + half * 32 + 4 * g;
    const float4 lo4 = *reinterpret_cast<const float4*>(p);
    const float4 hi4 = *reinterpret_cast<const float4*>(p + 4 * kDwHs);
    uint32_t big[2][4], small[2][4];
    split_tf32(lo4.x, big[0][0], small[0][0]);
    split_tf32(lo4.y, big[0][1], small[0][1]);
    split_tf32(hi4.x, big[0][2], small[0][2]);
    split_tf32(hi4.y, big[0][3], small[0][3]);
    split_tf32(lo4.z, big[1][0], small[1][0]);
    split_tf32(lo4.w, big[1][1], small[1][1]);
    split_tf32(hi4.z, big[1][2], small[1][2]);
    split_tf32(hi4.w, big[1][3], small[1][3]);
    uint32_t* q = hsp + ((ks * 2 + half) * 4) * 128 + lane * 4;
    *reinterpret_cast<uint4*>(q) = make_uint4(big[0][0], big[0][1], big[0][2], big[0][3]);
    *reinterpret_cast<uint4*>(q + 128) = make_uint4(small[0][0], small[0][1], small[0][2], small[0][3]);
    *reinterpret_cast<uint4*>(q + 256) = make_uint4(big[1][0], big[1][1], big[1][2], big[1][3]);
    *reinterpret_cast<uint4*>(q + 384) = make_uint4(small[1][0], small[1][1], small[1][2], small[1][3]);
  };

  // Stage s's products into part, and this thread's bias column into b.
  auto multiply = [&](int s, float (&part)[2][4][4], float& b) {
    const float* ds = ring + (s % kDwStages) * kDwStageFloats + kDwRows * kDwHs;
    const uint32_t* hq = hsp + ((warp >> 2) * 4) * 128 + lane * 4;
#pragma unroll
    for (int kk = 0; kk < kDwRows; kk += 8) {
      uint32_t ab[2][4], as[2][4];
      const uint32_t* q = hq + (kk / 8) * 2 * 4 * 128;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint4 vb = *reinterpret_cast<const uint4*>(q + 256 * mi);
        const uint4 vs = *reinterpret_cast<const uint4*>(q + 256 * mi + 128);
        ab[mi][0] = vb.x, ab[mi][1] = vb.y, ab[mi][2] = vb.z, ab[mi][3] = vb.w;
        as[mi][0] = vs.x, as[mi][1] = vs.y, as[mi][2] = vs.z, as[mi][3] = vs.w;
      }
      const float4 b_lo = *reinterpret_cast<const float4*>(ds + kk * kDwDs + b_off);
      const float4 b_hi = *reinterpret_cast<const float4*>(ds + (kk + 4) * kDwDs + b_off);
      const float bl[4] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w}, bh[4] = {b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        uint32_t bb[2], bs[2];
        split_tf32(bl[ni], bb[0], bs[0]);
        split_tf32(bh[ni], bb[1], bs[1]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_3xtf32(part[mi][ni], ab[mi], as[mi], bb, bs);
      }
    }
    if (B.with_bias && threadIdx.x < kDwN) {
      for (int r = 0; r < kDwRows; ++r) b += ds[r * kDwDs + threadIdx.x];
    }
  };

  float tot[2][4][4];
  zero_acc(tot);
  float bsum = 0.f;
#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) stage(s);
  for (int grp = 0; grp < n_groups; ++grp) {
    float part[2][4][4];
    zero_acc(part);
    float b = 0.f;
#pragma unroll
    for (int h = 0; h < kPerStep; ++h) {
      const int s = grp * kPerStep + h;
      mbar_wait(&full[s % kDwStages], (s / kDwStages) & 1);
      __syncthreads();  // no warp still reads stage s - 1 or the split buffer
      stage(s + kDwStages - 1);  // into the slot stage s - 1 left
      split_h(s);
      __syncthreads();  // the split is complete
      multiply(s, part, b);
    }
    add_into(tot, part);
    bsum += b;
  }

  float* gw = partials + (size_t)B.q * kPartialFloats + c_layout.off[P.grad];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = B.m0 + wr0 + 4 * g + 2 * mi + h;
      if (m >= P.K) continue;
      float* row = gw + (size_t)m * P.N + B.n0 + wc0 + 8 * t;
      *reinterpret_cast<float4*>(row) =
          make_float4(tot[mi][0][2 * h], tot[mi][1][2 * h], tot[mi][2][2 * h], tot[mi][3][2 * h]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(tot[mi][0][2 * h + 1], tot[mi][1][2 * h + 1], tot[mi][2][2 * h + 1], tot[mi][3][2 * h + 1]);
    }
  if (B.with_bias && threadIdx.x < kDwN)
    partials[(size_t)B.q * kPartialFloats + c_layout.off[P.bias] + B.n0 + threadIdx.x] = bsum;
}

// B2 in bf16 mode: the same tiles, ranges and partial sets as the fp32 B2,
// on native bf16 products. A step is 32 rows. A block whose H is a saved
// layer has thread 0 load, by TMA, the step's H rows (32 x 64) and Delta
// rows (32 x 128) into a ring of kDw16Stages fp32 stages, each with a full
// barrier that takes the stage's 24,576 bytes. A stage is refilled only
// after the barrier that ends the pass that read it, so it needs no empty
// barrier. The tiles whose H is xenc (w0, w5i) stage by cp.async (xenc's
// 63-float rows are no TMA box), one committed group a step, the pad
// column zeroed. Once a step has landed, one pass rounds each value to bf16
// (cvt.rn: to nearest, ties to even) into the step's bf16 tile, in the
// layout ldmatrix reads, and adds the fp32 deltas of the bias tile into
// each thread's running column sums; the warps then run the step's two k16
// slices on mma.sync m16n8k16 bf16, A = H^T and B = Delta each loaded by
// ldmatrix.trans from their [row][col] tiles. Each step's products go to a
// fresh accumulator that an fp32 add folds into the tile's sum (the tensor
// cores truncate as they accumulate). The bias tile: thread i sums columns
// 4 (i % 32) + [0, 4) over the rows (i / 32) + 8 j of every step in order;
// the eight row groups' sums are then added in group order. Steps end on
// multiples of 32 rows (rows_per_range is a multiple of 64), so only the
// last range's last step runs past its rows, into rows TMA reads as zeros
// (past n_total) or cp.async zero-fills.
constexpr int kDw16StageBytes = kDw16Stage * (int)sizeof(float);

// Four 8x8 16-bit matrices, transposed: lanes 8j .. 8j + 7 give matrix j's
// row addresses (16 bytes each), and r[j] gets element (2 (lane % 4) + e,
// lane / 4) of matrix j in its half e.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
level_bwd_dw_bf16_kernel(const __grid_constant__ DwMaps maps, const float* __restrict__ xenc,
                         const float* __restrict__ delta, float* __restrict__ partials, int n_total,
                         int rows_per_range) {
  extern __shared__ __align__(16) float smem[];
  float* ring = ring_base(smem);                                                // kDw16Stages fp32 stages
  uint16_t* hb = reinterpret_cast<uint16_t*>(ring + kDw16Stages * kDw16Stage);  // kDw16Step x kDw16Hs bf16
  uint16_t* db = hb + kDw16Step * kDw16Hs;                                      // kDw16Step x kDw16Ds bf16
  uint64_t* full = reinterpret_cast<uint64_t*>(db + kDw16Step * kDw16Ds);       // kDw16Stages
  const DwBlock B = dw_block(n_total, rows_per_range);
  const DwProduct& P = B.P;
  const bool tma = P.h_off != kX;
  const int lo = B.lo, hi = B.hi;
  const int n_steps = hi > lo ? (hi - lo + kDw16Step - 1) / kDw16Step : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kDw16Stages; ++i) mbar_init(&full[i], 1);
    mbar_init_fence();
  }
  __syncthreads();

  // Step t's fp32 rows into ring slot t % kDw16Stages: by TMA from thread 0,
  // or, for xenc's tiles, by cp.async from every thread, one committed group
  // a step (empty past the range).
  auto stage = [&](int t) {
    const int slot = t % kDw16Stages;
    float* hs = ring + slot * kDw16Stage;
    float* ds = hs + kDw16Step * kDwM;
    const int s0 = lo + t * kDw16Step;
    if (tma) {
      if (threadIdx.x == 0 && t < n_steps) {
        mbar_arrive_expect_tx(&full[slot], kDw16StageBytes);
        tma_load_2d(hs, &maps.h, &full[slot], P.h_off + B.m0, s0);
        tma_load_2d(ds, &maps.d, &full[slot], P.d_off + B.n0, s0);
      }
      return;
    }
    if (t < n_steps) {
      for (int i = threadIdx.x; i < kDw16Step * kDwM; i += kThreads) {
        const int r = i / kDwM, c = i % kDwM;
        const bool valid = s0 + r < hi && c < kPos;
        cp_async4(hs + r * kDwM + c, valid ? xenc + (size_t)(s0 + r) * kPos + c : xenc, valid);
      }
      for (int i = threadIdx.x; i < kDw16Step * (kDwN / 4); i += kThreads) {
        const int r = i / (kDwN / 4), c = (i % (kDwN / 4)) * 4;
        const bool valid = s0 + r < hi;
        cp_async16(ds + r * kDwN + c, valid ? delta + (size_t)(s0 + r) * kSpill + P.d_off + B.n0 + c : delta, valid);
      }
    }
    cp_async_commit();
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr0 = (warp >> 2) * 32, wc0 = (warp & 3) * 32;
  // ldmatrix row addresses: A's matrices (k 0-7 | 8-15) x (m 0-7 | 8-15) in
  // the order a[0..3] takes them, B's (k 0-7 | 8-15) x (n 0-7 | 8-15) as b0,
  // b1 of two neighbouring n8 tiles.
  const uint16_t* pa = hb + ((lane & 7) + ((lane >> 4) << 3)) * kDw16Hs + wr0 + (((lane >> 3) & 1) << 3);
  const uint16_t* pb = db + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kDw16Ds + wc0 + ((lane >> 4) << 3);
  float tot[2][4][4];
  zero_acc(tot);
  float bias[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int t = 0; t < kDw16Stages - 1; ++t) stage(t);
  for (int s = 0; s < n_steps; ++s) {
    const int slot = s % kDw16Stages;
    if (tma) {
      mbar_wait(&full[slot], (s / kDw16Stages) & 1);  // step s has landed
    } else {
      cp_async_wait<kDw16Stages - 2>();  // this thread's copies of step s have landed
    }
    __syncthreads();  // (everyone's copies have landed,) and no warp still reads the bf16 tile of step s - 1
    {
      const float* hs = ring + slot * kDw16Stage;
      const float* ds = hs + kDw16Step * kDwM;
#pragma unroll
      for (int i = 0; i < kDw16Step * kDwM / (4 * kThreads); ++i) {
        const int r = (threadIdx.x >> 4) + (kThreads / 16) * i, c = (threadIdx.x & 15) * 4;
        const float4 v = *reinterpret_cast<const float4*>(hs + r * kDwM + c);
        *reinterpret_cast<uint2*>(hb + r * kDw16Hs + c) = make_uint2(bf16x2_rn(v.x, v.y), bf16x2_rn(v.z, v.w));
      }
#pragma unroll
      for (int i = 0; i < kDw16Step * kDwN / (4 * kThreads); ++i) {
        const int r = (threadIdx.x >> 5) + (kThreads / 32) * i, c = (threadIdx.x & 31) * 4;
        const float4 v = *reinterpret_cast<const float4*>(ds + r * kDwN + c);
        if (B.with_bias) {
          bias[0] += v.x;
          bias[1] += v.y;
          bias[2] += v.z;
          bias[3] += v.w;
        }
        *reinterpret_cast<uint2*>(db + r * kDw16Ds + c) = make_uint2(bf16x2_rn(v.x, v.y), bf16x2_rn(v.z, v.w));
      }
    }
    __syncthreads();  // the bf16 tile of step s is complete, and every thread is done with slot s
    stage(s + kDw16Stages - 1);  // into the slot step s - 1 left
    float part[2][4][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < kDw16Step; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldmatrix_x4_trans(a[mi], pa + kk * kDw16Hs + 16 * mi);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) ldmatrix_x4_trans(b[nj], pb + kk * kDw16Ds + 16 * nj);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(part[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
    }
    add_into(tot, part);
  }
  if (!tma) cp_async_wait<0>();  // the groups left are empty

  store_dw_tile(B, tot, partials);
  if (B.with_bias) {  // the same for the whole block
    __syncthreads();  // the ring is free: every copy has landed and been read
    float* red = ring;  // (kThreads / 32) row groups x kDwN
    *reinterpret_cast<float4*>(red + warp * kDwN + lane * 4) = make_float4(bias[0], bias[1], bias[2], bias[3]);
    __syncthreads();
    if (threadIdx.x < kDwN) {
      float b = 0.f;
      for (int grp = 0; grp < kThreads / 32; ++grp) b += red[grp * kDwN + threadIdx.x];
      partials[(size_t)B.q * kPartialFloats + c_layout.off[P.bias] + B.n0 + threadIdx.x] = b;
    }
  }
}

// B2's maps over `saved` and `delta`, boxes of h_cols (saved) and d_cols
// (delta) columns x rows rows. Returns 0, or kMapError + the driver's
// CUresult.
int encode_dw_maps(DwMaps& maps, const float* saved, const float* delta, int n_total, int h_cols, int d_cols,
                   int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)kSpill, (cuuint64_t)n_total};
  const cuuint64_t strides[1] = {(cuuint64_t)kSpill * sizeof(float)};
  const cuuint32_t unit[2] = {1, 1};
  const cuuint32_t box_h[2] = {(cuuint32_t)h_cols, (cuuint32_t)rows};
  const cuuint32_t box_d[2] = {(cuuint32_t)d_cols, (cuuint32_t)rows};
  CUresult r = encode(&maps.h, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(saved), dims, strides, box_h,
                      unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kMapError + (int)r;
  r = encode(&maps.d, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(delta), dims, strides, box_d, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// ------------------------------------------------------------- the reduction

// Where gradient g sits in a B1 block's narrow set, or -1 for the gradients
// of pass B2.
__device__ __forceinline__ int narrow_offset(int g) {
  return g == G_WD ? kNarrowWd : g == G_BD ? kNarrowBd : g == G_WR ? kNarrowWr : g == G_BR ? kNarrowBr
       : g == G_WVB ? kNarrowWvb : -1;
}

// out[i]: the row ranges' partials (pass B2's gradients) or the B1 blocks'
// narrow partials (the heads), each summed in a fixed order; 0 in the
// padding between gradients.
__global__ void level_bwd_reduce_kernel(const float* __restrict__ partials, const float* __restrict__ narrow,
                                        int n_blocks, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kPartialFloats) return;
  int g = 0;
  while (c_layout.off[g + 1] <= i) ++g;
  const int local = i - c_layout.off[g];
  float s = 0.f;
  if (local < c_layout.size[g]) {
    const int nidx = narrow_offset(g);
    if (nidx >= 0) {
      for (int b = 0; b < n_blocks; ++b) s += narrow[(size_t)b * kNarrowFloats + nidx + local];
    } else {
      for (int q = 0; q < kRanges; ++q) s += partials[(size_t)q * kPartialFloats + i];
    }
  }
  out[i] = s;
}

size_t delta_smem_bytes(int ray_tile) {
  return kRingAlign + kRingBytes +
         sizeof(float) * (2 * (size_t)kRows * kAct + (size_t)ray_tile * kCondWidth + 4 * (size_t)kRows);
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

bool bad_shape(int n_rays, int S, int ray_tile) {
  return n_rays <= 0 || S <= 0 || ray_tile <= 0 || n_rays % ray_tile != 0;
}

int launch_fwd_spill(const float* t, const float* rays_d, const float* venc, const float* xenc, const Weights& w,
                     const void* wt, float* comp, float* acc, float* depth, float* weights, float* saved, float* raw,
                     int n_rays, int S, int ray_tile, int white_bkgd, int dot_bf16, cudaStream_t s) {
  const size_t smem = forward_smem_bytes(S, ray_tile);
  auto* kernel = dot_bf16 ? level_fwd_spill_kernel<true> : level_fwd_spill_kernel<false>;
  cudaError_t err = set_smem((const void*)kernel, smem);
  if (err != cudaSuccess) return err;
  WeightMaps maps;
  if (int map_err = encode_forward_maps(maps, wt, dot_bf16 != 0)) return map_err;
  kernel<<<n_rays / ray_tile, kThreads, smem, s>>>(t, rays_d, venc, xenc, w, maps, comp, acc, depth, weights, saved,
                                                   raw, S, ray_tile, white_bkgd);
  return cudaGetLastError();
}

int launch_bwd_saved(const float* t, const float* rays_d, const float* venc, const float* xenc,
                     const Weights& w, const void* b1_pack, const float* g_comp, const float* g_acc,
                     const float* g_depth, const float* g_weights, const float* saved, const float* raw, float* grow,
                     float* delta, float* partials, float* narrow, float* out, int n_rays, int S, int ray_tile,
                     int white_bkgd, int dot_bf16, cudaStream_t s) {
  if (dot_bf16 && b1_pack == nullptr) return cudaErrorInvalidValue;
  const size_t smem_i = sizeof(float) * kWarps * 3 * (size_t)S, smem_b1 = delta_smem_bytes(ray_tile);
  auto* b1 = dot_bf16 ? level_bwd_delta_kernel<true> : level_bwd_delta_kernel<false>;
  const void* b2 = dot_bf16 ? (const void*)level_bwd_dw_bf16_kernel : (const void*)level_bwd_dw_kernel;
  const size_t smem_b2 = dot_bf16 ? kDw16SmemBytes : kDwSmemBytes;
  cudaError_t err = set_smem((const void*)level_bwd_integrator_kernel, smem_i);
  if (err != cudaSuccess) return err;
  if ((err = set_smem((const void*)b1, smem_b1)) != cudaSuccess) return err;
  if ((err = set_smem(b2, smem_b2)) != cudaSuccess) return err;
  WeightMaps maps;
  const void* b1_weights[B1Schedule::kProducts] = {w.wva, w.wb, w.w7, w.w6, w.w5x, w.w4, w.w3, w.w2, w.w1};
  if (int map_err = dot_bf16 ? encode_packed_maps<B1Bf16Schedule>(maps, b1_pack)
                             : encode_weight_maps<B1Schedule>(maps, b1_weights))
    return map_err;
  const int n_blocks = n_rays / ray_tile;
  const int n_total = n_rays * S;
  // Whole kDwStep steps per range; the last ranges may be short or empty.
  const int rows_per_range = ((n_total + kRanges - 1) / kRanges + kDwStep - 1) / kDwStep * kDwStep;
  level_bwd_integrator_kernel<<<(n_rays + kWarps - 1) / kWarps, kThreads, smem_i, s>>>(
      t, rays_d, raw, g_comp, g_acc, g_depth, g_weights, grow, n_rays, S, white_bkgd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  b1<<<n_blocks, kThreads, smem_b1, s>>>(venc, w.wd, w.wr, maps, saved, grow, delta, narrow, S, ray_tile);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  DwMaps dw_maps;
  if (int map_err = dot_bf16 ? encode_dw_maps(dw_maps, saved, delta, n_total, kDwM, kDwN, kDw16Step)
                             : encode_dw_maps(dw_maps, saved, delta, n_total, kDwHs, kDwDs, kDwRows))
    return map_err;
  if (dot_bf16) {
    level_bwd_dw_bf16_kernel<<<kRanges * kDwTiles, kThreads, smem_b2, s>>>(dw_maps, xenc, delta, partials, n_total,
                                                                            rows_per_range);
  } else {
    level_bwd_dw_kernel<<<kRanges * kDwTiles, kThreads, smem_b2, s>>>(dw_maps, xenc, delta, partials, n_total,
                                                                       rows_per_range);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  level_bwd_reduce_kernel<<<(kPartialFloats + kThreads - 1) / kThreads, kThreads, 0, s>>>(partials, narrow,
                                                                                          n_blocks, out);
  return cudaGetLastError();
}

}  // namespace

#define AONERF_WEIGHT_PARAMS                                                                              \
  const float *w0, const float *b0, const float *w1, const float *b1, const float *w2, const float *b2,     \
      const float *w3, const float *b3, const float *w4, const float *b4, const float *w5x,                 \
      const float *w5i, const float *b5, const float *w6, const float *b6, const float *w7,                 \
      const float *b7, const float *wd, const float *bd, const float *wb, const float *bb,                  \
      const float *wva, const float *wvb, const float *bv, const float *wr, const float *br
#define AONERF_WEIGHTS \
  Weights { w0, b0, w1, b1, w2, b2, w3, b3, w4, b4, w5x, w5i, b5, w6, b6, w7, b7, wd, bd, wb, bb, wva, wvb, bv, wr, br }

extern "C" {

// Floats of the output (and of one row range's partial set): the 26
// gradients in the order of the arguments below, each padded to 4 floats.
int aonerf_fused_level_bwd_partial_floats() { return kPartialFloats; }

// Floats per sample of the scratches `saved` and `delta`.
int aonerf_fused_level_bwd_saved_floats() { return kSpill; }

// Row ranges of pass B2 (partial sets of the scratch `partials`), and floats
// of one B1 block's narrow set (scratch `narrow`).
int aonerf_fused_level_bwd_ranges() { return kRanges; }
int aonerf_fused_level_bwd_narrow_floats() { return kNarrowFloats; }

// Floats of the forward's packed transposed product weights `wt` (FwdSchedule),
// and bytes of their bf16 pack (FwdBf16Schedule), which bf16 mode takes.
int aonerf_fused_level_wt_floats() { return kWtFloats; }
int aonerf_fused_level_wt_bf16_bytes() {
  return schedule_floats<FwdBf16Schedule>() * (int)sizeof(FwdBf16Schedule::Elem);
}

// Shared memory of K1s' block of ray_tile rays of S samples.
int aonerf_fused_level_fwd_smem_bytes(int S, int ray_tile) { return (int)forward_smem_bytes(S, ray_tile); }

// Shared memory of B1's block of ray_tile rays, the one block of the
// backward whose size the tile sets (the same at every S: B1 keeps chunks of
// kRows rows and per-ray sums).
int aonerf_fused_level_bwd_smem_bytes(int /*S*/, int ray_tile) { return (int)delta_smem_bytes(ray_tile); }

// Bytes of B1's bf16 pack (B1Bf16Schedule), which bf16 mode takes.
int aonerf_fused_level_b1_bf16_bytes() {
  return schedule_floats<B1Bf16Schedule>() * (int)sizeof(B1Bf16Schedule::Elem);
}

// K1s, the training forward, on `stream`. Pointers are device pointers to
// contiguous fp32 arrays: the level's inputs, its 26 weights in the flax
// (in, out) layout and `wt`, the packed transposed product weights
// (FwdSchedule, kWtFloats fp32; in bf16 mode their bf16 pack), as for
// aonerf_fused_render_level; its outputs comp (R,3), acc (R), depth (R),
// weights (R,S); and what the backward reads, `saved` (R*S*kSpill, the
// activations) and `raw` (R*S*4: raw sigma, raw rgb). With dot_bf16 != 0,
// the bf16 mode, on narrow heads (wd, wr, wvb) already rounded to bf16.
// n_rays % ray_tile == 0. Returns the launch's error (0 on success), or
// kMapError + the driver's CUresult if a tensor map was refused.
int aonerf_fused_level_fwd_spill(const float* t, const float* rays_d, const float* venc, const float* xenc,
                                 AONERF_WEIGHT_PARAMS, const void* wt, float* comp, float* acc, float* depth,
                                 float* weights, float* saved, float* raw, int n_rays, int S, int ray_tile,
                                 int white_bkgd, int dot_bf16, void* stream) {
  if (bad_shape(n_rays, S, ray_tile)) return cudaErrorInvalidValue;
  return launch_fwd_spill(t, rays_d, venc, xenc, AONERF_WEIGHTS, wt, comp, acc, depth, weights, saved, raw, n_rays, S,
                          ray_tile, white_bkgd, dot_bf16, static_cast<cudaStream_t>(stream));
}

// The level's weight gradient from what K1s saved, on `stream`: the
// integrator backward, B1, B2 and the reduction. Inputs as for K1s, plus
// `b1_pack` (B1's bf16 pack in bf16 mode, else unused), the cotangents g_comp
// (R,3), g_acc (R), g_depth (R), g_weights (R,S) and K1s' `saved` and `raw`;
// scratch `grow` (R*S*4), `delta` (R*S*kSpill), `partials` (kRanges *
// kPartialFloats) and `narrow` ((R/ray_tile) * kNarrowFloats); the output
// `out` (kPartialFloats). With dot_bf16 != 0, the bf16 mode: B1 reads its
// products' weights from `b1_pack` and wd, wr (already rounded to bf16), and
// no other weight. Returns the first launch error (0 on success), or
// kMapError + the CUresult of cuTensorMapEncodeTiled if a tensor map was
// refused.
int aonerf_fused_level_bwd_saved(const float* t, const float* rays_d, const float* venc, const float* xenc,
                                 AONERF_WEIGHT_PARAMS, const void* b1_pack, const float* g_comp,
                                 const float* g_acc, const float* g_depth, const float* g_weights,
                                 const float* saved, const float* raw, float* grow, float* delta, float* partials,
                                 float* narrow, float* out, int n_rays, int S, int ray_tile, int white_bkgd,
                                 int dot_bf16, void* stream) {
  if (bad_shape(n_rays, S, ray_tile)) return cudaErrorInvalidValue;
  return launch_bwd_saved(t, rays_d, venc, xenc, AONERF_WEIGHTS, b1_pack, g_comp, g_acc, g_depth, g_weights, saved,
                          raw, grow, delta, partials, narrow, out, n_rays, S, ray_tile, white_bkgd, dot_bf16,
                          static_cast<cudaStream_t>(stream));
}

// The level's weight gradient from its inputs alone: K1s, then the backward
// from what it saved. Arguments as for aonerf_fused_level_bwd_saved without
// `raw`, with K1s' `wt` before `b1_pack` (in bf16 mode wvb comes rounded
// too); K1s' outputs and `raw` (R*(5 S + 5) floats) live at the front of
// `delta` until B1 overwrites it.
int aonerf_fused_level_bwd(const float* t, const float* rays_d, const float* venc, const float* xenc,
                           AONERF_WEIGHT_PARAMS, const void* wt, const void* b1_pack, const float* g_comp,
                           const float* g_acc, const float* g_depth, const float* g_weights, float* saved,
                           float* grow, float* delta, float* partials, float* narrow, float* out, int n_rays, int S,
                           int ray_tile, int white_bkgd, int dot_bf16, void* stream) {
  if (bad_shape(n_rays, S, ray_tile)) return cudaErrorInvalidValue;
  const size_t rows = (size_t)n_rays * S;
  float* raw = delta;
  float* weights = raw + 4 * rows;
  float* comp = weights + rows;
  float* acc = comp + 3 * (size_t)n_rays;
  float* depth = acc + n_rays;
  const Weights w = AONERF_WEIGHTS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int err = launch_fwd_spill(t, rays_d, venc, xenc, w, wt, comp, acc, depth, weights, saved, raw, n_rays, S,
                                 ray_tile, white_bkgd, dot_bf16, s))
    return err;
  return launch_bwd_saved(t, rays_d, venc, xenc, w, b1_pack, g_comp, g_acc, g_depth, g_weights, saved, raw, grow,
                          delta, partials, narrow, out, n_rays, S, ray_tile, white_bkgd, dot_bf16, s);
}

}  // extern "C"
