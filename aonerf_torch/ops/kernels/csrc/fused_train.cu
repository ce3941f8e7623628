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
//     before any chunk's MLP backward. In bf16 mode the spill is bf16 (1.92
//     GB at S = 193): each warp also writes its epilogue's bf16 pairs by
//     stmatrix into a bf16 tile with the 128-byte swizzle, in the space of
//     the last two of the ring's stages (the bf16 walk then runs on 3, so
//     the block's shared memory stays K1's), and thread 0 stores the tile's
//     rows by TMA (a 3D map of the scratch by block, so a chunk's rows past
//     the block's end are not written). Per-thread 16-byte stores of the
//     same values, each warp instruction touching 32 rows, took K1s 18-20%
//     longer than the fp32 layout's bulk copies; the tile is 12-14% faster
//     than those (PERF.md).
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
//     bf16 pack of its weights. Both scratches are bf16: it loads each saved
//     activation into a bf16 tile in the fp32 H tile's space, writes each
//     delta rounded to bf16 as K1s writes `saved` (stmatrix into a swizzled
//     bf16 tile in the ring's last two stages, TMA stores; the ring runs on
//     3), and sums the ten bias gradients (b0..b7, bb, bv) itself from the
//     fp32 deltas it holds, into its narrow set; its shared memory is the
//     fp32 B1's. What bounds it is bytes: 3.8 GB at S = 193, 1.15 ms at 3.35 TB/s
//     (its products 0.45 ms at 989 TFLOP/s). Its ray tile is chosen per
//     launch (below).
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
//     bounds it is bytes: both scratches bf16, xenc fp32 and the partial
//     sets, 3.9 GB at S = 193, 1.16 ms at 3.35 TB/s. TMA loads the bf16 rows
//     with the 128-byte swizzle straight into the layout ldmatrix.trans
//     reads (kernel note below), so no pass goes over shared memory between
//     the copy and the products but for xenc's 4 of 72 tiles, and B2 sums
//     no bias (B1 does). Both operands are K-major here (K is the sample
//     row), which ldmatrix.trans turns into mma.sync's fragments. Clusters
//     of the four M tiles of a column tile with Delta multicast (PR 13, on
//     the fp32 layout) did not resolve a gain of the bf16 step, so the
//     blocks stay independent. On the H100 (tools/torch_train_compare.py, in
//     turns with the fp32-layout kernel it replaced, 1.33-1.40 / 4.27-4.43
//     ms): 0.79-0.81 / 2.25-2.38 ms at 2048 rays x S = 65 / 193, against
//     the 0.398 / 1.159 ms bound. Each H row is read from L2 by two blocks
//     and each Delta row by four, 11.1 GB from L2 at S = 193 (4.7 TB/s);
//     tiles of 128 rows (16 warps, one block a SM), which read 31% less, took
//     0.91-0.92 / 2.65-2.69 ms in the same call, so the re-reads alone do
//     not set its time.
//  R. level_bwd_reduce_kernel: sums the 16 partial sets (38 MB, which L2
//     holds) and the B1 blocks' narrow sets (in bf16 mode the biases too),
//     each in a fixed order.
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
// activations, which the TPU backward keeps in bf16, as bf16. B1
// runs the same gemm_bf16 on its delta tile D (fp32 layout, bf16 values),
// from a ring of 32-deep slices of the wrapper's bf16 pack of its nine
// flax-layout weights (B1Bf16Schedule, 68 slices a chunk where the fp32
// stream has 136), each fresh accumulator summing kB1Bf16Run k16 steps; it
// reads no other weight but wd and wr, which come rounded. The integrator
// backward stays fp32 and recomputes the transmittance in fp32 from `raw`,
// as the TPU backward does.
// B1 sums every bias gradient and the per-ray sum for wvb from its fp32
// deltas; only a product's operand is rounded: the shared tile D that feeds
// the next product and the delta scratch, which B2 multiplies, get the
// rounded delta, and the narrow head products round g_raw_sigma, g_raw_rgb
// and the per-ray sum as they read them. B2 in bf16 is a kernel of its own
// (above) on the two bf16 scratches. Every bf16 product is mma.sync m16n8k16 bf16, whose sums group
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
// Scratch at 2048 x 193: saved and delta 3.85 GB each in fp32, 1.92 GB each
// in bf16 mode (saved lives from K1s to K2), raw and grow 6.3 MB each,
// partials 16 x 2.38 MB, narrow 128 x 16.4 KB (26.1 KB in bf16 mode).
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8, printed by chip_smoke.py's build
// phase on the H100): K1s 220 registers, no spill (181 in bf16 mode); the
// integrator backward 39; B1 255 registers, 20 bytes of spill stores and 20
// of spill loads (24-byte stack frame), in bf16 mode 254, no spill; B2 128
// registers (capped by __launch_bounds__(256, 2)), 24 bytes of spill stores
// and loads (16-byte stack frame; the two stores sit before its main loop),
// and in bf16 107, no spill; the reduction 32 registers.
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

// Pass B1. The delta scratch holds kSpill values a sample (fp32, bf16 in
// bf16 mode), shaped like the saved rows: delta_0..delta_7 at l * kWidth,
// the bottleneck's gradient at kSpillBtl, delta_v at kSpillView. D and H
// (kRows x kAct) use the forward's activation stride, the weight ring its
// stages (nerf_level.cuh).
// A B1 block's narrow partial set: the head gradients summed over its rays;
// in bf16 mode also the bias gradients b0..b7, bb, bv, the fp32 deltas
// summed over its rows (kNarrowBias + the delta's column).
constexpr int kNarrowWd = 0, kNarrowBd = kNarrowWd + kWidth, kNarrowWr = kNarrowBd + 4,
              kNarrowBr = kNarrowWr + kCondWidth * 3, kNarrowWvb = kNarrowBr + 4,
              kNarrowFloats = kNarrowWvb + kView * kCondWidth;
constexpr int kNarrowBias = kNarrowFloats, kNarrowFloats16 = kNarrowBias + kSpill;
// B1 in bf16 mode keeps a saved activation as a bf16 tile H16 (kRows x kH16:
// rows 528 bytes apart, 4 mod 32 words, so the masks' pair reads of a warp
// hit 32 banks), and, for the bias sums, the two row halves' column sums of
// a chunk (ps, 2 x kSpillView) and the block's running sums (bsum, kSpill),
// all in the space the fp32 H takes, so its shared memory is the fp32 B1's.
constexpr int kH16 = kWidth + 8;
static_assert(kRows * kH16 / 2 + 2 * kSpillView + kSpill <= kRows * kAct, "H16, ps and bsum fit in H's space");

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
// The first xenc column of a block whose H is xenc: its M tile's m0, or 0
// where one tile holds every column (kPos <= kDwM: 63 / 27 compiles as if
// the offset were not there).
__device__ __forceinline__ int xenc_col0(int m0) { return kPos > kDwM ? m0 : 0; }
// B2 in bf16 mode: a ring of kDw16Stages stages of kDw16Step rows, each
// Delta's kDwN columns as two boxes of 64 (128 bytes a row) and then H's
// kDwM, bf16 as TMA writes them with the 128-byte swizzle (kDw16StageBytes),
// and a full and an empty barrier a stage, after up to kRingAlign bytes of
// alignment: 99,456 bytes, two blocks a SM. xenc's tiles take the ring as
// kDw16Stages / 2 slots of two stages: Delta and H as above, then the step's
// fp32 xenc rows (kDw16Step x kDwM floats).
constexpr int kDw16Step = 32, kDw16Stages = 8;
constexpr int kDw16Box = kDw16Step * 64 * (int)sizeof(uint16_t);  // one 64-column box: 4,096 bytes
constexpr int kDw16DBytes = (kDwN / 64) * kDw16Box;
constexpr int kDw16StageBytes = kDw16DBytes + (kDwM / 64) * kDw16Box;
constexpr size_t kDw16SmemBytes =
    kRingAlign + (size_t)kDw16Stages * kDw16StageBytes + 2 * kDw16Stages * sizeof(uint64_t);
static_assert(kDw16Box % 1024 == 0 && kDw16StageBytes % 1024 == 0, "swizzle atoms (8 rows of 128 bytes) aligned");
static_assert(kDw16StageBytes + kDw16Step * kDwM * (int)sizeof(float) <= 2 * kDw16StageBytes,
              "an xenc slot holds the step's fp32 rows");
static_assert(kDw16Step * kDwM == 8 * kThreads && kDw16Step % 16 == 0, "the xenc rounding pass: 8 values a thread");

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
constexpr int kDwTiles = count_tiles();  // 72 at kPos <= 64 (w0 and w5i one M tile each); 76 at 65-128

// K1s: K1's forward walk over the block's ray_tile rays, saving every valid
// row's activations to `saved` (kSpill values a sample: fp32, or bf16 in
// bf16 mode, through `spill_map`, by TMA stores from the bf16 tile in the
// ring's last two stages, the ring running on kSpillStages), then K1's
// integrator forward (comp, acc, depth, weights, the same bits as K1's) and
// each sample's raw sigma and rgb to `raw` (4 floats a sample) for the
// integrator backward. With `noise` (R x S fp32, row-major; null for none),
// each sample's noise is added to its raw sigma in fp32 before anything reads
// it (models/nerf.py's noise_std: raw sigma + uniform * noise_std, before the
// ReLU): `raw` holds the noisy sigma, so the backward needs no change (the
// noise is additive). Without it nothing is added and no barrier is taken.
template <bool Bf16>
__global__ void __launch_bounds__(kThreads, 1)
level_fwd_spill_kernel(const float* __restrict__ t, const float* __restrict__ rays_d,
                       const float* __restrict__ venc, const float* __restrict__ xenc, Weights w,
                       const __grid_constant__ WeightMaps maps, float* __restrict__ comp,
                       float* __restrict__ acc_out, float* __restrict__ depth, float* __restrict__ weights_out,
                       SpillElem<Bf16>* __restrict__ saved, float* __restrict__ raw,
                       const float* __restrict__ noise, int S, int ray_tile, int white_bkgd,
                       const __grid_constant__ SpillMap<Bf16> spill_map) {
  extern __shared__ __align__(16) float smem[];
  const ForwardSmem m = carve_forward_smem(smem, S, ray_tile);
  const int ray0 = blockIdx.x * ray_tile;
  const int n_rows = ray_tile * S;
  const size_t row_base = (size_t)ray0 * S;

  FwdRing<Bf16, Bf16 ? kSpillStages : kStages> ring(m.ring, maps.m, n_rows);
  view_terms<Bf16>(venc, w.wvb, m.cterm, ray0, ray_tile);
  for (int row0 = 0; row0 < n_rows; row0 += kRows) {
    if constexpr (Bf16) {
      const SpillTo<true> spill{&spill_map.map, smem_addr(m.ring + kSpillTileFloats), row0, 0};
      forward_chunk<true, Bf16>(xenc, w, ring, m, row_base, row0, n_rows, S, spill);
    } else {
      forward_chunk<true, Bf16>(xenc, w, ring, m, row_base, row0, n_rows, S,
                                SpillTo<false>{saved + (row_base + row0) * kSpill});
    }
  }
  // forward_chunk ended with a barrier: sig and rgb are complete
  float* sig = m.sig;
  const float* rgb = m.rgb;
  for (int i = threadIdx.x; i < n_rows; i += kThreads) {
    float s = sig[i];
    if (noise != nullptr) {
      s += noise[row_base + i];
      sig[i] = s;
    }
    *reinterpret_cast<float4*>(raw + (row_base + i) * 4) = make_float4(s, rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
  }
  if (noise != nullptr) __syncthreads();  // the same for every thread; integrate_rays reads other threads' rows
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
      const float v = max_keep_nan(1.f - a.alpha + 1e-10f, 1e-10f);
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
// rows dst + r * kSpill + c. Ends with a barrier.
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
          x0 = fmaf(gs[r], v0, x0);
          x1 = fmaf(gs[r], v1, x1);
        }
        if (M != nullptr) {
          if (!(M[r * kAct + c] > 0.f)) x0 = 0.f;
          if (!(M[r * kAct + c + 1] > 0.f)) x1 = 0.f;
        }
        x0 = tf32_safe_nan(x0);
        x1 = tf32_safe_nan(x1);
        *reinterpret_cast<float2*>(D + r * kAct + c) = make_float2(x0, x1);
        if (r < valid_rows) *reinterpret_cast<float2*>(dst + (size_t)r * kSpill + c) = make_float2(x0, x1);
      }
  }
  __syncthreads();
}

// One step of the bias sums' shuffle tree: a lane keeps the half of its N
// column sums that its lane bit M selects and adds the same half of the
// lane M apart.
template <int M, int N>
__device__ __forceinline__ void keep_half(float (&s)[16]) {
  const bool upper = threadIdx.x & M;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float mine = upper ? s[i + N / 2] : s[i];
    s[i] = mine + __shfl_xor_sync(kFull, upper ? s[i] : s[i + N / 2], M);
  }
}

// store_delta in bf16 mode: the same delta, rounded to bf16 (to nearest,
// ties to even) into D, the next product's operand, and into the bf16 tile
// (stage_bf16), from which thread 0 stores the chunk's rows to the scratch
// by TMA after the closing barrier (dst; the next delta_product_done<true>
// waits for the stores to read the tile); the rank-1 product rounds
// g_raw_sigma; the mask from the bf16 tile M (stride kH16). The unrounded
// fp32 deltas of the rows below valid_rows are summed for the bias
// gradients: each thread's four rows in order (32 (w / 4) + g + 0, 8, 16,
// 24), then a fixed shuffle tree over the warp's eight row groups (lanes
// 16, 8, 4 apart) that leaves lane (g, t) the sums of its warp's columns
// 8 g + 2 t + {0, 1} over the warp's 32 rows, which go to sums[half *
// kSpillView + column], half = w / 4 the warp's row half. Ends with a
// barrier.
__device__ __forceinline__ void store_delta_bf16(const ChunkAcc<kWidth>& acc, float* D, const uint16_t* M,
                                                 const float* gs, const float* __restrict__ wd, SpillTo<true> dst,
                                                 int valid_rows, float* sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = (warp >> 2) * 32 + (lane >> 2), cw = (warp & 3) * 64, c0 = cw + 2 * (lane & 3);
  float s[16];
#pragma unroll
  for (int ni = 0; ni < 8; ++ni) {
    const int c = c0 + 8 * ni;
    float v0 = 0.f, v1 = 0.f;
    if (wd != nullptr) {
      v0 = __ldg(wd + c);
      v1 = __ldg(wd + c + 1);
    }
    uint32_t pairs[4];
    s[2 * ni] = s[2 * ni + 1] = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * mi + 8 * h;
        float x0 = acc[mi][ni][2 * h], x1 = acc[mi][ni][2 * h + 1];
        if (wd != nullptr) {
          x0 = fmaf(round_bf16(gs[r]), v0, x0);
          x1 = fmaf(round_bf16(gs[r]), v1, x1);
        }
        if (M != nullptr) {
          const uint32_t m = *reinterpret_cast<const uint32_t*>(M + r * kH16 + c);
          if (!(bf16_bits_to_float(m & 0xffffu) > 0.f)) x0 = 0.f;
          if (!(bf16_bits_to_float(m >> 16) > 0.f)) x1 = 0.f;
        }
        const uint32_t p = bf16x2_rn(x0, x1);
        pairs[2 * mi + h] = p;
        *reinterpret_cast<float2*>(D + r * kAct + c) =
            make_float2(bf16_bits_to_float(p & 0xffffu), bf16_bits_to_float(p >> 16));
        if (r < valid_rows) {
          s[2 * ni] += x0;
          s[2 * ni + 1] += x1;
        }
      }
    stage_bf16<kWidth>(dst.tile, ni, pairs);
  }
  keep_half<16, 16>(s);
  keep_half<8, 8>(s);
  keep_half<4, 4>(s);
  *reinterpret_cast<float2*>(sums + (warp >> 2) * kSpillView + cw + 2 * lane) = make_float2(s[0], s[1]);
  fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0) store_spill_tile<kWidth>(dst.map, dst.tile, dst.col, dst.row0);
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

// The same from the bf16 scratch into the bf16 tile H (stride kH16).
template <int N>
__device__ __forceinline__ void load_rows(uint16_t* H, const uint16_t* __restrict__ rows, int valid_rows) {
  constexpr int kVec = N / 8;
  for (int i = threadIdx.x; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool valid = r < valid_rows;
    cp_async16(reinterpret_cast<float*>(H + r * kH16 + c),
               reinterpret_cast<const float*>(valid ? rows + (size_t)r * kSpill + c : rows), valid);
  }
  cp_async_commit();
}

// After one of B1's products: this thread's cp.async group (the next saved
// activation H, loaded under the product) has landed, and after the barrier
// every thread's has, and every warp has finished reading D, which the
// epilogue overwrites; in bf16 mode also the last delta's TMA stores have
// read the bf16 tile.
template <bool Bf16>
__device__ __forceinline__ void delta_product_done() {
  cp_async_wait<0>();
  if constexpr (Bf16) {
    if (threadIdx.x == 0) bulk_wait_read();
  }
  __syncthreads();
}

// B1's weight stream: B1Schedule's fp32 flax-layout weights, or in bf16 mode
// their bf16 pack (B1Bf16Schedule) on kSpillStages stages of the ring.
template <bool Bf16>
using B1Ring = WeightRing<std::conditional_t<Bf16, B1Bf16Schedule, B1Schedule>, Bf16 ? kSpillStages : kStages>;

// acc += D[:, :K] . W^T, W the next product of B1's stream: 3xTF32 through
// gemm_wt in fp32, native bf16 through gemm_bf16 in bf16 mode (D holds the
// rounded delta there).
template <bool Bf16>
__device__ __forceinline__ void delta_product(ChunkAcc<kWidth>& acc, const float* D, int K, B1Ring<Bf16>& ring) {
  if constexpr (Bf16) gemm_bf16<kWidth, kAct, kB1Bf16Run>(acc, D, K, ring);
  else gemm_wt<kWidth, kAct, 4>(acc, D, K, ring);
}

// B1 in bf16 mode, in the space of the fp32 H tile at H: the bf16 tile H16
// of a saved activation, then the bias sums' ps and bsum.
__device__ __forceinline__ uint16_t* b1_h16(float* H) { return reinterpret_cast<uint16_t*>(H); }
__device__ __forceinline__ float* b1_ps(float* H) { return H + kRows * kH16 / 2; }
__device__ __forceinline__ float* b1_bsum(float* H) { return b1_ps(H) + 2 * kSpillView; }

// `maps` holds B1Schedule's weights (wva, wb, w7, w6, w5x, w4, w3, w2, w1)
// in their flax layout, or in bf16 mode B1Bf16Schedule's pack of them (wd
// and wr come rounded to bf16 then), and `delta_map` the bf16 delta scratch
// for the TMA stores of its trunk's and bottleneck's deltas.
template <bool Bf16>
__global__ void __launch_bounds__(kThreads, 1)
level_bwd_delta_kernel(const float* __restrict__ venc, const float* __restrict__ wd, const float* __restrict__ wr,
                       const __grid_constant__ WeightMaps maps, const SpillElem<Bf16>* __restrict__ saved,
                       const float* __restrict__ grow, SpillElem<Bf16>* __restrict__ delta,
                       float* __restrict__ narrow, int S, int ray_tile,
                       const __grid_constant__ SpillMap<Bf16> delta_map) {
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
  if constexpr (Bf16) {
    for (int c = tid; c < kSpill; c += kThreads) b1_bsum(H)[c] = 0.f;  // thread c % kThreads owns column c
  }
  // This thread's head gradients over the block's rows, each chunk's sum
  // added in chunk order: wd[tid]; wr[tid][0..2] (tid < 128); bd (tid 128)
  // or br[tid - 129] (tid 129..131).
  float n_wd = 0.f, n_wr0 = 0.f, n_wr1 = 0.f, n_wr2 = 0.f, n_b = 0.f;

  for (int row0 = 0; row0 < n_rows; row0 += kRows) {
    const int valid_rows = min(kRows, n_rows - row0);
    const SpillElem<Bf16>* sv = saved + (row_base + row0) * kSpill;
    SpillElem<Bf16>* dv = delta + (row_base + row0) * kSpill;
    const float* gr = grow + (row_base + row0) * 4;
    for (int i = tid; i < kRows * 4; i += kThreads) {
      const int r = i / 4, c = i % 4;
      const float v = r < valid_rows ? gr[i] : 0.f;
      if (c == 0) gs[r] = v; else grgb[r * 3 + c - 1] = v;
    }
    if constexpr (Bf16) load_rows<kCondWidth>(b1_h16(H), sv + kSpillView, valid_rows);  // hv
    else load_rows<kCondWidth>(H, sv + kSpillView, valid_rows);
    cp_async_wait<0>();
    __syncthreads();

    // Heads: wr += hv^T g_raw_rgb, br, bd.
    if (tid < kCondWidth) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int r = 0; r < kRows; ++r) {
        float h;
        if constexpr (Bf16) h = bf16_bits_to_float(b1_h16(H)[r * kH16 + tid]);
        else h = operand<Bf16>(H[r * kAct + tid]);
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
      float h;
      if constexpr (Bf16) h = bf16_bits_to_float(b1_h16(H)[r * kH16 + c]);
      else h = H[r * kAct + c];
      D[r * kAct + c] = h > 0.f ? (Bf16 ? g : tf32_safe_nan(g)) : 0.f;
    }
    __syncthreads();
    // The per-ray sum of delta_v for wvb (one thread per column, rows in
    // order; in bf16 mode also its bias sum bv, chunk after chunk), and
    // delta_v to the scratch.
    if (tid < kCondWidth) {
      if constexpr (Bf16) {
        float bv = 0.f;
        for (int r = 0; r < valid_rows; ++r) {
          const float x = D[r * kAct + tid];
          gc[((row0 + r) / S) * kCondWidth + tid] += x;
          bv += x;
        }
        b1_bsum(H)[kSpillView + tid] += bv;
      } else {
        for (int r = 0; r < valid_rows; ++r) gc[((row0 + r) / S) * kCondWidth + tid] += D[r * kAct + tid];
      }
    }
    if constexpr (!Bf16) {
      for (int i = tid; i < valid_rows * (kCondWidth / 4); i += kThreads) {
        const int r = i / (kCondWidth / 4), c = (i % (kCondWidth / 4)) * 4;
        *reinterpret_cast<float4*>(dv + (size_t)r * kSpill + kSpillView + c) =
            *reinterpret_cast<const float4*>(D + r * kAct + c);
      }
    } else {  // once the fp32 reads above are done: delta_v rounded, the product's operand and the scratch's value
      __syncthreads();
      for (int i = tid; i < kRows * (kCondWidth / 8); i += kThreads) {
        const int r = i / (kCondWidth / 8), c = (i % (kCondWidth / 8)) * 8;
        float* x = D + r * kAct + c;
        const float4 a = *reinterpret_cast<const float4*>(x), b = *reinterpret_cast<const float4*>(x + 4);
        const uint4 p = make_uint4(bf16x2_rn(a.x, a.y), bf16x2_rn(a.z, a.w), bf16x2_rn(b.x, b.y), bf16x2_rn(b.z, b.w));
        *reinterpret_cast<float4*>(x) = make_float4(bf16_bits_to_float(p.x & 0xffffu), bf16_bits_to_float(p.x >> 16),
                                                    bf16_bits_to_float(p.y & 0xffffu), bf16_bits_to_float(p.y >> 16));
        *reinterpret_cast<float4*>(x + 4) = make_float4(bf16_bits_to_float(p.z & 0xffffu), bf16_bits_to_float(p.z >> 16),
                                                        bf16_bits_to_float(p.w & 0xffffu), bf16_bits_to_float(p.w >> 16));
        if (r < valid_rows) *reinterpret_cast<uint4*>(dv + (size_t)r * kSpill + kSpillView + c) = p;
      }
      __syncthreads();
    }
    if constexpr (Bf16) load_rows<kWidth>(b1_h16(H), sv + 7 * kWidth, valid_rows);  // h7, lands under the product
    else load_rows<kWidth>(H, sv + 7 * kWidth, valid_rows);
    ChunkAcc<kWidth> acc;
    zero_acc(acc);  // g_btl = delta_v . wva^T
    delta_product<Bf16>(acc, D, kCondWidth, ring);
    delta_product_done<Bf16>();
    // bf16 mode: the chunk's rows of the delta scratch, stored from the bf16 tile in the ring's last two stages
    [[maybe_unused]] const auto dt = [&] {
      if constexpr (Bf16) return SpillTo<true>{&delta_map.map, smem_addr(ring_buf + kSpillTileFloats), row0, 0};
      else return 0;
    }();
    if constexpr (Bf16)
      store_delta_bf16(acc, D, nullptr, nullptr, nullptr, dt + kSpillBtl, valid_rows, b1_ps(H) + kSpillBtl);
    else store_delta(acc, D, nullptr, nullptr, nullptr, dv + kSpillBtl, valid_rows);
    {  // density head: wd += h7^T g_raw_sigma
      float s = 0.f;
      if constexpr (Bf16) {
        for (int r = 0; r < kRows; ++r) s = fmaf(bf16_bits_to_float(b1_h16(H)[r * kH16 + tid]), round_bf16(gs[r]), s);
      } else {
        for (int r = 0; r < kRows; ++r) s = fmaf(operand<Bf16>(H[r * kAct + tid]), operand<Bf16>(gs[r]), s);
      }
      n_wd += s;
    }
    zero_acc(acc);  // delta_7 = (g_btl . wb^T + g_raw_sigma wd^T) * (h7 > 0)
    delta_product<Bf16>(acc, D, kWidth, ring);
    delta_product_done<Bf16>();
    if constexpr (Bf16)
      store_delta_bf16(acc, D, b1_h16(H), gs, wd, dt + 7 * kWidth, valid_rows, b1_ps(H) + 7 * kWidth);
    else store_delta(acc, D, H, gs, wd, dv + 7 * kWidth, valid_rows);
    for (int l = 6; l >= 0; --l) {  // delta_l = (delta_{l+1} . W_{l+1}^T) * (h_l > 0), W_5 = w5x
      if constexpr (Bf16) load_rows<kWidth>(b1_h16(H), sv + l * kWidth, valid_rows);
      else load_rows<kWidth>(H, sv + l * kWidth, valid_rows);
      zero_acc(acc);
      delta_product<Bf16>(acc, D, kWidth, ring);
      delta_product_done<Bf16>();
      if constexpr (Bf16)
        store_delta_bf16(acc, D, b1_h16(H), nullptr, nullptr, dt + l * kWidth, valid_rows, b1_ps(H) + l * kWidth);
      else store_delta(acc, D, H, nullptr, nullptr, dv + l * kWidth, valid_rows);
    }
    if constexpr (Bf16) {  // the chunk's bias sums, row half 0 then 1, into the running sums (the last barrier ordered ps)
      const float* ps = b1_ps(H);
      for (int c = tid; c < kSpillView; c += kThreads) b1_bsum(H)[c] += ps[c] + ps[kSpillView + c];
    }
  }

  float* nw = narrow + (size_t)blockIdx.x * (Bf16 ? kNarrowFloats16 : kNarrowFloats);
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
  if constexpr (Bf16) {
    for (int c = tid; c < kSpill; c += kThreads) nw[kNarrowBias + c] = b1_bsum(H)[c];
    if (tid == 0) bulk_wait_all();  // the last delta's stores have landed
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
// stage by cp.async (xenc's kPos-float rows are no TMA box; the pad column
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
  const int lo = B.lo, hi = B.hi, xm0 = xenc_col0(B.m0);
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
      const int r = i / kDwM, c = xm0 + i % kDwM;
      const bool valid = s0 + r < hi && c < kPos;
      cp_async4(hs + r * kDwHs + c - xm0, valid ? xenc + (size_t)(s0 + r) * kPos + c : xenc, valid);
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
  // of the warps on row half (i / 32) % 2 in k8 step i / 64. xenc's values
  // reach the split as cp.async copied them, so they are made TF32-safe here
  // (a NaN of the card's sin, 0x7fffffff, would split to -0); K1s wrote the
  // saved layers TF32-safe already.
  auto split_h = [&](int s) {
    const int ks = threadIdx.x >> 6, half = (threadIdx.x >> 5) & 1;
    const float* p = ring + (s % kDwStages) * kDwStageFloats + (ks * 8 + t) * kDwHs + half * 32 + 4 * g;
    float4 lo4 = *reinterpret_cast<const float4*>(p);
    float4 hi4 = *reinterpret_cast<const float4*>(p + 4 * kDwHs);
    if (!tma) {
      lo4 = make_float4(tf32_safe_nan(lo4.x), tf32_safe_nan(lo4.y), tf32_safe_nan(lo4.z), tf32_safe_nan(lo4.w));
      hi4 = make_float4(tf32_safe_nan(hi4.x), tf32_safe_nan(hi4.y), tf32_safe_nan(hi4.z), tf32_safe_nan(hi4.w));
    }
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
// on native bf16 products from bf16 tiles that TMA writes straight into the
// layout the tensor cores read. A step is kDw16Step = 32 rows. A block whose
// H is a saved layer has thread 0 load, by TMA, each step's Delta rows (32 x
// 128 bf16, as two 64-column boxes) and H rows (32 x 64) into the next stage
// of a ring of kDw16Stages, with the 128-byte swizzle (the 16-byte chunk j
// of a 128-byte row r lands at chunk j ^ (r % 8)), kDw16Stages - 2 steps
// ahead of the one the warps read, each stage with a full barrier that takes
// its 12,288 bytes and an empty barrier on which every warp arrives once it
// has read the stage; thread 0 refills a stage once the empty barrier says
// every warp has left it. The tiles whose H is xenc (w0, w5i; xenc's
// kPos-float rows are no TMA box) take the ring as slots of two stages: Delta
// by TMA as above, xenc's fp32 rows by cp.async from every thread (the pad
// column and rows at or past hi zero-filled), all arriving on the slot's
// full barrier; once a step has landed, one pass rounds its xenc rows to
// bf16 (cvt.rn: to nearest, ties to even) into the swizzled H box, and a
// block barrier a step both ends that pass and frees the slot of the step
// before. Warp w owns rows 32 (w / 4) + [0, 32) and columns 32 (w % 4) +
// [0, 32) of the tile as 2 x 4 m16n8 tiles, A = H^T and B = Delta each
// loaded by ldmatrix.x4.trans from the swizzled boxes (the 8 row addresses
// of each 8x8 matrix hold one logical chunk of 8 consecutive rows, so they
// fall in 8 different 16-byte bank groups: no conflict), then mma.sync
// m16n8k16 bf16. Each step's two k16 slices go to a fresh accumulator that
// an fp32 add folds into the tile's sum (the tensor cores truncate as they
// accumulate). Steps end on multiples of 32 rows (rows_per_range is a
// multiple of 64), so only the last range's last step runs past its rows,
// into rows TMA reads as zeros (past n_total) or cp.async zero-fills. The
// bias gradients are B1's in bf16 mode (its narrow sets), so B2 sums none.

// Four 8x8 16-bit matrices, transposed, from the shared address `a`: lanes
// 8j .. 8j + 7 give matrix j's row addresses (16 bytes each), and r[j] gets
// element (2 (lane % 4) + e, lane / 4) of matrix j in its half e.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
level_bwd_dw_bf16_kernel(const __grid_constant__ DwMaps maps, const float* __restrict__ xenc,
                         float* __restrict__ partials, int n_total, int rows_per_range) {
  extern __shared__ __align__(16) float smem[];
  char* ring = reinterpret_cast<char*>(ring_base(smem));  // kDw16Stages stages
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kDw16Stages * kDw16StageBytes);
  uint64_t* empty = full + kDw16Stages;
  const DwBlock B = dw_block(n_total, rows_per_range);
  const DwProduct& P = B.P;
  const int n_steps = B.hi > B.lo ? (B.hi - B.lo + kDw16Step - 1) / kDw16Step : 0;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, sw = lane & 7;
  const int wr0 = (warp >> 2) * 32, wc0 = (warp & 3) * 32;
  // Each lane's ldmatrix row address in a stage, the swizzle applied (row %
  // 8 = lane % 8): A's matrices (k 0-7 | 8-15) x (m 0-7 | 8-15) in the order
  // a[0..3] takes them, of m16 tile mi; B's (k 0-7 | 8-15) x (n 0-7 | 8-15)
  // as b0, b1 of n8 tiles 2 nj and 2 nj + 1.
  const int ka = sw + ((lane >> 4) << 3), kb = sw + (((lane >> 3) & 1) << 3);
  uint32_t a_off[2], b_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a_off[i] = kDw16DBytes + ka * 128 + ((((wr0 >> 3) + ((lane >> 3) & 1) + 2 * i) ^ sw) << 4);
    b_off[i] = (wc0 >> 6) * kDw16Box + kb * 128 + (((((wc0 & 63) >> 3) + (lane >> 4) + 2 * i) ^ sw) << 4);
  }
  float tot[2][4][4];
  zero_acc(tot);
  // A step's products from the stage at `stage`, into a fresh accumulator
  // that is then added into tot.
  auto multiply = [&](const char* stage) {
    const uint32_t base = smem_addr(stage);
    float part[2][4][4];
    zero_acc(part);
#pragma unroll
    for (int kk = 0; kk < kDw16Step; kk += 16) {
      uint32_t a[2][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) ldmatrix_x4_trans(a[mi], base + a_off[mi] + kk * 128);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) ldmatrix_x4_trans(b[nj], base + b_off[nj] + kk * 128);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(part[mi][ni], a[mi], b[ni >> 1][2 * (ni & 1)], b[ni >> 1][2 * (ni & 1) + 1]);
    }
    add_into(tot, part);
  };
  // Step t's Delta rows into `dst` by TMA, completing on bar.
  auto load_delta = [&](char* dst, uint64_t* bar, int t) {
    const int row = B.lo + t * kDw16Step;
    tma_load_2d(reinterpret_cast<float*>(dst), &maps.d, bar, P.d_off + B.n0, row);
    tma_load_2d(reinterpret_cast<float*>(dst + kDw16Box), &maps.d, bar, P.d_off + B.n0 + 64, row);
  };

  if (P.h_off != kX) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kDw16Stages; ++i) {
        mbar_init(&full[i], 1);
        mbar_init(&empty[i], kWarps);
      }
      mbar_init_fence();
    }
    __syncthreads();
    // Thread 0: step t into stage t % kDw16Stages, once every warp has left
    // step t - kDw16Stages, which held it.
    auto issue = [&](int t) {
      const int st = t % kDw16Stages;
      if (t >= kDw16Stages) mbar_wait(&empty[st], (t / kDw16Stages - 1) & 1);
      char* dst = ring + st * kDw16StageBytes;
      mbar_arrive_expect_tx(&full[st], kDw16StageBytes);
      load_delta(dst, &full[st], t);
      tma_load_2d(reinterpret_cast<float*>(dst + kDw16DBytes), &maps.h, &full[st], P.h_off + B.m0,
                  B.lo + t * kDw16Step);
    };
    constexpr int kAhead = kDw16Stages - 2;  // steps in flight beyond the one the warps read
    if (threadIdx.x == 0) {
      for (int t = 0; t < kAhead && t < n_steps; ++t) issue(t);
    }
    for (int s = 0; s < n_steps; ++s) {
      if (threadIdx.x == 0 && s + kAhead < n_steps) issue(s + kAhead);
      const int st = s % kDw16Stages;
      mbar_wait(&full[st], (s / kDw16Stages) & 1);
      multiply(ring + st * kDw16StageBytes);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  } else {
    constexpr int kSlots = kDw16Stages / 2, kSlotBytes = 2 * kDw16StageBytes;
    if (threadIdx.x == 0) {
      for (int i = 0; i < kSlots; ++i) mbar_init(&full[i], kThreads + 1);
      mbar_init_fence();
    }
    __syncthreads();
    // Every thread: step t into slot t % kSlots (nothing past the range).
    auto issue = [&](int t) {
      if (t >= n_steps) return;
      const int st = t % kSlots;
      char* dst = ring + st * kSlotBytes;
      const int row = B.lo + t * kDw16Step;
      if (threadIdx.x == 0) {
        mbar_arrive_expect_tx(&full[st], kDw16DBytes);
        load_delta(dst, &full[st], t);
      }
      float* xs = reinterpret_cast<float*>(dst + kDw16StageBytes);
      const int xm0 = xenc_col0(B.m0);
      for (int i = threadIdx.x; i < kDw16Step * kDwM; i += kThreads) {
        const int r = i / kDwM, c = xm0 + i % kDwM;
        const bool valid = row + r < B.hi && c < kPos;
        cp_async4(xs + i, valid ? xenc + (size_t)(row + r) * kPos + c : xenc, valid);
      }
      cp_async_arrive(&full[st]);
    };
    for (int t = 0; t < kSlots - 1; ++t) issue(t);
    for (int s = 0; s < n_steps; ++s) {
      const int st = s % kSlots;
      char* slot = ring + st * kSlotBytes;
      mbar_wait(&full[st], (s / kSlots) & 1);
      {  // the step's xenc rows rounded into H's box: thread i row i / 8, its 16-byte chunk i % 8
        const int r = threadIdx.x >> 3, ch = threadIdx.x & 7;
        const float* x = reinterpret_cast<const float*>(slot + kDw16StageBytes) + r * kDwM + ch * 8;
        const float4 lo = *reinterpret_cast<const float4*>(x), hi = *reinterpret_cast<const float4*>(x + 4);
        *reinterpret_cast<uint4*>(slot + kDw16DBytes + r * 128 + ((ch ^ (r & 7)) << 4)) =
            make_uint4(bf16x2_rn(lo.x, lo.y), bf16x2_rn(lo.z, lo.w), bf16x2_rn(hi.x, hi.y), bf16x2_rn(hi.z, hi.w));
      }
      __syncthreads();  // the step's H is complete, and no warp still reads the slot of step s - 1
      issue(s + kSlots - 1);  // into that slot
      multiply(slot);
    }
  }
  store_dw_tile(B, tot, partials);
}

// B2's maps over `saved` and `delta`: n_total rows of kSpill values of
// `elem` bytes, `type`, boxes of h_cols (saved) and d_cols (delta) columns x
// rows rows, `swizzle`. Returns 0, or kMapError + the driver's CUresult.
int encode_dw_maps(DwMaps& maps, const void* saved, const void* delta, int n_total, int h_cols, int d_cols,
                   int rows, CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32, int elem = sizeof(float),
                   CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)kSpill, (cuuint64_t)n_total};
  const cuuint64_t strides[1] = {(cuuint64_t)kSpill * elem};
  const cuuint32_t unit[2] = {1, 1};
  const cuuint32_t box_h[2] = {(cuuint32_t)h_cols, (cuuint32_t)rows};
  const cuuint32_t box_d[2] = {(cuuint32_t)d_cols, (cuuint32_t)rows};
  CUresult r = encode(&maps.h, type, 2, const_cast<void*>(saved), dims, strides, box_h, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return kMapError + (int)r;
  r = encode(&maps.d, type, 2, const_cast<void*>(delta), dims, strides, box_d, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// The SpillMap of a bf16 scratch (the rows of n_blocks blocks of block_rows
// rows each, kSpill values a row, at `base`) for the TMA stores of K1s or B1
// in bf16 mode. Returns 0, or kMapError + the driver's CUresult.
int encode_spill_map(SpillMap<true>& m, void* base, int block_rows, int n_blocks) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row_bytes = (cuuint64_t)kSpill * sizeof(uint16_t);
  const cuuint64_t dims[3] = {(cuuint64_t)kSpill, (cuuint64_t)block_rows, (cuuint64_t)n_blocks};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * block_rows};
  const cuuint32_t box[3] = {64, kRows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(&m.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + (int)r;
}

// ------------------------------------------------------------- the reduction

// Where gradient g sits in a B1 block's narrow set, or -1 for the gradients
// of pass B2: the heads', and in bf16 mode the biases' of B2's products too.
__device__ __forceinline__ int narrow_offset(int g, bool bf16) {
  if (bf16) {
    for (int p = 0; p < kNumProducts; ++p)
      if (c_products[p].bias == g) return kNarrowBias + c_products[p].d_off;
  }
  return g == G_WD ? kNarrowWd : g == G_BD ? kNarrowBd : g == G_WR ? kNarrowWr : g == G_BR ? kNarrowBr
       : g == G_WVB ? kNarrowWvb : -1;
}

// out[i]: the row ranges' partials (pass B2's gradients) or the B1 blocks'
// narrow partials (the heads, and in bf16 mode the biases), each summed in a
// fixed order; 0 in the padding between gradients.
__global__ void level_bwd_reduce_kernel(const float* __restrict__ partials, const float* __restrict__ narrow,
                                        int n_blocks, int bf16, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kPartialFloats) return;
  int g = 0;
  while (c_layout.off[g + 1] <= i) ++g;
  const int local = i - c_layout.off[g];
  float s = 0.f;
  if (local < c_layout.size[g]) {
    const int nidx = narrow_offset(g, bf16 != 0);
    if (nidx >= 0) {
      const int stride = bf16 ? kNarrowFloats16 : kNarrowFloats;
      for (int b = 0; b < n_blocks; ++b) s += narrow[(size_t)b * stride + nidx + local];
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

// `saved` holds fp32 values, or bf16 ones with dot_bf16.
int launch_fwd_spill(const float* t, const float* rays_d, const float* venc, const float* xenc, const Weights& w,
                     const void* wt, float* comp, float* acc, float* depth, float* weights, void* saved, float* raw,
                     const float* noise, int n_rays, int S, int ray_tile, int white_bkgd, int dot_bf16,
                     cudaStream_t s) {
  const size_t smem = forward_smem_bytes(S, ray_tile);
  const void* kernel = dot_bf16 ? (const void*)level_fwd_spill_kernel<true> : (const void*)level_fwd_spill_kernel<false>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  WeightMaps maps;
  if (int map_err = encode_forward_maps(maps, wt, dot_bf16 != 0)) return map_err;
  const int n_blocks = n_rays / ray_tile;
  if (dot_bf16) {
    SpillMap<true> spill_map;
    if (int map_err = encode_spill_map(spill_map, saved, ray_tile * S, n_blocks)) return map_err;
    level_fwd_spill_kernel<true><<<n_blocks, kThreads, smem, s>>>(t, rays_d, venc, xenc, w, maps, comp, acc, depth,
                                                                  weights, static_cast<uint16_t*>(saved), raw, noise,
                                                                  S, ray_tile, white_bkgd, spill_map);
  } else {
    level_fwd_spill_kernel<false><<<n_blocks, kThreads, smem, s>>>(t, rays_d, venc, xenc, w, maps, comp, acc, depth,
                                                                   weights, static_cast<float*>(saved), raw, noise,
                                                                   S, ray_tile, white_bkgd, SpillMap<false>{});
  }
  return cudaGetLastError();
}

// `saved` and `delta` hold fp32 values, or bf16 ones with dot_bf16.
int launch_bwd_saved(const float* t, const float* rays_d, const float* venc, const float* xenc,
                     const Weights& w, const void* b1_pack, const float* g_comp, const float* g_acc,
                     const float* g_depth, const float* g_weights, const void* saved, const float* raw, float* grow,
                     void* delta, float* partials, float* narrow, float* out, int n_rays, int S, int ray_tile,
                     int white_bkgd, int dot_bf16, cudaStream_t s) {
  if (dot_bf16 && b1_pack == nullptr) return cudaErrorInvalidValue;
  const size_t smem_i = sizeof(float) * kWarps * 3 * (size_t)S, smem_b1 = delta_smem_bytes(ray_tile);
  const void* b1 = dot_bf16 ? (const void*)level_bwd_delta_kernel<true> : (const void*)level_bwd_delta_kernel<false>;
  const void* b2 = dot_bf16 ? (const void*)level_bwd_dw_bf16_kernel : (const void*)level_bwd_dw_kernel;
  const size_t smem_b2 = dot_bf16 ? kDw16SmemBytes : kDwSmemBytes;
  cudaError_t err = set_smem((const void*)level_bwd_integrator_kernel, smem_i);
  if (err != cudaSuccess) return err;
  if ((err = set_smem(b1, smem_b1)) != cudaSuccess) return err;
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
  if (dot_bf16) {
    SpillMap<true> delta_map;
    if (int map_err = encode_spill_map(delta_map, delta, ray_tile * S, n_blocks)) return map_err;
    level_bwd_delta_kernel<true><<<n_blocks, kThreads, smem_b1, s>>>(venc, w.wd, w.wr, maps,
                                                                     static_cast<const uint16_t*>(saved), grow,
                                                                     static_cast<uint16_t*>(delta), narrow, S, ray_tile,
                                                                     delta_map);
  } else {
    level_bwd_delta_kernel<false><<<n_blocks, kThreads, smem_b1, s>>>(venc, w.wd, w.wr, maps,
                                                                      static_cast<const float*>(saved), grow,
                                                                      static_cast<float*>(delta), narrow, S, ray_tile,
                                                                      SpillMap<false>{});
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  DwMaps dw_maps;
  if (int map_err = dot_bf16 ? encode_dw_maps(dw_maps, saved, delta, n_total, 64, 64, kDw16Step,
                                              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(uint16_t),
                                              CU_TENSOR_MAP_SWIZZLE_128B)
                             : encode_dw_maps(dw_maps, saved, delta, n_total, kDwHs, kDwDs, kDwRows))
    return map_err;
  if (dot_bf16) {
    level_bwd_dw_bf16_kernel<<<kRanges * kDwTiles, kThreads, smem_b2, s>>>(dw_maps, xenc, partials, n_total,
                                                                            rows_per_range);
  } else {
    level_bwd_dw_kernel<<<kRanges * kDwTiles, kThreads, smem_b2, s>>>(dw_maps, xenc, static_cast<const float*>(delta),
                                                                       partials, n_total, rows_per_range);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  level_bwd_reduce_kernel<<<(kPartialFloats + kThreads - 1) / kThreads, kThreads, 0, s>>>(partials, narrow,
                                                                                          n_blocks, dot_bf16, out);
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

// The encoded widths this library was built for: kPos (xenc's features) and
// kView (venc's).
int aonerf_fused_level_pos_dim() { return kPos; }
int aonerf_fused_level_view_dim() { return kView; }

// Floats of the output (and of one row range's partial set): the 26
// gradients in the order of the arguments below, each padded to 4 floats.
int aonerf_fused_level_bwd_partial_floats() { return kPartialFloats; }

// Values per sample of the scratches `saved` and `delta` (fp32, or bf16 in
// bf16 mode).
int aonerf_fused_level_bwd_saved_floats() { return kSpill; }

// Row ranges of pass B2 (partial sets of the scratch `partials`), and floats
// of one B1 block's narrow set (scratch `narrow`), which in bf16 mode
// (dot_bf16 != 0) also holds the block's bias sums.
int aonerf_fused_level_bwd_ranges() { return kRanges; }
int aonerf_fused_level_bwd_narrow_floats(int dot_bf16) { return dot_bf16 ? kNarrowFloats16 : kNarrowFloats; }

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
// activations: fp32, bf16 in bf16 mode) and `raw` (R*S*4: raw sigma, raw
// rgb). `noise` (R*S fp32) is added to raw sigma before the integrator and
// `raw` read it; null adds none. With dot_bf16 != 0, the bf16 mode, on
// narrow heads (wd, wr, wvb) already rounded to bf16.
// n_rays % ray_tile == 0. Returns the launch's error (0 on success), or
// kMapError + the driver's CUresult if a tensor map was refused.
int aonerf_fused_level_fwd_spill(const float* t, const float* rays_d, const float* venc, const float* xenc,
                                 AONERF_WEIGHT_PARAMS, const void* wt, float* comp, float* acc, float* depth,
                                 float* weights, void* saved, float* raw, const float* noise, int n_rays, int S,
                                 int ray_tile, int white_bkgd, int dot_bf16, void* stream) {
  if (bad_shape(n_rays, S, ray_tile)) return cudaErrorInvalidValue;
  return launch_fwd_spill(t, rays_d, venc, xenc, AONERF_WEIGHTS, wt, comp, acc, depth, weights, saved, raw, noise,
                          n_rays, S, ray_tile, white_bkgd, dot_bf16, static_cast<cudaStream_t>(stream));
}

// The level's weight gradient from what K1s saved, on `stream`: the
// integrator backward, B1, B2 and the reduction. Inputs as for K1s, plus
// `b1_pack` (B1's bf16 pack in bf16 mode, else unused), the cotangents g_comp
// (R,3), g_acc (R), g_depth (R), g_weights (R,S) and K1s' `saved` and `raw`;
// scratch `grow` (R*S*4), `delta` (R*S*kSpill, fp32 or in bf16 mode bf16),
// `partials` (kRanges * kPartialFloats) and `narrow` ((R/ray_tile) *
// aonerf_fused_level_bwd_narrow_floats(dot_bf16)); the output `out`
// (kPartialFloats). With dot_bf16 != 0, the bf16 mode: `saved` and `delta`
// are bf16, B1 reads its products' weights from `b1_pack` and wd, wr
// (already rounded to bf16), and no other weight, and sums the bias
// gradients from its fp32 deltas. Returns the first launch error (0 on success), or
// kMapError + the CUresult of cuTensorMapEncodeTiled if a tensor map was
// refused.
int aonerf_fused_level_bwd_saved(const float* t, const float* rays_d, const float* venc, const float* xenc,
                                 AONERF_WEIGHT_PARAMS, const void* b1_pack, const float* g_comp,
                                 const float* g_acc, const float* g_depth, const float* g_weights,
                                 const void* saved, const float* raw, float* grow, void* delta, float* partials,
                                 float* narrow, float* out, int n_rays, int S, int ray_tile, int white_bkgd,
                                 int dot_bf16, void* stream) {
  if (bad_shape(n_rays, S, ray_tile)) return cudaErrorInvalidValue;
  return launch_bwd_saved(t, rays_d, venc, xenc, AONERF_WEIGHTS, b1_pack, g_comp, g_acc, g_depth, g_weights, saved,
                          raw, grow, delta, partials, narrow, out, n_rays, S, ray_tile, white_bkgd, dot_bf16,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
