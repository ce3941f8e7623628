// Device code shared by the fused NeRF level (fused_render.cu, K1, the
// forward) and its training side (fused_train.cu: K1s, the forward that saves
// the activations, and K2, the weight gradient), for Hopper (sm_90a).
//
// The forward walk (K1 and K1s) takes a block's rays in chunks of kRows
// samples packed across ray boundaries and runs the 8x256 MLP on a chunk with
// its activation in shared memory. In fp32 every 256- and 128-wide product
// runs on the tensor cores in 3xTF32 (mma.sync m16n8k8, fp32 accuracy)
// through gemm_wt, the product K2's B1 also runs: A from the shared tile, B
// from a weight stored (out x in) row-major, i.e. K-major, in device memory.
// In bf16 mode they run on native bf16 products through gemm_bf16 (below).
// The 1- and 3-wide heads and the per-ray view term stay on fp32 FMA. Each
// ray is then integrated by one warp (a prefix sum of log(max(1 - alpha +
// 1e-10, 1e-10)) with a carry across 32-sample steps). The training forward
// also saves each chunk's activations to a per-row scratch (`Spill`, kSpill
// values a sample) by bulk copies out of the shared activation tile, in bf16
// mode as bf16 by TMA stores out of a bf16 tile the epilogue fills beside
// it (stage_bf16, store_spill_tile). A row's
// outputs depend on no other row, so they do not depend on the ray tile (the
// rays a block owns), which the wrappers choose per launch.
//
// The weight stream (WeightRing). Within a 64-row chunk a kernel multiplies
// by a fixed sequence of weights (a schedule: 11 products in the forward, 9
// in B1), and every chunk repeats it. One stream per block walks that
// sequence slice by slice (all N rows x Sched::kDepth K-columns, at most 16
// KB), wrapping from chunk to chunk, into a ring of kStages stages. Thread 0
// issues each slice as one TMA copy (cp.async.bulk.tensor, a 2D tensor map
// per weight, encoded on the host for every launch) that completes on the
// stage's full barrier; each warp, once it has read a stage, arrives on the
// stage's empty barrier, and thread 0 waits for that before it refills the
// stage. Thread 0 computes too: after reading slice j it issues slice j +
// kStages - 1 into the stage slice j - 1 left, so it waits only for the
// slowest warp to leave the slice before, and a layer's first slices are in
// flight while the previous layer's last slices and its epilogue run. A
// consumer pays one wait per slice (mbarrier.try_wait.parity) and no block
// barrier; the only barriers left are the epilogues' (the activation tile is
// overwritten in place). The fp32 stream (FwdSchedule, B1Schedule: 16 fp32
// columns a slice, 152 slices a forward chunk at kPosPad 64, 136 a B1 chunk) is staged in
// the SWIZZLE_64B layout: row n's 16-byte chunk c lies at chunk c ^ ((n / 2)
// % 4) of its 64-byte row, so the TF32 B fragments' 8 rows x 4 columns hit
// 32 different banks. The bf16 stream (FwdBf16Schedule: 32 bf16 columns a
// slice, also 64 bytes a row, 76 slices a forward chunk at kPosPad 64) is unswizzled: each
// thread reads one 16-byte chunk of a row (the wrapper permutes each
// 32-column block of the pack so that chunk holds that thread's pairs), and
// a quarter warp's eight reads cover the 128 bytes of two neighbouring rows;
// B1Bf16Schedule, B1's bf16 stream, is laid out alike, 68 slices a chunk.
// Only TMA writes the ring, so its buffers need no proxy fence.
//
// Budget: 5 stages x 16 KB, 128 bytes of barriers and up to 1 KB of
// alignment, 83,072 bytes in either mode: K1/K1s take 224,640 bytes and B1
// 225,408 at ray_tile 16, S = 193, of the 232,448 a block may have, so a
// sixth stage does not fit. Measured on the H100 (tools/torch_train_compare.py,
// in turns), 3, 4 and 5 stages give the fp32 K1 and K1s the same time and B1
// 3% more at 3, and 2 stages 20-36% more. So the staging does not bound the
// fp32 K1, K1s or B1: the product's own instruction stream does (mma.sync
// with the TF32 split of every A and B fragment, 8 warps a SM).
//
// bf16 mode (template flag Bf16; the TPU kernels' dot_bf16): every product
// takes bf16-rounded operands (to nearest, ties to even) and sums in fp32;
// biases, ReLUs and the integrator stay fp32, but for the forward's
// transmittance sum, whose log terms are rounded as the TPU kernel's
// triangular product rounds them. The operands arrive rounded: the wrapper
// packs the forward's product weights as bf16 (its bf16 copy of `wt`) and
// rounds the narrow heads, the forward's epilogue (store_act) rounds each
// activation before it reaches the shared tile and the spill, and the
// encoded inputs are rounded where they are staged. The activation tile stays
// fp32 (the next product's A); the spill is bf16, 2 bytes a value, staged
// by the epilogue (store_act). The forward's products are gemm_bf16:
// mma.sync m16n8k16 bf16 with fp32 accumulators, B from the bf16 ring, A
// packed from the fp32 tile (cvt.rn.bf16x2.f32 on values already bf16, so
// exact): per 32 K-columns a thread reads 16 float2 of A and one 16-byte
// chunk of B per n8 tile, and issues 32 mma, where the TF32 walk on bf16
// values it replaced (one TF32 mma a k8 step) read 48 fp32 words and issued
// 64 mma. Each mma sums 16 consecutive K-columns into a fresh accumulator,
// the groups that walk summed into each of its fresh accumulators
// (kFwdBf16Run). K2's B1 in bf16 mode runs gemm_bf16 too, on the delta tile,
// from a bf16 pack of its nine flax-layout weights (B1Bf16Schedule), each
// fresh accumulator summing kB1Bf16Run k16 steps.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime's entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace aonerf {

// The encoded widths are a build's: a library is built for one pair
// (-DAONERF_POS_DIM=P -DAONERF_VIEW_DIM=V; by default 63 / 27, the 10 / 4
// encoding degrees), and every layout below follows them.
#ifndef AONERF_POS_DIM
#define AONERF_POS_DIM 63
#endif
#ifndef AONERF_VIEW_DIM
#define AONERF_VIEW_DIM 27
#endif
constexpr int kWidth = 256;      // trunk width
constexpr int kCondWidth = 128;  // view-branch width
constexpr int kPos = AONERF_POS_DIM;    // encoded sample features
constexpr int kView = AONERF_VIEW_DIM;  // encoded view-direction features
// w0's and w5i's K: kPos padded by zero columns of xs (and zero weight
// columns of their transposed copies) to whole 32-deep slices, the bf16
// stream's (two of the fp32 stream's 16-deep ones).
constexpr int kPosPad = (kPos + 31) / 32 * 32;
constexpr int kRows = 64;        // rows (samples) per chunk
static_assert(kPos >= 1 && kView >= 1, "at least one encoded feature");
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// Saved activations per sample: h0..h7, the bottleneck, the view hidden layer.
constexpr int kSpillBtl = 8 * kWidth;
constexpr int kSpillView = kSpillBtl + kWidth;
constexpr int kSpill = kSpillView + kCondWidth;
// A value of the saved activations (and of K2's deltas): fp32, or in bf16
// mode the bf16 value's 16 bits.
template <bool Bf16>
using SpillElem = std::conditional_t<Bf16, uint16_t, float>;
// Row strides in shared memory, both 4 mod 32 so that the A fragments' loads
// (8 rows x 4 columns a warp) hit 32 different banks: a 256-wide activation
// tile, the encoded-input tile (K padded to kPosPad).
constexpr int kAct = kWidth + 4;
constexpr int kXs = kPosPad + 4;
static_assert(kAct % 32 == 4 && kXs % 32 == 4, "row strides 4 mod 32: conflict-free A fragment reads");
// The weight ring: kStages stages of one K-slice each (up to kWidth rows of
// 64 bytes: kDepth fp32 or 2 kDepth bf16 columns), aligned as the swizzle
// needs, then its 2 x kStages barriers.
constexpr int kDepth = 16;
static_assert(kPosPad % kDepth == 0 && kPosPad % (2 * kDepth) == 0,
              "w0's and w5i's K is whole fp32 (16-deep) and bf16 (32-deep) slices");
constexpr int kStages = 5;
constexpr int kStageFloats = kWidth * kDepth;
constexpr int kRingAlign = 1024;
constexpr size_t kRingBytes = sizeof(float) * kStages * kStageFloats + 128;
// The bf16 K1s and B1 run their weight ring on kSpillStages stages and use
// the space of the last two, 32 KB at kSpillTileFloats floats into the ring,
// as the bf16 tile (kRows x 256 values, as four 64-column boxes of 8 KB, each
// row of a box 128 bytes with the 128-byte swizzle) from which TMA stores a
// layer's rows to their bf16 scratch; their shared memory stays the fp32
// kernels'.
constexpr int kSpillStages = 3;
constexpr int kSpillTileFloats = kSpillStages * kStageFloats;
constexpr int kSpillBox = kRows * 128;  // bytes of one 64-column box of the tile
static_assert((kStages - kSpillStages) * kStageFloats * (int)sizeof(float) == (kWidth / 64) * kSpillBox,
              "the bf16 tile takes the two stages the ring leaves");
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
// k16 steps that one fresh accumulator sums in the bf16 forward's products
// (gemm_bf16; the whole K of a 256-deep product is 16). A build may set it
// (-DAONERF_FWD_BF16_RUN=N, 1 or even; tools/torch_bf16_accuracy.py and
// tools/torch_train_compare.py --fwd-bf16-run N) to measure another run.
// Each k16 step sums 16 consecutive K-columns, the groups the TF32 walk it
// replaced summed into each fresh accumulator. Held to the bf16 rule on the
// H100 (tools/torch_bf16_accuracy.py; PERF.md section 6): run 1 is
// over on 0 of 48 seed x level cases and on 2 of 16 at the gpu test's 256
// rays, the TF32 walk's 2, at its ratios within 2%; run 2 on 0 of 48 and 4
// of 16, the gpu test's case among them. An earlier order, whose k16 steps
// interleaved the groups, missed too: runs 1, 2, 4, 8, 16 on 1, 0, 4, 2, 5
// of 48, run 2 on 4 of 16. K1 bf16 at 4096 rays x S = 65 / 193 takes
// 2.30-2.33 / 6.41-6.43 ms with run 1, 2.22 / 6.11 with run 2 (in turns).
#ifndef AONERF_FWD_BF16_RUN
#define AONERF_FWD_BF16_RUN 1
#endif
constexpr int kFwdBf16Run = AONERF_FWD_BF16_RUN;
// k16 steps that one fresh accumulator sums in B1's products in bf16 mode
// (-DAONERF_B1_BF16_RUN=N, 1 or even; tools/torch_bf16_accuracy.py and
// tools/torch_train_compare.py --b1-bf16-run N). Run 2 sums the 32
// consecutive K-columns of a slice, the groups the TF32 walk it replaced
// (gemm_wt, run 4) summed into each fresh accumulator; run 1 sums 16.
#ifndef AONERF_B1_BF16_RUN
#define AONERF_B1_BF16_RUN 2
#endif
constexpr int kB1Bf16Run = AONERF_B1_BF16_RUN;

// The 26 weights in the flax (in, out) layout, biases (1, out).
struct Weights {
  const float *w0, *b0, *w1, *b1, *w2, *b2, *w3, *b3, *w4, *b4;
  const float *w5x, *w5i, *b5, *w6, *b6, *w7, *b7;
  const float *wd, *bd, *wb, *bb, *wva, *wvb, *bv, *wr, *br;
};

// The weights a chunk's products read, in the order it reads them: product i
// is a row-major n(i) x k(i) matrix W (B(k, n) = W[n][k]).
// A schedule also names its slices: kDepth K-columns of Elem (fp32, or
// bf16 held as its 16 bits), and whether TMA stages them SWIZZLE_64B.
// The forward reads the transposed copies (out x in) of w0, w1, w2, w3, w4,
// w5x, w5i, w6, w7, wb, wva, with w0 and w5i's K = kPos padded to kPosPad by
// zero columns; they are packed in this order into one buffer of kWtFloats that
// the wrapper rebuilds every launch from the flax weights, in fp32 (`wt`)
// or, in bf16 mode, rounded to bf16 (FwdBf16Schedule: the same products).
struct FwdSchedule {
  using Elem = float;
  static constexpr int kDepth = aonerf::kDepth;
  static constexpr bool kSwizzle64 = true;
  static constexpr int kProducts = 11;
  __host__ __device__ static constexpr int k(int i) { return i == 0 || i == 6 ? kPosPad : kWidth; }
  __host__ __device__ static constexpr int n(int i) { return i == 10 ? kCondWidth : kWidth; }
};
// B1 reads the flax (in, out) layout of wva, wb, w7, w6, w5x, w4, w3, w2, w1,
// so it multiplies by their transposes.
struct B1Schedule {
  using Elem = float;
  static constexpr int kDepth = aonerf::kDepth;
  static constexpr bool kSwizzle64 = true;
  static constexpr int kProducts = 9;
  __host__ __device__ static constexpr int k(int i) { return i == 0 ? kCondWidth : kWidth; }
  __host__ __device__ static constexpr int n(int) { return kWidth; }
};
struct FwdBf16Schedule : FwdSchedule {
  using Elem = uint16_t;
  static constexpr int kDepth = 2 * aonerf::kDepth;
  static constexpr bool kSwizzle64 = false;
};
// B1 in bf16 mode: the same nine products, from the wrapper's bf16 pack of
// them (each in its flax layout, rounded, its rows' 32-column blocks
// permuted as the forward's pack), in 32-deep slices.
struct B1Bf16Schedule : B1Schedule {
  using Elem = uint16_t;
  static constexpr int kDepth = 2 * aonerf::kDepth;
  static constexpr bool kSwizzle64 = false;
};
template <class Sched>
__host__ __device__ constexpr int schedule_slices() {
  int n = 0;
  for (int i = 0; i < Sched::kProducts; ++i) n += Sched::k(i) / Sched::kDepth;
  return n;
}
template <class Sched>
__host__ __device__ constexpr int schedule_floats() {
  int n = 0;
  for (int i = 0; i < Sched::kProducts; ++i) n += Sched::n(i) * Sched::k(i);
  return n;
}
constexpr int kWtFloats = schedule_floats<FwdSchedule>();
static_assert(kWidth * FwdBf16Schedule::kDepth * sizeof(FwdBf16Schedule::Elem) == kStageFloats * sizeof(float) &&
                  kWidth * B1Bf16Schedule::kDepth * sizeof(B1Bf16Schedule::Elem) == kStageFloats * sizeof(float),
              "a bf16 slice fills a stage as an fp32 slice does");

// One 2D TMA map per product of a schedule; a kernel parameter
// (__grid_constant__), so the TMA unit reads it from parameter space.
constexpr int kMaxProducts = 11;
struct WeightMaps {
  CUtensorMap m[kMaxProducts];
};

// Returned by the launchers when the driver refuses a tensor map: kMapError
// plus the CUresult.
constexpr int kMapError = 1000;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda).
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Encodes the maps of a schedule's products, the i-th over the n(i) x k(i)
// row-major matrix of Sched::Elem at w[i], boxes of Sched::kDepth columns x
// n(i) rows, no out-of-bounds access (every K is a multiple of kDepth).
// Returns 0, or kMapError + the driver's CUresult.
template <class Sched>
int encode_weight_maps(WeightMaps& maps, const void* const* w) {
  static_assert(Sched::kProducts <= kMaxProducts, "one map per product");
  constexpr bool kFp32 = sizeof(typename Sched::Elem) == sizeof(float);
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kMapError + CUDA_ERROR_NOT_FOUND;
  for (int i = 0; i < Sched::kProducts; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)Sched::k(i), (cuuint64_t)Sched::n(i)};
    const cuuint64_t strides[1] = {(cuuint64_t)Sched::k(i) * sizeof(typename Sched::Elem)};
    const cuuint32_t box[2] = {(cuuint32_t)Sched::kDepth, (cuuint32_t)Sched::n(i)};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult r = encode(&maps.m[i], kFp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              const_cast<void*>(w[i]), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              Sched::kSwizzle64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return kMapError + (int)r;
  }
  return 0;
}

// The maps of a schedule whose products are packed in order into one buffer
// of Sched::Elem: the forward's transposed copies `wt` (kWtFloats elements:
// fp32, or bf16 in bf16 mode), or B1's bf16 pack.
template <class Sched>
int encode_packed_maps(WeightMaps& maps, const void* pack) {
  const auto* p = static_cast<const typename Sched::Elem*>(pack);
  const void* w[Sched::kProducts];
  for (int i = 0; i < Sched::kProducts; ++i) {
    w[i] = p;
    p += Sched::n(i) * Sched::k(i);
  }
  return encode_weight_maps<Sched>(maps, w);
}
// The same, of the fp32 copy or, with bf16, of the bf16 pack.
inline int encode_forward_maps(WeightMaps& maps, const void* wt, bool bf16) {
  return bf16 ? encode_packed_maps<FwdBf16Schedule>(maps, wt) : encode_packed_maps<FwdSchedule>(maps, wt);
}

// Slices a block's stream holds in all: its chunks times the schedule.
template <class Sched>
__host__ __device__ constexpr int stream_slices(int n_rows) {
  return (n_rows + kRows - 1) / kRows * schedule_slices<Sched>();
}

// The forward walk's shared memory for ray_tile rays of S samples: the
// weight ring, the chunk's activation (kRows x kAct) and encoded input (kRows
// x kXs), per-ray view terms, and per-sample raw sigma and rgb. 224,640
// bytes at ray_tile 16, S = 193 with kPos <= 64; 232,832 with kPos 65-96
// (more than a block may have: the wrappers' tile rule takes 8 rays there).
struct ForwardSmem {
  float *ring, *act, *xs, *cterm, *sig, *rgb;
};

// The ring's base: the dynamic shared memory rounded up to kRingAlign (each
// size that counts it adds kRingAlign bytes).
__device__ __forceinline__ float* ring_base(float* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return smem + ((kRingAlign - (s & (kRingAlign - 1))) & (kRingAlign - 1)) / sizeof(float);
}

__device__ __forceinline__ ForwardSmem carve_forward_smem(float* smem, int S, int ray_tile) {
  ForwardSmem m;
  m.ring = ring_base(smem);
  m.act = m.ring + kRingBytes / sizeof(float);
  m.xs = m.act + kRows * kAct;
  m.cterm = m.xs + kRows * kXs;
  m.sig = m.cterm + ray_tile * kCondWidth;
  m.rgb = m.sig + ray_tile * S;
  return m;
}

inline size_t forward_smem_bytes(int S, int ray_tile) {
  return kRingAlign + kRingBytes +
         sizeof(float) * ((size_t)kRows * kAct + (size_t)kRows * kXs + (size_t)ray_tile * kCondWidth +
                          4 * (size_t)ray_tile * S);
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

// mbarriers in shared memory, and TMA loads that complete on them.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}
// One arrival, and `bytes` more to come from the async proxy.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// The box of `map` at (x, y) = (column, row) into dst; completes on bar.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// x rounded to bf16 (to nearest, ties to even: cvt.rn.bf16.f32) and back to
// fp32: the operand rounding of bf16 mode.
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// x, or x rounded to bf16 in bf16 mode.
template <bool Bf16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (Bf16) return round_bf16(x);
  return x;
}

// max(x, lo), NaN when x is NaN, as jnp.maximum keeps a NaN where fmaxf
// drops it: one max.NaN (FMNMX.NAN), fmaxf's max for every other x. Its NaN
// is 0x7fffffff. (The ReLU's backward stays a select, g where x > 0 else 0:
// XLA computes the Pallas kernel's g * (x > 0) as that select.)
__device__ __forceinline__ float max_keep_nan(float x, float lo) {
  float y;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(y) : "f"(x), "f"(lo));
  return y;
}

// The ReLU that keeps a NaN, on the integer pipe: as int32 the bits of a
// float >= +0 order as the float does and those of a float <= -0 are
// negative, so max(bits, 0) is fmaxf(x, 0.f) for every non-NaN x (-0 gives
// +0, as fmaxf does) and keeps a positive NaN, the only NaN fp32 arithmetic
// gives (0x7fffffff); its input is always such a sum.
__device__ __forceinline__ float relu_keep_nan(float x) { return __int_as_float(max(__float_as_int(x), 0)); }

// x with a positive NaN whose mantissa's high bits are all set (0x7fffefff <
// bits, as fp32 arithmetic's NaN 0x7fffffff) made 0x7fffefff: tf32_rna
// carries such a NaN into the sign bit and rounds it to -0, and 0x7fffefff
// to a NaN. One integer min; every other value keeps its bits. Every value
// a kernel writes to a product's operand (the activation and delta tiles,
// the scratches) goes through this, and every encoded input where it is
// staged (K1 and K1s's xs tile, B2's split pass).
__device__ __forceinline__ float tf32_safe_nan(float x) { return __int_as_float(min(__float_as_int(x), 0x7fffefff)); }

// ------------------------------------------------------------ 3xTF32 mma.sync

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away from
// zero: half a TF32 ulp added to the magnitude, the 13 low bits cleared), on
// the integer pipe. Finite inputs, and NaNs whose mantissa's high bits are
// not all set (tf32_safe_nan).
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

// A block's weight stream over the schedule Sched (see the note at the top):
// the ring at `buf` (kStages x kStageFloats floats, kRingAlign-aligned, then
// the full and the empty barriers), the products' tensor maps, and the
// stream's length. Every thread keeps its own copy, and all of them read the
// same slices in the same order. It uses the first Stages stages; the bf16
// K1s and B1 keep 3 and stage their bf16 epilogue in the last two
// (kSpillTileFloats).
template <class Sched, int Stages = kStages>
struct WeightRing {
  float* buf;
  const CUtensorMap* maps;
  int total;  // slices the block reads in all
  int j = 0;  // the next slice this thread reads

  __device__ uint64_t* full(int stage) const {
    return reinterpret_cast<uint64_t*>(buf + kStages * kStageFloats) + stage;
  }
  __device__ uint64_t* empty(int stage) const { return full(kStages) + stage; }

  // Every thread of the block calls it once, before any other use; it ends
  // with thread 0's first Stages - 1 slices in flight.
  __device__ WeightRing(float* ring, const CUtensorMap* weight_maps, int n_rows)
      : buf(ring), maps(weight_maps), total(stream_slices<Sched>(n_rows)) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < Stages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), kWarps);
      }
      mbar_init_fence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int n = 0; n < Stages - 1 && n < total; ++n) issue(n);
    }
  }

  // Thread 0: slice n of the stream into stage n % Stages, once every warp
  // has left the slice that held it before (n - Stages).
  __device__ void issue(int n) const {
    const int stage = n % Stages;
    if (n >= Stages) mbar_wait(empty(stage), (n / Stages - 1) & 1);
    const int p = n % schedule_slices<Sched>();
    int prod = 0, k0 = 0, rows = 0;
#pragma unroll
    for (int i = 0, first = 0; i < Sched::kProducts; first += Sched::k(i) / Sched::kDepth, ++i) {
      if (p >= first && p < first + Sched::k(i) / Sched::kDepth) {
        prod = i;
        k0 = (p - first) * Sched::kDepth;
        rows = Sched::n(i);
      }
    }
    mbar_arrive_expect_tx(full(stage), rows * Sched::kDepth * (int)sizeof(typename Sched::Elem));
    tma_load_2d(buf + stage * kStageFloats, maps + prod, full(stage), k0, 0);
  }

  // The next slice, once it has landed.
  __device__ const typename Sched::Elem* acquire() const {
    const int stage = j % Stages;
    mbar_wait(full(stage), (j / Stages) & 1);
    return reinterpret_cast<const typename Sched::Elem*>(buf + stage * kStageFloats);
  }

  // The warp has read the slice acquire() gave; thread 0 then refills the
  // stage of the slice before it.
  __device__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(j % Stages));
    if (threadIdx.x == 0 && j + Stages - 1 < total) issue(j + Stages - 1);
    ++j;
  }
};

// acc += A[:, :K] . W^T in 3xTF32, A (kRows x Lda) in shared memory and W
// (N x K, K % (8 Run) == 0) the product of the schedule whose slices come
// next in `ring`: B(k, n) = W[n][k] is read as the "col" operand from the
// slice's SWIZZLE_64B layout. K2's B1 streams the weights in their flax (in,
// out) layout, so it multiplies by the transpose; the forward streams the
// transposed copies, so it multiplies by the weight. A fresh accumulator
// sums each Run k8 steps (3 Run mma; one or more whole slices) and is added
// into acc in fp32, in k order. No block barrier: the caller orders any
// write to A after every warp's reads.
template <int N, int Lda, int Run, class Sched, int Stages>
__device__ __forceinline__ void gemm_wt(ChunkAcc<N>& acc, const float* A, int K, WeightRing<Sched, Stages>& ring) {
  static_assert(Sched::kDepth == kDepth && sizeof(typename Sched::Elem) == sizeof(float), "an fp32 stream");
  static_assert((8 * Run) % kDepth == 0, "a run is whole slices");
  constexpr int kRunSlices = 8 * Run / kDepth;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 32, c0 = (warp & 3) * (N / 4);
  const float* a_frag = A + (r0 + g) * Lda + t;
  // Row c0 + 8 ni + g of a slice, column t of each 16-byte chunk; the chunk
  // index is XORed with (row / 2) % 4 = (g / 2) % 4, the same for every ni.
  const int b_row = (c0 + g) * kDepth + t, swz = ((g >> 1) & 3) * 4;
  for (int k0 = 0; k0 < K; k0 += 8 * Run) {
    ChunkAcc<N> part;
    zero_acc(part);
#pragma unroll
    for (int r = 0; r < kRunSlices; ++r) {
      const float* ws = ring.acquire() + b_row;
#pragma unroll
      for (int kk = 0; kk < kDepth; kk += 8) {
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float* p = a_frag + 16 * mi * Lda + k0 + r * kDepth + kk;
          split_tf32(p[0], ab[mi][0], as[mi][0]);
          split_tf32(p[8 * Lda], ab[mi][1], as[mi][1]);
          split_tf32(p[4], ab[mi][2], as[mi][2]);
          split_tf32(p[8 * Lda + 4], ab[mi][3], as[mi][3]);
        }
#pragma unroll
        for (int ni = 0; ni < N / 32; ++ni) {
          const float* q = ws + 8 * kDepth * ni;
          uint32_t bb[2], bs[2];
          split_tf32(q[kk ^ swz], bb[0], bs[0]);
          split_tf32(q[(kk + 4) ^ swz], bb[1], bs[1]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_3xtf32(part[mi][ni], ab[mi], as[mi], bb, bs);
        }
      }
      ring.release();
    }
    add_into(acc, part);
  }
}

// ------------------------------------------------------- native bf16 mma.sync

// lo and hi rounded to bf16 (cvt.rn: to nearest, ties to even) and packed,
// lo in the low 16 bits, as a bf16 mma fragment register holds a pair.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 value held in the 16 bits u, as fp32 (exact).
__device__ __forceinline__ float bf16_bits_to_float(uint32_t u) { return __uint_as_float(u << 16); }

// The map of a bf16 scratch (K1s' saved, B1's deltas) for TMA stores of a
// block's chunk: kSpill columns x the block's rows x the blocks, boxes of 64
// columns x kRows rows with the 128-byte swizzle, so a chunk's rows past the
// block's end are not written; none in fp32.
template <bool Bf16>
struct SpillMap {};
template <>
struct SpillMap<true> {
  CUtensorMap map;
};

// Four 8x8 16-bit matrices from registers to shared memory: lanes 8j .. 8j +
// 7 give matrix j's row addresses (16 bytes each) and r[j] holds element
// (lane / 4, 2 (lane % 4) + e) of matrix j in its half e: an m16n8
// accumulator's bf16 pairs as they are held.
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(r[0]), "r"(r[1]),
               "r"(r[2]), "r"(r[3])
               : "memory");
}

// The byte offset in the bf16 tile of row r's 16-byte chunk c (its columns
// 8 c .. 8 c + 7): box c / 8, the chunk XORed with r % 8 in its row.
__device__ __forceinline__ uint32_t spill_tile_offset(int r, int c) {
  return (c >> 3) * kSpillBox + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// This warp's n8 tile ni of a chunk's kRows x N layer, the bf16 pairs of
// its 2 x 2 row blocks as the epilogue holds them (pairs[2 mi + h]: row 32
// (w / 4) + 16 mi + 8 h + lane / 4, columns (N / 4) (w % 4) + 8 ni + 2 (lane
// % 4)), into the bf16 tile at shared address `tile`: one stmatrix.x4,
// conflict-free (its eight rows of a 16-byte chunk land in eight different
// 16-byte bank groups).
template <int N>
__device__ __forceinline__ void stage_bf16(uint32_t tile, int ni, const uint32_t (&pairs)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = (warp >> 2) * 32 + ((lane >> 4) << 4) + (((lane >> 3) & 1) << 3) + (lane & 7);
  stmatrix_x4(tile + spill_tile_offset(r, (warp & 3) * (N / 32) + ni), pairs);
}

// Where the forward's epilogue saves a layer (Spill): in fp32 the chunk's
// rows of `saved` (row r at rows + r * kSpill), copied out of act by bulk
// copies; in bf16 mode the columns from `col` of the chunk at block row
// `row0` of the map's scratch, staged in the bf16 tile at shared address
// `tile`. + c moves to the layer c columns further.
template <bool Bf16>
struct SpillTo {
  float* rows;
  __device__ SpillTo operator+(int c) const { return {rows + c}; }
};
template <>
struct SpillTo<true> {
  const CUtensorMap* map;
  uint32_t tile;
  int row0, col;
  __device__ SpillTo operator+(int c) const { return {map, tile, row0, col + c}; }
};

// Thread 0: the chunk's rows of a layer (N columns of the bf16 tile) to the
// scratch by TMA stores, column col of the chunk starting at row row0 of the
// block's rows, as one committed bulk group under the L2::evict_first
// policy. The tile's writes must be complete (fence_proxy_async and a
// barrier); bulk_wait_read returns once the stores have read it.
template <int N>
__device__ __forceinline__ void store_spill_tile(const CUtensorMap* map, uint32_t tile, int col, int row0) {
  const uint64_t policy = evict_first_policy();
#pragma unroll
  for (int b = 0; b < N / 64; ++b)
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint [%0, {%2, %3, %4}], [%1], %5;\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(tile + b * kSpillBox), "r"(col + 64 * b), "r"(row0), "r"((int)blockIdx.x), "l"(policy)
        : "memory");
  bulk_commit();
}

// d += a . b for one m16n8k16 bf16 tile, fp32 accumulator. A (row, k) at
// a[0] (g, 2t..2t+1), a[1] (g+8, 2t..), a[2] (g, 2t+8..), a[3] (g+8, 2t+8..);
// B (k, col) at b0 (2t..2t+1, g), b1 (2t+8.., g); d as for mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += A[:, :K] . W^T on native bf16 products (mma.sync m16n8k16, fp32
// accumulators): A (kRows x Lda fp32 in shared memory, bf16 values, Lda = 4
// mod 32) and W (N x K, K % 32 == 0) the product of a bf16 stream whose
// 32-deep slices come next in `ring` (row n of a slice: 64 bytes,
// unswizzled). Warps own the tiles gemm_wt's do. Step s of a slice sums its
// columns 16 s .. 16 s + 15. Thread t holds two pairs of each step's columns,
// at 4 ((t & 1) ^ s) + 2 (t >> 1) and 8 past it (its k 2t..2t+1 and
// 2t+8..2t+9). It reads A as one float2 a pair, and packs each into a bf16
// pair (exact: the values are bf16). Load L (0-3) of a row reads the pair at
// 4 L + 2 (t >> 1) of step (t ^ L) & 1, so in every load a half warp (rows
// g..g+3, 4 banks apart) reads 16 pairs that cover the 32 banks once, where
// loading one step's pairs at once would put two threads on the same banks
// (its 16 columns are 16 banks, and rows 4 banks apart overlap). B comes as one 16-byte chunk a thread per n8 tile: the
// wrapper stores each 32-column block of a row permuted
// (fused_render.py's BF16_SLICE_ORDER), so that chunk t holds thread t's
// four pairs, step 0's then step 1's. A fresh accumulator sums each Run k16
// steps and is added into acc in fp32, in k order (Run == 1: every mma into
// zeros, then the add). No block barrier: the caller orders any write to A
// after every warp's reads.
template <int N, int Lda, int Run, class Sched, int Stages>
__device__ __forceinline__ void gemm_bf16(ChunkAcc<N>& acc, const float* A, int K, WeightRing<Sched, Stages>& ring) {
  static_assert(Sched::kDepth == 32 && sizeof(typename Sched::Elem) == 2, "a bf16 stream of 32-deep slices");
  static_assert(Run == 1 || Run % 2 == 0, "a run is one k16 step or whole slices");
  static_assert(Lda % 32 == 4, "conflict-free A reads");
  constexpr int kRunSlices = Run == 1 ? 1 : Run / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 32, c0 = (warp & 3) * (N / 4);
  const int odd = t & 1;
  // Loads 0 and 2 read step odd's columns, loads 1 and 3 the other step's.
  const float* a_even = A + (r0 + g) * Lda + 2 * (t >> 1) + 16 * odd;
  const float* a_odd = A + (r0 + g) * Lda + 2 * (t >> 1) + 16 * (1 - odd);
  const int b_off = (c0 + g) * 32 + 8 * t;  // row c0 + g of a slice, its chunk t
  for (int k0 = 0; k0 < K; k0 += 32 * kRunSlices) {
    [[maybe_unused]] ChunkAcc<N> part;
    if constexpr (Run > 1) zero_acc(part);
#pragma unroll
    for (int r = 0; r < kRunSlices; ++r) {
      const int ks = k0 + 32 * r;
      if (r > 0 && ks >= K) break;  // a run longer than the product
      const uint16_t* ws = ring.acquire() + b_off;
      uint32_t a[2][2][4];  // [mi][step]
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (16 * mi + 8 * h) * Lda + ks;
          uint32_t v[4];
#pragma unroll
          for (int L = 0; L < 4; ++L) {
            const float2 x = *reinterpret_cast<const float2*>((L & 1 ? a_odd : a_even) + row + 4 * L);
            v[L] = bf16x2_rn(x.x, x.y);
          }
          // step s's pairs: loads odd ^ s (k 2t..) and odd ^ s + 2 (k 2t+8..)
          a[mi][0][h] = odd ? v[1] : v[0];
          a[mi][0][2 + h] = odd ? v[3] : v[2];
          a[mi][1][h] = odd ? v[0] : v[1];
          a[mi][1][2 + h] = odd ? v[2] : v[3];
        }
#pragma unroll
      for (int ni = 0; ni < N / 32; ++ni) {
        const uint4 b = *reinterpret_cast<const uint4*>(ws + 8 * 32 * ni);
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const uint32_t b0 = s ? b.z : b.x, b1 = s ? b.w : b.y;
            if constexpr (Run == 1) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma_bf16(d, a[mi][s], b0, b1);
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[mi][ni][c] += d[c];
            } else {
              mma_bf16(part[mi][ni], a[mi][s], b0, b1);
            }
          }
      }
      ring.release();
    }
    if constexpr (Run > 1) add_into(acc, part);
  }
}

// act[r][c] = (relu)(acc + bias[c] (+ cterm[ray(r)][c])) for this thread's
// fragment elements (stride kAct), in place over the product's input, then a
// barrier so the next layer reads the whole new activation; with Bf16 each
// value rounded to bf16 (the operand of the next products and the heads, and
// what the spill saves). With Spill, the rows below valid_rows (N values
// each) go to `spill` as one committed bulk group that thread 0 issues
// after the barrier: in fp32 bulk copies of act's rows; in bf16 mode TMA
// stores of the bf16 tile, which every warp fills beside act (stage_bf16).
// The next product_done<true> waits for the group to finish reading.
template <int N, bool Spill, bool Bf16>
__device__ __forceinline__ void store_act(const ChunkAcc<N>& acc, const float* __restrict__ bias, bool relu,
                                          float* act, const float* cterm, int row0, int S, int n_rows,
                                          SpillTo<Bf16> spill, int valid_rows) {
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
    [[maybe_unused]] uint32_t pairs[4];
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
          x0 = relu_keep_nan(x0);
          x1 = relu_keep_nan(x1);
        }
        if constexpr (!Bf16) {  // the next product splits these into TF32 pairs
          x0 = tf32_safe_nan(x0);
          x1 = tf32_safe_nan(x1);
        }
        *reinterpret_cast<float2*>(act + (r0 + 16 * mi + 8 * h) * kAct + c) =
            make_float2(operand<Bf16>(x0), operand<Bf16>(x1));
        if constexpr (Spill && Bf16) pairs[2 * mi + h] = bf16x2_rn(x0, x1);
      }
    if constexpr (Spill && Bf16) stage_bf16<N>(spill.tile, ni, pairs);
  }
  if constexpr (Spill) fence_proxy_async();
  __syncthreads();
  if constexpr (Spill) {
    if (threadIdx.x == 0) {
      if constexpr (Bf16) {
        store_spill_tile<N>(spill.map, spill.tile, spill.col, spill.row0);
      } else {
        const uint64_t policy = evict_first_policy();
        for (int r = 0; r < valid_rows; ++r)
          bulk_store_row(spill.rows + (size_t)r * kSpill, act + r * kAct, N * 4, policy);
        bulk_commit();
      }
    }
  }
}

// After a forward product: every warp has finished reading its A (the
// activation tile or xs), and, with Spill, thread 0's bulk copies (or TMA
// stores) of the previous layer have finished reading their tile, so the
// epilogue may overwrite it.
template <bool Spill>
__device__ __forceinline__ void product_done() {
  if constexpr (Spill) {
    if (threadIdx.x == 0) bulk_wait_read();
  }
  __syncthreads();
}

// The forward's weight stream: fp32 slices of `wt`, or bf16 ones in bf16
// mode, on Stages stages of the ring.
template <bool Bf16, int Stages = kStages>
using FwdRing = WeightRing<std::conditional_t<Bf16, FwdBf16Schedule, FwdSchedule>, Stages>;

// acc += A[:, :K] . W, W the next product of the forward's stream: 3xTF32
// through gemm_wt in fp32, native bf16 through gemm_bf16 in bf16 mode.
template <int N, int Lda, bool Bf16, class Ring>
__device__ __forceinline__ void fwd_product(ChunkAcc<N>& acc, const float* A, int K, Ring& ring) {
  if constexpr (Bf16) gemm_bf16<N, Lda, kFwdBf16Run>(acc, A, K, ring);
  else gemm_wt<N, Lda, kFwdRun>(acc, A, K, ring);
}

// One 256-wide layer with ReLU, act = relu(A[:, :K] . W + bias), in place,
// W the next product of the stream.
template <int Lda, bool Spill, bool Bf16, class Ring>
__device__ __forceinline__ void dense_relu(const float* A, int K, Ring& ring, const float* bias, float* act,
                                           SpillTo<Bf16> spill, int valid_rows) {
  ChunkAcc<kWidth> acc;
  zero_acc(acc);
  fwd_product<kWidth, Lda, Bf16>(acc, A, K, ring);
  product_done<Spill>();
  store_act<kWidth, Spill, Bf16>(acc, bias, true, act, nullptr, 0, 1, 1, spill, valid_rows);
}

// Per-ray view-condition term: cterm[g][n] = venc[ray0+g] . wvb[:, n] (venc
// rounded in bf16 mode; wvb comes rounded).
template <bool Bf16>
__device__ __forceinline__ void view_terms(const float* __restrict__ venc, const float* __restrict__ wvb,
                                           float* cterm, int ray0, int ray_tile) {
  for (int i = threadIdx.x; i < ray_tile * kCondWidth; i += kThreads) {
    const int g = i / kCondWidth, n = i % kCondWidth;
    const float* v = venc + (size_t)(ray0 + g) * kView;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kView; ++k) s = fmaf(operand<Bf16>(__ldg(v + k)), __ldg(wvb + k * kCondWidth + n), s);
    cterm[i] = s;
  }
}

// The MLP on the chunk of rows [row0, row0 + kRows) of the block's n_rows
// packed samples: raw sigma to sig[row], raw rgb to rgb[3 row]. Biases and
// the narrow heads come from w, the product weights from the stream, in
// FwdSchedule's order (in bf16 mode all of them rounded, and the encoded
// inputs rounded as they are staged). With Spill,
// each layer's activation of the valid rows also goes to the saved-activation
// rows at `spill` (already offset to the chunk's first row). Ends with a
// barrier.
template <bool Spill, bool Bf16, class Ring>
__device__ __forceinline__ void forward_chunk(const float* __restrict__ xenc, const Weights& w, Ring& ring,
                                              const ForwardSmem& m, size_t row_base, int row0, int n_rows, int S,
                                              SpillTo<Bf16> spill) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int valid_rows = min(kRows, n_rows - row0);
  float* act = m.act;
  // Encoded inputs of this chunk; padded rows and the pad column are 0. In
  // fp32 each is made TF32-safe (the products split it into TF32 pairs: a
  // NaN of the card's sin, 0x7fffffff, would read as 0); in bf16 mode it is
  // rounded, which keeps a NaN.
  const float* xg = xenc + (row_base + row0) * kPos;
  for (int i = threadIdx.x; i < kRows * kPosPad; i += kThreads) {
    const int r = i / kPosPad, c = i % kPosPad;
    float x = 0.f;
    if (r < valid_rows && c < kPos) {
      x = __ldg(xg + r * kPos + c);
      x = Bf16 ? round_bf16(x) : tf32_safe_nan(x);
    }
    m.xs[r * kXs + c] = x;
  }
  __syncthreads();

  dense_relu<kXs, Spill, Bf16>(m.xs, kPosPad, ring, w.b0, act, spill, valid_rows);  // w0
  dense_relu<kAct, Spill, Bf16>(act, kWidth, ring, w.b1, act, spill + kWidth, valid_rows);
  dense_relu<kAct, Spill, Bf16>(act, kWidth, ring, w.b2, act, spill + 2 * kWidth, valid_rows);
  dense_relu<kAct, Spill, Bf16>(act, kWidth, ring, w.b3, act, spill + 3 * kWidth, valid_rows);
  dense_relu<kAct, Spill, Bf16>(act, kWidth, ring, w.b4, act, spill + 4 * kWidth, valid_rows);
  {  // skip layer: relu(h . w5x + x_enc . w5i + b5), one accumulator
    ChunkAcc<kWidth> a5;
    zero_acc(a5);
    fwd_product<kWidth, kAct, Bf16>(a5, act, kWidth, ring);  // w5x
    fwd_product<kWidth, kXs, Bf16>(a5, m.xs, kPosPad, ring);  // w5i
    product_done<Spill>();
    store_act<kWidth, Spill, Bf16>(a5, w.b5, true, act, nullptr, 0, 1, 1, spill + 5 * kWidth, valid_rows);
  }
  dense_relu<kAct, Spill, Bf16>(act, kWidth, ring, w.b6, act, spill + 6 * kWidth, valid_rows);
  dense_relu<kAct, Spill, Bf16>(act, kWidth, ring, w.b7, act, spill + 7 * kWidth, valid_rows);

  // Density head (256 -> 1), one warp per row.
  const float bd = __ldg(w.bd);
  for (int r = warp; r < valid_rows; r += kWarps) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(act[r * kAct + lane + 32 * i], __ldg(w.wd + lane + 32 * i), s);
    s = warp_sum(s);
    if (lane == 0) m.sig[row0 + r] = s + bd;
  }
  {  // bottleneck (no activation), in place; product_done's barrier orders
     // it after the density reads
    ChunkAcc<kWidth> ab;
    zero_acc(ab);
    fwd_product<kWidth, kAct, Bf16>(ab, act, kWidth, ring);  // wb
    product_done<Spill>();
    store_act<kWidth, Spill, Bf16>(ab, w.bb, false, act, nullptr, 0, 1, 1, spill + kSpillBtl, valid_rows);
  }
  {  // view layer: relu(btl . wva + cterm[ray] + bv) -> act[:, :128]
    ChunkAcc<kCondWidth> av;
    zero_acc(av);
    fwd_product<kCondWidth, kAct, Bf16>(av, act, kWidth, ring);  // wva
    product_done<Spill>();
    store_act<kCondWidth, Spill, Bf16>(av, w.bv, true, act, m.cterm, row0, S, n_rows, spill + kSpillView,
                                       valid_rows);
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
  const float sigma = max_keep_nan(raw_sigma, 0.f);
  a.expterm = expf(-sigma * a.dist);
  a.alpha = 1.f - a.expterm;
  a.logv = logf(max_keep_nan(1.f - a.alpha + 1e-10f, 1e-10f));
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
// With Bf16 each log term is rounded to bf16 before the prefix sum.
template <bool Bf16>
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
      const float wgt = a.alpha * warp_transmittance(operand<Bf16>(a.logv), carry);
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
