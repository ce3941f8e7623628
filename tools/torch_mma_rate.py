#!/usr/bin/env python3
"""The issue rate of mma.sync m16n8k8 TF32 on one CUDA card.

    python3 tools/torch_mma_rate.py

Builds (with the ``nvcc`` the kernels are built with, for sm_90a) and runs a
kernel whose warps do nothing but mma.sync m16n8k8 TF32 into independent
accumulators, at 2, 4 and 8 warps a SM sub-partition and 4 to 24
accumulators a warp, and prints one JSON line: for each, the SM clocks per
mma a sub-partition (clock64 around the loop, the slowest block) and the
TF32 rate over the launch (CUDA events). The 3xTF32 products of K1, K1s,
B1 and B2 issue three such mma a product, so this rate bounds them from
below, beside the 495 TFLOP/s TF32 peak of wgmma. The binary goes to the
git-ignored ``build/`` at the repo's root.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = r"""
#include <cstdio>
#include <cstdint>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
               "{%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int NACC>
__global__ void bench(float* out, long long* cyc, int iters) {
  float acc[NACC][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  __syncthreads();
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma_tf32(acc[j], a, b0, b1);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int j = 0; j < NACC; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}
template <int NACC>
void run(int blocks_per_sm) {
  const int threads = 256, iters = 2048;
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int blocks = sms * blocks_per_sm;
  float* out;
  long long* cyc;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaMalloc(&cyc, sizeof(long long) * blocks);
  bench<NACC><<<blocks, threads>>>(out, cyc, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<NACC><<<blocks, threads>>>(out, cyc, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  long long* h = new long long[blocks];
  cudaMemcpy(h, cyc, sizeof(long long) * blocks, cudaMemcpyDeviceToHost);
  long long slowest = 0;
  for (int i = 0; i < blocks; ++i) slowest = h[i] > slowest ? h[i] : slowest;
  const double warps = threads / 32.0 * blocks_per_sm / 4.0, mma = warps * iters * NACC;
  printf("%d %g %.4f %.4f %.2f\n", NACC, warps, slowest / mma, ms, 2048.0 * mma * 4 * sms / (ms * 1e-3) / 1e12);
  cudaFree(out);
  cudaFree(cyc);
  delete[] h;
}
int main() {
  run<8>(1); run<4>(2); run<8>(2); run<16>(2); run<24>(2); run<8>(4);
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def main() -> None:
    sys.path.insert(0, ROOT)
    from aonerf_torch.ops.kernels import build

    out_dir = os.path.join(ROOT, "build", "mma_rate")
    os.makedirs(out_dir, exist_ok=True)
    src, exe = os.path.join(out_dir, "mma_rate.cu"), os.path.join(out_dir, "mma_rate")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([build.nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o", exe, src], check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    runs = []
    for line in subprocess.run([exe], capture_output=True, text=True, check=True).stdout.split("\n"):
        if line.strip():
            acc, warps, clocks, ms, tflops = line.split()
            runs.append({"accumulators_a_warp": int(acc), "warps_a_subpartition": float(warps),
                         "clocks_per_mma": float(clocks), "ms": float(ms), "tf32_tflops": float(tflops)})
    print(json.dumps({"card": smi, "mma": "mma.sync.m16n8k8 tf32", "runs": runs}), flush=True)


if __name__ == "__main__":
    main()
