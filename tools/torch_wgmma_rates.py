"""Time the int8 warpgroup MMA (wgmma.mma_async.m64nNk32.s32.u8.u8) at each
width N, with A from registers (RS) or from shared memory (SS), and the
bulk copy (TMA's cp.async.bulk) from global to shared memory, on one card:
the rates K11's product (csrc/ntt_mxu.cu) was designed from.

    python3 tools/torch_wgmma_rates.py

It writes a small CUDA program into delay_enc_tpu_torch/build/wgmma_rates/,
builds it with nvcc for sm_90a and runs it.  Every SM runs one block of
two warpgroups (one or three for some RS lines) that issue groups of 32
wgmmas back to back on operands in shared memory (no swizzle, K-major);
each line gives the SM clocks a wgmma takes (the SM's, both warpgroups
together) and the int8 multiply-adds an SM a clock against the tensor
cores' 4096.  The bulk lines stream chunks of 8, 32 or 64 KB from a span
of 8 MB, 32 MB or 1 GB into two shared-memory stages, one thread a block,
every SM at once.  It prints the card's name and power limit first.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "delay_enc_tpu_torch", "build", "wgmma_rates")
WIDTHS = (8, 16, 32, 64, 128)


def _rs(n: int) -> str:
    k = n // 2
    regs = ", ".join(f"%{i}" for i in range(k))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(k))
    return (f"__device__ __forceinline__ void mma_rs_{n}(uint32_t* d, const uint32_t* a, "
            f"uint64_t b) {{\n  asm volatile(\"{{\\n .reg .pred p;\\n setp.ne.b32 p, "
            f"%{k + 5}, 0;\\n wgmma.mma_async.sync.aligned.m64n{n}k32.s32.u8.u8 {{{regs}}}, "
            f"{{%{k}, %{k + 1}, %{k + 2}, %{k + 3}}}, %{k + 4}, p;\\n}}\"\n"
            f"   : {outs} : \"r\"(a[0]), \"r\"(a[1]), \"r\"(a[2]), \"r\"(a[3]), "
            f"\"l\"(b), \"r\"(1));\n}}\n")


def _ss(n: int) -> str:
    k = n // 2
    regs = ", ".join(f"%{i}" for i in range(k))
    outs = ", ".join(f'"+r"(d[{i}])' for i in range(k))
    return (f"__device__ __forceinline__ void mma_ss_{n}(uint32_t* d, uint64_t a, "
            f"uint64_t b) {{\n  asm volatile(\"{{\\n .reg .pred p;\\n setp.ne.b32 p, "
            f"%{k + 2}, 0;\\n wgmma.mma_async.sync.aligned.m64n{n}k32.s32.u8.u8 {{{regs}}}, "
            f"%{k}, %{k + 1}, p;\\n}}\"\n   : {outs} : \"l\"(a), \"l\"(b), \"r\"(1));\n}}\n")


BODY = r"""__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}
#define FENCE asm volatile("wgmma.fence.sync.aligned;" ::: "memory")
#define COMMIT asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory")
#define WAIT(n) asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(n) : "memory")

template <int N, bool RS, int WGS>
__global__ void __launch_bounds__(128 * WGS, 1) mma_bench(unsigned long long* out, int iters) {
  extern __shared__ __align__(1024) uint8_t smem[];
  for (int i = threadIdx.x; i < 65536 / 4; i += blockDim.x) ((uint32_t*)smem)[i] = i * 2654435761u;
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  constexpr int SETS = 256 / N;   // 128 accumulator registers
  uint32_t acc[SETS][N / 2];
  for (int s = 0; s < SETS; s++) for (int r = 0; r < N / 2; r++) acc[s][r] = 0;
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3, threadIdx.x * 5, threadIdx.x * 7};
  const uint64_t db = desc(base + 32768), da = desc(base);
  __syncthreads();
  unsigned long long t0 = clock64();
  for (int it = 0; it < iters; it++) {
    FENCE;
#pragma unroll
    for (int j = 0; j < 32; j++) {
      if constexpr (RS) {
        if constexpr (N == 8) mma_rs_8(acc[j % SETS], a, db + ((j * 16) & 511));
        if constexpr (N == 16) mma_rs_16(acc[j % SETS], a, db + ((j * 32) & 511));
        if constexpr (N == 32) mma_rs_32(acc[j % SETS], a, db + ((j * 64) & 511));
        if constexpr (N == 64) mma_rs_64(acc[j % SETS], a, db + ((j * 128) & 511));
        if constexpr (N == 128) mma_rs_128(acc[j % SETS], a, db);
      } else {
        if constexpr (N == 8) mma_ss_8(acc[j % SETS], da + ((j * 128) & 511), db + ((j * 16) & 511));
        if constexpr (N == 16) mma_ss_16(acc[j % SETS], da + ((j * 128) & 511), db + ((j * 32) & 511));
        if constexpr (N == 32) mma_ss_32(acc[j % SETS], da + ((j * 128) & 511), db + ((j * 64) & 511));
        if constexpr (N == 64) mma_ss_64(acc[j % SETS], da + ((j * 128) & 511), db + ((j * 128) & 511));
        if constexpr (N == 128) mma_ss_128(acc[j % SETS], da, db);
      }
    }
    COMMIT;
    WAIT(1);
  }
  WAIT(0);
  unsigned long long t1 = clock64();
  uint32_t x = 0;
  for (int s = 0; s < SETS; s++) for (int r = 0; r < N / 2; r++) x ^= acc[s][r];
  if (threadIdx.x == 0) out[blockIdx.x] = t1 - t0;
  if (x == 0x12345678u) out[gridDim.x + 1] = x;
}

// bulk copies: one thread a block streams CH-byte chunks of a buffer into two stages
__global__ void bulk_bench(const uint8_t* src, size_t span, int chunks, int ch, unsigned long long* out) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ __align__(8) uint64_t bar[2];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t b0 = (uint32_t)__cvta_generic_to_shared(bar);
  if (threadIdx.x != 0) return;
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b0));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b0 + 8));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  unsigned long long t0 = clock64();
  uint32_t ph[2] = {0, 0};
  for (int i = 0; i < chunks; i++) {
    const int s = i & 1;
    if (i >= 2) {
      uint32_t ok = 0;
      while (!ok) asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }" : "=r"(ok) : "r"(b0 + 8 * s), "r"(ph[s]) : "memory");
      ph[s] ^= 1;
    }
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" :: "r"(b0 + 8 * s), "r"(ch) : "memory");
    const uint8_t* p = src + ((size_t)(blockIdx.x * 7 + i) * ch) % span;
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" :: "r"(base + s * ch), "l"(p), "r"(ch), "r"(b0 + 8 * s) : "memory");
  }
  for (int s = 0; s < 2; s++) {
    uint32_t ok = 0;
    while (!ok) asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }" : "=r"(ok) : "r"(b0 + 8 * s), "r"(ph[s]) : "memory");
  }
  out[blockIdx.x] = clock64() - t0;
}

template <int N, bool RS, int WGS>
void run_mma(int sms) {
  unsigned long long* d; cudaMalloc(&d, 8 * (sms + 4));
  auto k = mma_bench<N, RS, WGS>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  const int iters = 2000;
  k<<<sms, 128 * WGS, 65536>>>(d, 10);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0);
  k<<<sms, 128 * WGS, 65536>>>(d, iters);
  cudaEventRecord(e1); cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  unsigned long long h[1]; cudaMemcpy(h, d, 8, cudaMemcpyDeviceToHost);
  double macs = (double)sms * WGS * iters * 32 * 64.0 * N * 32;
  double clk_per = (double)h[0] / (iters * 32.0 * WGS);
  printf("{\"mma\": \"%s\", \"N\": %d, \"wgs\": %d, \"err\": \"%s\", \"ms\": %.4f, \"macs_per_sm_clk\": %.1f, \"clk_per_wgmma_per_sm\": %.2f, \"tops_int8\": %.1f}\n",
         RS ? "RS" : "SS", N, WGS, cudaGetErrorString(cudaGetLastError()), ms,
         64.0 * N * 32 / clk_per, clk_per, 2 * macs / (ms * 1e-3) / 1e12);
  cudaFree(d);
}

int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run_mma<8, true, 1>(sms); run_mma<8, true, 2>(sms); run_mma<8, true, 3>(sms);
  run_mma<16, true, 2>(sms); run_mma<32, true, 2>(sms); run_mma<64, true, 2>(sms); run_mma<128, true, 2>(sms);
  run_mma<8, false, 2>(sms); run_mma<16, false, 2>(sms); run_mma<32, false, 2>(sms); run_mma<64, false, 2>(sms); run_mma<128, false, 2>(sms);
  // bulk copy rate from an L2-resident span and from a large one
  uint8_t* src; size_t big = (size_t)1 << 30; cudaMalloc(&src, big); cudaMemset(src, 1, big);
  unsigned long long* d; cudaMalloc(&d, 8 * sms);
  for (size_t span : {(size_t)8 << 20, (size_t)32 << 20, big})
    for (int ch : {8192, 32768, 65536}) {
      const int chunks = (int)(((size_t)2048 << 20) / ch / sms) + 2;
      cudaFuncSetAttribute(bulk_bench, cudaFuncAttributeMaxDynamicSharedMemorySize, 2 * ch);
      bulk_bench<<<sms, 32, 2 * ch>>>(src, span, 4, ch, d);
      cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
      cudaEventRecord(e0);
      bulk_bench<<<sms, 32, 2 * ch>>>(src, span, chunks, ch, d);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double bytes = (double)sms * chunks * ch;
      printf("{\"bulk\": %d, \"span_mb\": %zu, \"err\": \"%s\", \"ms\": %.4f, \"tb_s\": %.3f, \"bytes_per_sm_clk_at_1980_mhz\": %.2f}\n",
             ch, span >> 20, cudaGetErrorString(cudaGetLastError()), ms, bytes / (ms * 1e-3) / 1e12,
             bytes / sms / (ms * 1e-3 * 1.98e9));
    }
  return 0;
}
"""


def main() -> int:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise SystemExit("nvcc not found")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "wgmma_rates.cu")
    with open(src, "w") as f:
        f.write("#include <cstdio>\n#include <cstdint>\n#include <cuda_runtime.h>\n")
        f.write("".join(_rs(n) for n in WIDTHS) + "".join(_ss(n) for n in WIDTHS))
        f.write(BODY)
    exe = os.path.join(OUT, "wgmma_rates")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
                    "-o", exe, src], check=True)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
