// K-b: a batched natural-order radix-2 NTT over Fr, several stages a launch.
//
// Replaces delay_enc_tpu/ops/ntt.py stockham (:85), the transform behind
// plonk/kernels.py _coeff, _ext, _evals_batch and _quotient.  It computes
// the same evaluations, A[j] = sum_i a[i] w^(i j) in natural order, so every
// word equals the JAX package's; the decomposition is this card's own.
//
// A launch is one pass (csrc/ntt_tile.cuh): a block loads a tile of 2^s rows
// by 2^c_log columns into shared memory, runs s stages there, and stores the
// tile where the next pass, or the caller, reads it in natural order.  A
// transform of length 2^16 is two passes of 8 stages, one of 2^19 two passes
// of 10 and 9 (ops/ntt.py:plan), where one launch a stage moved every
// element through device memory 16 and 19 times.  The first pass can read a
// shorter row as zero-padded and multiply a per-index table in as it loads
// (the coset scaling of _ext); the last can multiply by one constant (1/n)
// or by a per-index table (1/n and zeta^-i at once) as it stores.
//
// Bound: operations.  Two or three passes move 128-192 B an element, about
// 1.3 GB for the (19, 2^19) transform (0.4 ms at 3.35 TB/s), against 1.45 ms
// for its 9.5 x 19 x 2^19 Montgomery products at the card's integer rate.
// An element is one whole 32-byte sector, so a strided gather of elements
// wastes no sector; twiddles come from one table of n / 2 powers, 8 MB at
// 2^19, which stays in L2.  Shared memory holds word planes with a skew, so
// neither the butterflies nor the bit-reversed store meet bank conflicts.
//
// NTT_PORTABLE keeps field.cuh's portable bodies on the device for this
// kernel alone (tools/torch_msm_bench.py times the two against each other).

#include <cuda_runtime.h>

#ifdef NTT_PORTABLE
#ifndef FLD_PORTABLE
#define FLD_PORTABLE
#endif
#endif
#include "ntt_tile.cuh"

// The most threads a block may have, and the blocks an SM should hold: with
// 256 and 4 a thread may use 64 registers.
#ifndef NTT_MAX_THREADS
#define NTT_MAX_THREADS 256
#endif
#ifndef NTT_MIN_BLOCKS
#define NTT_MIN_BLOCKS 4
#endif

namespace {

__global__ void __launch_bounds__(NTT_MAX_THREADS, NTT_MIN_BLOCKS)
ntt_fused_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst,
                 const uint32_t* __restrict__ tw, const uint32_t* __restrict__ in_tab,
                 const uint32_t* __restrict__ out_tab, ntt::Pass P) {
  extern __shared__ uint32_t sm[];
  const uint32_t log_groups = P.log_n - P.s - P.c_log;
  const uint32_t row = blockIdx.x >> log_groups;
  const uint32_t group = blockIdx.x & ((1u << log_groups) - 1u);
  const uint32_t* src_row = src + (size_t)row * P.n_in * 8;
  uint32_t* dst_row = dst + ((size_t)row << P.log_n) * 8;
  ntt::tile_load(P, group, threadIdx.x, blockDim.x, sm, src_row, in_tab);
  __syncthreads();
  for (uint32_t u = 0; u < P.s; u++) {
    ntt::tile_stage(P, u, group, threadIdx.x, blockDim.x, sm, tw);
    __syncthreads();
  }
  ntt::tile_store(P, group, threadIdx.x, blockDim.x, sm, dst_row, out_tab);
}

}  // namespace

// One pass over `batch` rows.  Source rows hold n_in elements, destination
// rows 2^log_n.  in_tab and out_tab may be null (out_tab with out_mode 0).
extern "C" int ntt_fused(const void* src, void* dst, const void* tw, const void* in_tab,
                         const void* out_tab, unsigned batch, unsigned log_n, unsigned t0,
                         unsigned s, unsigned c_log, unsigned n_in, unsigned nz,
                         unsigned out_mode, unsigned threads, void* stream) {
  if (batch == 0) return 0;
  if (s + c_log > log_n || t0 + s > log_n || threads == 0 || threads > NTT_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const ntt::Pass P = {log_n, t0, s, c_log, n_in, nz, out_mode};
  const size_t bytes = (size_t)8 * ntt::plane_words(1u << (s + c_log)) * sizeof(uint32_t);
  static size_t allowed = 48 * 1024;
  if (bytes > allowed) {
    cudaError_t rc = cudaFuncSetAttribute(
        ntt_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (rc != cudaSuccess) return (int)rc;
    allowed = bytes;
  }
  const size_t blocks = (size_t)batch << (log_n - s - c_log);
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  ntt_fused_kernel<<<(unsigned)blocks, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(in_tab),
      static_cast<const uint32_t*>(out_tab), P);
  return (int)cudaGetLastError();
}
