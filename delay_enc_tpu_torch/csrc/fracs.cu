// K5: the numerators and denominators of the five grand products.
//
// Replaces delay_enc_tpu/plonk/kernels.py _jit_compress (:102),
// _jit_perm_fracs (:109) and _jit_lookup_fracs (:125), with the stacking
// and the inactive-row mask of the prover around them
// (delay_enc_tpu/plonk/prover.py), which the port ran as 93
// elementwise K-a launches, two `stack` copies and a `where`.
//
// One thread a row, the body in csrc/fracs_row.cuh: it reads 27 columns at
// its row and writes 10.  A launch serves up to prow::MAX_INSTANCES
// instances of one circuit (the batched prover's vmap over
// _jit_perm_fracs_batch, _jit_lookup_fracs_batch and _jit_compress_b,
// delay_enc_tpu/plonk/batch_prover.py:71-92): blockIdx.y is the instance,
// which picks its witness columns and its challenge block; the key's rows,
// sigma and omega are shared.  The challenge blocks go by value in one
// kernel parameter (prow::Batch), so a launch needs no copy to the card
// before it; each block copies its instance's 512 bytes into shared memory.
//
// Bound: operations, narrowly.  A row makes 40 Montgomery products: at
// delay_enc k=16 (2^16 rows) about 0.040 ms an instance at 1.673e13
// multiply-adds a second, against 0.023 ms to move 37 columns at 3.35 TB/s.

#include <cuda_runtime.h>

#include <cstring>

#include "fracs_row.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
fracs_kernel(const __grid_constant__ prow::FracsIn in,
             const __grid_constant__ prow::Batch consts) {
  // the challenges' address is taken: __grid_constant__ reads them in place
  __shared__ prow::Consts c;
  const uint32_t* src = &consts.c[blockIdx.y].w[0][0];
  for (int t = threadIdx.x; t < prow::NCONST * prow::NW; t += THREADS) (&c.w[0][0])[t] = src[t];
  __syncthreads();
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < in.n) prow::fracs_row(i, prow::fracs_instance(in, blockIdx.y), c);
}

}  // namespace

// For `count` instances: raw6 (count, 6, n, 8), sigma (6, n, 8), omega
// (n, 8), key_raw (>= 15, n, 8), lk (count, 8, n, 8) on the card; consts:
// host memory, `count` prow::Consts; num and den (count, 5, n, 8).
extern "C" int gp_fracs(const void* raw6, const void* sigma, const void* omega,
                        const void* key_raw, const void* lk, const void* consts, void* num,
                        void* den, unsigned long long n, unsigned long long usable,
                        unsigned count, void* stream) {
  if (count > (unsigned)prow::MAX_INSTANCES) return (int)cudaErrorInvalidValue;
  if (n == 0 || count == 0) return 0;
  prow::FracsIn in;
  in.raw6 = static_cast<const uint32_t*>(raw6);
  in.sigma = static_cast<const uint32_t*>(sigma);
  in.omega = static_cast<const uint32_t*>(omega);
  in.key_raw = static_cast<const uint32_t*>(key_raw);
  in.lk = static_cast<const uint32_t*>(lk);
  in.num = static_cast<uint32_t*>(num);
  in.den = static_cast<uint32_t*>(den);
  in.n = n;
  in.usable = usable;
  prow::Batch c;
  std::memcpy(c.c, consts, count * sizeof(prow::Consts));
  const unsigned long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  fracs_kernel<<<dim3((unsigned)blocks, count), THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(in, c);
  return (int)cudaGetLastError();
}
