// K6: the fused quotient expression on the extended coset, times 1/Z_H.
//
// Replaces delay_enc_tpu/plonk/kernels.py _quotient_expr (:192) and the
// `* zh_inv_ext` of _jit_quotient (:294, :302), which XLA fused into limb
// chains over (n_ext, 16) operands, and which the port ran as 70
// elementwise K-a launches and the `stack` and `roll` copies around them.
// The inverse transform that follows (csrc/ntt.cu, with zeta^-i / n_ext in
// its last store) is unchanged.
//
// The same kernel is K9's per-coset quotient, _jit_quotient_coset (:337):
// the split quotient (k >= 18) runs it once on each of the 8 size-n cosets
// with rot = 1 and one value of 1/Z_H, and each launch stores its rows at
// stride 8 and offset j straight into the interleaved extended coset, so the
// swapaxes copy of _jit_interleave_intt (:361) has no counterpart here.  A
// row's 32 bytes are one whole sector, so the strided store moves no more
// bytes than a dense one.  At k=18 the 8 coset launches make the products of
// one fused launch of 2^21 rows, 3.72 ms at the integer rate.
//
// One thread a row, the body in csrc/quotient_row.cuh: it reads 43 columns
// of the witness and key stacks and X at its row (and 6 columns at the next
// or previous row, which the neighbouring block has read into L2), folds
// the 24 expressions into one accumulator as it goes, and writes h.
//
// A fused launch serves up to prow::MAX_INSTANCES instances of one circuit
// (the batched prover's vmap, _jit_quotient_batch,
// delay_enc_tpu/plonk/batch_prover.py:98): blockIdx.y is the instance, which
// picks its (19, n, 8) witness stack, its challenge block (prow::Batch, by
// value) and its n rows of h; the key stack, X and 1/Z_H are shared.  The
// coset form runs one instance: the batched prover has no split mode.
//
// Bound: operations.  A row makes 116 Montgomery products of 128 wide
// multiplies: at delay_enc k=16 (2^19 rows) 0.93 ms an instance at 1.673e13
// multiply-adds a second, against 0.23 ms to read 44 columns and write one
// at 3.35 TB/s.  So the design spends nothing to save bytes: no tiling in
// shared memory, the neighbouring rows read again from global memory, the
// challenge words in shared memory.  Loops over columns stay rolled to keep
// the code within the instruction caches.

#include <cuda_runtime.h>

#include <cstring>

#include "quotient_row.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
quotient_kernel(const __grid_constant__ prow::QuotientIn in,
                const __grid_constant__ prow::Batch consts) {
  // the challenges' address is taken: __grid_constant__ reads them in place
  __shared__ prow::Consts c;
  const uint32_t* src = &consts.c[blockIdx.y].w[0][0];
  for (int t = threadIdx.x; t < prow::NCONST * prow::NW; t += THREADS) (&c.w[0][0])[t] = src[t];
  __syncthreads();
  const size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < in.n) prow::quotient_row(i, prow::quotient_instance(in, blockIdx.y), c);
}

}  // namespace

// For `count` instances: wit (count, 19, n, 8), key (24, n, 8), x (n, 8),
// zh_inv (rot, 8) on the card; consts: host memory, `count` prow::Consts;
// h: instance b's row i at (b * n + i) * out_stride + out_offset.  rot: 8
// on the fused extended coset, 1 on a coset of the split quotient.
extern "C" int quotient_h(const void* wit, const void* key, const void* x, const void* zh_inv,
                          const void* consts, void* h, unsigned long long n,
                          unsigned long long rot, unsigned long long out_stride,
                          unsigned long long out_offset, unsigned count, void* stream) {
  if (count > (unsigned)prow::MAX_INSTANCES) return (int)cudaErrorInvalidValue;
  if (n == 0 || count == 0) return 0;
  if (rot == 0 || (rot & (rot - 1)) || n < rot || out_stride == 0)
    return (int)cudaErrorInvalidValue;
  prow::QuotientIn in;
  in.wit = static_cast<const uint32_t*>(wit);
  in.key = static_cast<const uint32_t*>(key);
  in.x = static_cast<const uint32_t*>(x);
  in.zh_inv = static_cast<const uint32_t*>(zh_inv);
  in.h = static_cast<uint32_t*>(h);
  in.n = n;
  in.rot = rot;
  in.out_stride = out_stride;
  in.out_offset = out_offset;
  prow::Batch c;
  std::memcpy(c.c, consts, count * sizeof(prow::Consts));
  const unsigned long long blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  quotient_kernel<<<dim3((unsigned)blocks, count), THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(in, c);
  return (int)cudaGetLastError();
}
