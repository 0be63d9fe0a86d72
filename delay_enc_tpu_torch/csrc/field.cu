// K-a: batched elementwise Fr / Fq arithmetic (mont_mul, add, sub).
//
// Replaces delay_enc_tpu/ops/limbs.py mont_mul (:496), add (:397) and
// sub (:401), which XLA fused into elementwise limb-chain kernels.
//
// out[i] = op(a[ai], b[bi]) with ai = (i / adiv) % amod (likewise bi), so
// a scalar (1, 8) operand, a column repeated over a batch, or a per-row
// constant is read in place instead of being materialised.
//
// Bound: memory.  Each output reads two 32-byte operands and writes one:
// 96 B per element, e.g. about 1 GB (0.3 ms at 3.35 TB/s) for the
// (19, 2^19) extended stack.  A Montgomery product is 128 wide multiplies,
// well under the card's integer rate per byte moved.  One thread per
// element with 16-byte vector loads; nothing is staged in shared memory.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

__device__ __forceinline__ void load8(uint32_t r[8], const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  uint4 lo = q[0], hi = q[1];
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t r[8]) {
  uint4* q = reinterpret_cast<uint4*>(p);
  q[0] = make_uint4(r[0], r[1], r[2], r[3]);
  q[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

template <int F, int OP>
__global__ void field_binary_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b,
                                    uint32_t* __restrict__ out, uint32_t n,
                                    uint32_t adiv, uint32_t amod,
                                    uint32_t bdiv, uint32_t bmod) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t ai = (i / adiv) % amod;
  const uint32_t bi = (i / bdiv) % bmod;
  uint32_t x[8], y[8], r[8];
  load8(x, a + (size_t)ai * 8);
  load8(y, b + (size_t)bi * 8);
  if (OP == OP_MUL) {
    fld::mont_mul<F>(r, x, y);
  } else if (OP == OP_ADD) {
    fld::add<F>(r, x, y);
  } else {
    fld::sub<F>(r, x, y);
  }
  store8(out + (size_t)i * 8, r);
}

template <int F, int OP>
void launch(const void* a, const void* b, void* out, uint32_t n, uint32_t adiv,
            uint32_t amod, uint32_t bdiv, uint32_t bmod, cudaStream_t s) {
  const int threads = 256;
  const uint32_t blocks = (n + threads - 1) / threads;
  field_binary_kernel<F, OP><<<blocks, threads, 0, s>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, adiv, amod, bdiv, bmod);
}

}  // namespace

extern "C" int field_binary(int op, int field, const void* a, const void* b,
                            void* out, unsigned n, unsigned adiv, unsigned amod,
                            unsigned bdiv, unsigned bmod, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (field == fld::FR) {
    if (op == OP_MUL) launch<fld::FR, OP_MUL>(a, b, out, n, adiv, amod, bdiv, bmod, s);
    else if (op == OP_ADD) launch<fld::FR, OP_ADD>(a, b, out, n, adiv, amod, bdiv, bmod, s);
    else launch<fld::FR, OP_SUB>(a, b, out, n, adiv, amod, bdiv, bmod, s);
  } else {
    if (op == OP_MUL) launch<fld::FQ, OP_MUL>(a, b, out, n, adiv, amod, bdiv, bmod, s);
    else if (op == OP_ADD) launch<fld::FQ, OP_ADD>(a, b, out, n, adiv, amod, bdiv, bmod, s);
    else launch<fld::FQ, OP_SUB>(a, b, out, n, adiv, amod, bdiv, bmod, s);
  }
  return (int)cudaGetLastError();
}
