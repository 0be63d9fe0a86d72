// K-a: batched elementwise Fr / Fq arithmetic (mont_mul, add, sub);
// field_pow: every element raised to one host-known exponent; and
// field_wide_to_mont: 512-bit rows into Montgomery form.
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
//
// field_pow replaces delay_enc_tpu/ops/limbs.py mont_pow (:539) and inv
// (:551, a lax.scan of 256 squarings, products and selects), chains of K1
// graphs.  One thread an element runs fld::mont_pow: the exponent (up to
// 256 bits, e = p - 2 for an inversion) comes by value in the launch's
// parameters, so every thread walks the same bits and no warp diverges.
// Bound: operations.  An Fr inversion is 253 squarings and 126 products,
// 379 Montgomery products of 128 wide multiplies an element against 64
// bytes moved; one launch does what ~512 K-a launches would.
//
// field_wide_to_mont takes the place of the host's C wide reduction of the
// prover's random polynomial (delay_enc_tpu/plonk/prover.py:75
// _rand_fr_mont_bulk, native ecops.c fr_from_uniform_mont): a row of 16
// words is the 512-bit integer lo + 2^256 hi (lo words 0-7, hi 8-15, any
// bits), and its Montgomery form is mont_mul(R^2, lo) + mont_mul(R^3, hi)
// = (lo + 2^256 hi) * R mod p.  mont_mul takes its second operand
// anywhere below 2^256 when its first is below p, so each half goes second
// against the constant, neither is reduced first, and every result is
// fully reduced: the host's words, bit for bit.  R^2 and R^3 come by
// value in the launch's parameters.  Bound: memory, 64 bytes read and 32
// written an element against two Montgomery products (256 wide
// multiplies).

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum { OP_MUL = 0, OP_ADD = 1, OP_SUB = 2 };

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
  fld::ld8(x, a + (size_t)ai * 8);
  fld::ld8(y, b + (size_t)bi * 8);
  if (OP == OP_MUL) {
    fld::mont_mul<F>(r, x, y);
  } else if (OP == OP_ADD) {
    fld::add<F>(r, x, y);
  } else {
    fld::sub<F>(r, x, y);
  }
  fld::st8(out + (size_t)i * 8, r);
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

// The exponent by value: its words and its bit length.
struct Exp {
  uint32_t w[fld::NW];
  uint32_t nbits;
};

template <int F>
__global__ void field_pow_kernel(const uint32_t* __restrict__ a,
                                 uint32_t* __restrict__ out, uint32_t n, Exp e) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[8], ew[8], r[8];
#pragma unroll
  for (int j = 0; j < 8; j++) ew[j] = e.w[j];
  fld::ld8(x, a + (size_t)i * 8);
  fld::mont_pow<F>(r, x, ew, e.nbits);
  fld::st8(out + (size_t)i * 8, r);
}

// R^2 and R^3 mod p by value.
struct Wide {
  uint32_t r2[fld::NW];
  uint32_t r3[fld::NW];
};

template <int F>
__global__ void field_wide_to_mont_kernel(const uint32_t* __restrict__ a,
                                          uint32_t* __restrict__ out, uint32_t n,
                                          Wide c) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t lo[8], hi[8], r2[8], r3[8], x[8], y[8];
#pragma unroll
  for (int j = 0; j < 8; j++) {
    r2[j] = c.r2[j];
    r3[j] = c.r3[j];
  }
  fld::ld8(lo, a + (size_t)i * 16);
  fld::ld8(hi, a + (size_t)i * 16 + 8);
  fld::mont_mul<F>(x, r2, lo);
  fld::mont_mul<F>(y, r3, hi);
  fld::add<F>(x, x, y);
  fld::st8(out + (size_t)i * 8, x);
}

}  // namespace

// out[i] (8 words) = the Montgomery form of the 512-bit row a[i] (16
// words); `consts` (host memory, copied into the launch's parameters) holds
// R^2 mod p, then R^3 mod p, 8 words each.
extern "C" int field_wide_to_mont(int field, const void* a, void* out, unsigned n,
                                  const unsigned* consts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  Wide c;
  for (int j = 0; j < fld::NW; j++) {
    c.r2[j] = consts[j];
    c.r3[j] = consts[fld::NW + j];
  }
  const int threads = 256;
  const uint32_t blocks = (n + threads - 1) / threads;
  const uint32_t* src = static_cast<const uint32_t*>(a);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (field == fld::FR) field_wide_to_mont_kernel<fld::FR><<<blocks, threads, 0, s>>>(src, dst, n, c);
  else field_wide_to_mont_kernel<fld::FQ><<<blocks, threads, 0, s>>>(src, dst, n, c);
  return (int)cudaGetLastError();
}

// out[i] = a[i]^e for the exponent of nbits bits in the 8 words at `exp`
// (host memory, copied into the launch's parameters).
extern "C" int field_pow(int field, const void* a, void* out, unsigned n,
                         const unsigned* exp, unsigned nbits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (nbits > 256) return (int)cudaErrorInvalidValue;
  Exp e;
  for (int j = 0; j < fld::NW; j++) e.w[j] = exp[j];
  e.nbits = nbits;
  const int threads = 128;
  const uint32_t blocks = (n + threads - 1) / threads;
  const uint32_t* src = static_cast<const uint32_t*>(a);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (field == fld::FR) field_pow_kernel<fld::FR><<<blocks, threads, 0, s>>>(src, dst, n, e);
  else field_pow_kernel<fld::FQ><<<blocks, threads, 0, s>>>(src, dst, n, e);
  return (int)cudaGetLastError();
}

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
