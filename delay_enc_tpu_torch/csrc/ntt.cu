// K-b: one stage of a batched natural-order radix-2 NTT over Fr.
//
// Replaces delay_enc_tpu/ops/ntt.py stockham (:85), the transform behind
// plonk/kernels.py _coeff, _ext and _evals_batch.  The same Stockham
// autosort DIF stage: with l = n / 2^(t+1) and m = 2^t, x is viewed as
// (2l, m) and
//     y[2j,   k] = x[j, k] + x[j + l, k]
//     y[2j+1, k] = w^(j m) * (x[j, k] - x[j + l, k])
// so both input and output are in natural order.  The caller ping-pongs
// two buffers over log2(n) launches; w^(j m) is read from one table of
// the powers w^0 .. w^(n/2 - 1) in Montgomery form.  Rows of the batch
// are independent transforms of length n laid out one after another.
//
// Bound: memory.  A stage reads and writes every element once (64 B per
// element) plus a twiddle, so a 19 x 2^19 transform moves about 12 GB over
// its 19 stages (about 3.6 ms at 3.35 TB/s).  One thread per butterfly;
// stages are not yet fused through shared memory.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

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

__global__ void ntt_stage_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ tw,
                                 uint32_t batch, uint32_t n, uint32_t l,
                                 uint32_t log_m) {
  const uint32_t half = n >> 1;
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (size_t)batch * half) return;
  const size_t row = g / half;
  const uint32_t r = (uint32_t)(g - row * half);
  const uint32_t m = 1u << log_m;
  const uint32_t j = r >> log_m;
  const uint32_t k = r & (m - 1);
  const uint32_t* xb = x + row * n * 8;
  uint32_t* yb = y + row * n * 8;
  uint32_t u[8], v[8], s[8], d[8], w[8];
  load8(u, xb + ((size_t)j * m + k) * 8);
  load8(v, xb + ((size_t)(j + l) * m + k) * 8);
  load8(w, tw + ((size_t)j * m) * 8);
  fld::add<fld::FR>(s, u, v);
  fld::sub<fld::FR>(d, u, v);
  fld::mont_mul<fld::FR>(d, w, d);
  store8(yb + ((size_t)(2 * j) * m + k) * 8, s);
  store8(yb + ((size_t)(2 * j + 1) * m + k) * 8, d);
}

}  // namespace

extern "C" int ntt_stage(const void* x, void* y, const void* tw, unsigned batch,
                         unsigned n, unsigned l, unsigned log_m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t work = (size_t)batch * (n / 2);
  if (work == 0) return 0;
  const int threads = 256;
  const size_t blocks = (work + threads - 1) / threads;
  ntt_stage_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(y),
      static_cast<const uint32_t*>(tw), batch, n, l, log_m);
  return (int)cudaGetLastError();
}
