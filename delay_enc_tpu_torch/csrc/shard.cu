// K12: the cross-shard butterfly of the sharded NTT, one launch a stage and
// a shard.
//
// Replaces delay_enc_tpu/parallel/ntt.py _dif_stages (:99-114) and the
// inverse stages of sharded_intt (:165-182): there each stage is L.add,
// L.sub and L.mont_mul over the whole shard, then a jnp.where on the
// shard's position, three or four limb passes.  Whether a shard is the top
// or the bottom partner of a stage is known on the host, so it is a
// template argument here, not a select:
//
//   out[i] = (top ? x[i] + recv[i] : recv[i] - x[i]) * table
//
// with the table an (L, 8) twiddle row (mode 2), one constant (mode 1) or
// nothing (mode 0).  x is the shard's own block, recv its partner's (the
// ppermute's copy).  Forward: the bottom shard's (recv - x) * w.  Inverse:
// each bottom shard's pre-twiddle of the next stage rides on this stage's
// table, and 1/N on the last stage's constant (parallel/ntt.py).
//
// Bound: bytes.  Per element it reads x, recv and a table row (3 x 32 B)
// and writes 32 B, with one Montgomery product (128 wide multiplies): at
// L = 2^14 that is 2 MB, 0.63 us at 3.35 TB/s, against 0.25 us of integer
// work.  One thread per element, 16-byte vector loads; nothing in shared
// memory.  At these sizes the launch itself costs more than either bound.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

enum { TABLE_NONE = 0, TABLE_CONST = 1, TABLE_ROW = 2 };

template <bool TOP, int MODE>
__global__ void shard_butterfly_kernel(const uint32_t* __restrict__ x,
                                       const uint32_t* __restrict__ recv,
                                       const uint32_t* __restrict__ table,
                                       uint32_t* __restrict__ out, uint32_t n) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t a[8], b[8], r[8];
  fld::ld8(a, x + (size_t)i * 8);
  fld::ld8(b, recv + (size_t)i * 8);
  if (TOP) {
    fld::add<fld::FR>(r, a, b);
  } else {
    fld::sub<fld::FR>(r, b, a);
  }
  if (MODE != TABLE_NONE) {
    uint32_t t[8];
    fld::ld8(t, table + (MODE == TABLE_ROW ? (size_t)i * 8 : 0));
    fld::mont_mul<fld::FR>(a, r, t);
    fld::st8(out + (size_t)i * 8, a);
  } else {
    fld::st8(out + (size_t)i * 8, r);
  }
}

template <bool TOP, int MODE>
void launch(const void* x, const void* recv, const void* table, void* out, uint32_t n,
            cudaStream_t s) {
  const int threads = 256;
  const uint32_t blocks = (n + threads - 1) / threads;
  shard_butterfly_kernel<TOP, MODE><<<blocks, threads, 0, s>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(recv),
      static_cast<const uint32_t*>(table), static_cast<uint32_t*>(out), n);
}

}  // namespace

extern "C" int shard_butterfly(const void* x, const void* recv, const void* table, void* out,
                               unsigned n, int top, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (mode < TABLE_NONE || mode > TABLE_ROW || (mode != TABLE_NONE && table == nullptr))
    return (int)cudaErrorInvalidValue;
  if (top) {
    if (mode == TABLE_NONE) launch<true, TABLE_NONE>(x, recv, table, out, n, s);
    else if (mode == TABLE_CONST) launch<true, TABLE_CONST>(x, recv, table, out, n, s);
    else launch<true, TABLE_ROW>(x, recv, table, out, n, s);
  } else {
    if (mode == TABLE_NONE) launch<false, TABLE_NONE>(x, recv, table, out, n, s);
    else if (mode == TABLE_CONST) launch<false, TABLE_CONST>(x, recv, table, out, n, s);
    else launch<false, TABLE_ROW>(x, recv, table, out, n, s);
  }
  return (int)cudaGetLastError();
}
