// K-c: MSM plane sums (complete-add reduction of each row of points), and
// K-d: elementwise complete addition.  BN254 G1, projective Montgomery
// (X : Y : Z) over Fq, 24 words a point.
//
// K-c replaces delay_enc_tpu/ops/msm_pallas.py _stage / tree_reduce (the
// repo's one Pallas kernel: lane-halving complete-add tree levels over
// (C, 48, W) blocks) and the same tree in ops/msm.py _jit_plane_sums.
// Blocks on the card run in parallel in no order, so nothing is carried
// from one block to the next: pass 1 gives each block a contiguous chunk
// of one row, which its threads sum serially (lanes strided by the block
// size, so loads coalesce) and then fold through a tree in shared memory;
// pass 2 is the same kernel over the chunk partials, one block per row.
// In selector mode lane i of row c reads table[sel[c, i], i] from the
// (16, W) base-4 pair table at load: the select of _jit_plane_sums fused.
//
// K-d serves ops/msm.py _jit_pair_tables (:267) and fixed_base_batch_mul
// (:508): out[i] = a[i] + b[i % bmod].
//
// Bound: integer multiplies.  A complete addition is 12 Fq Montgomery
// products of 128 wide (32x32->64) multiplies each; the bytes moved (96 B
// a point read once) are tiny beside that.  The sums run in registers;
// the order of the additions differs from the TPU tree, so projective
// results differ while the affine points are the same.

#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int PW = 24;  // words per point

__device__ __forceinline__ void load_pt(fld::G1& p, const uint32_t* src) {
  const uint4* q = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int c = 0; c < 2; c++) {
    uint4 v = q[c];
    p.x[4 * c] = v.x; p.x[4 * c + 1] = v.y; p.x[4 * c + 2] = v.z; p.x[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 2; c++) {
    uint4 v = q[2 + c];
    p.y[4 * c] = v.x; p.y[4 * c + 1] = v.y; p.y[4 * c + 2] = v.z; p.y[4 * c + 3] = v.w;
  }
#pragma unroll
  for (int c = 0; c < 2; c++) {
    uint4 v = q[4 + c];
    p.z[4 * c] = v.x; p.z[4 * c + 1] = v.y; p.z[4 * c + 2] = v.z; p.z[4 * c + 3] = v.w;
  }
}

__device__ __forceinline__ void store_pt(uint32_t* dst, const fld::G1& p) {
  uint4* q = reinterpret_cast<uint4*>(dst);
  q[0] = make_uint4(p.x[0], p.x[1], p.x[2], p.x[3]);
  q[1] = make_uint4(p.x[4], p.x[5], p.x[6], p.x[7]);
  q[2] = make_uint4(p.y[0], p.y[1], p.y[2], p.y[3]);
  q[3] = make_uint4(p.y[4], p.y[5], p.y[6], p.y[7]);
  q[4] = make_uint4(p.z[0], p.z[1], p.z[2], p.z[3]);
  q[5] = make_uint4(p.z[4], p.z[5], p.z[6], p.z[7]);
}

constexpr int SUM_THREADS = 128;

// grid (chunks, rows); block SUM_THREADS.  Block (q, c) sums lanes
// [q * chunk, min(W, (q + 1) * chunk)) of row c into out[c * chunks + q].
// pts is (rows, W, 24) when sel is null, else the (16, W, 24) table.
__global__ void __launch_bounds__(SUM_THREADS)
plane_sums_kernel(const uint32_t* __restrict__ pts,
                  const uint8_t* __restrict__ sel,
                  uint32_t* __restrict__ out, uint32_t width, uint32_t chunk) {
  __shared__ uint32_t sh[SUM_THREADS * PW];
  const uint32_t row = blockIdx.y;
  const uint32_t q = blockIdx.x;
  const uint32_t t = threadIdx.x;
  const uint32_t lo = q * chunk;
  uint32_t hi = lo + chunk;
  if (hi > width) hi = width;

  fld::G1 acc, p;
  fld::g1_identity(acc);
  for (uint32_t i = lo + t; i < hi; i += SUM_THREADS) {
    size_t src;
    if (sel != nullptr) {
      src = (size_t)sel[(size_t)row * width + i] * width + i;
    } else {
      src = (size_t)row * width + i;
    }
    load_pt(p, pts + src * PW);
    fld::g1_add(acc, acc, p);
  }
  store_pt(sh + t * PW, acc);
  __syncthreads();
  for (uint32_t s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (t < s) {
      load_pt(p, sh + (t + s) * PW);
      fld::g1_add(acc, acc, p);
      store_pt(sh + t * PW, acc);
    }
    __syncthreads();
  }
  if (t == 0) store_pt(out + ((size_t)row * gridDim.x + q) * PW, acc);
}

__global__ void g1_add_kernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, uint32_t n,
                              uint32_t bmod) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  fld::G1 p, q;
  load_pt(p, a + (size_t)i * PW);
  load_pt(q, b + (size_t)(i % bmod) * PW);
  fld::g1_add(p, p, q);
  store_pt(out + (size_t)i * PW, p);
}

}  // namespace

extern "C" int plane_sums(const void* pts, const void* sel, void* out,
                          unsigned rows, unsigned width, unsigned chunk,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || width == 0) return 0;
  const unsigned chunks = (width + chunk - 1) / chunk;
  dim3 grid(chunks, rows);
  plane_sums_kernel<<<grid, SUM_THREADS, 0, s>>>(
      static_cast<const uint32_t*>(pts), static_cast<const uint8_t*>(sel),
      static_cast<uint32_t*>(out), width, chunk);
  return (int)cudaGetLastError();
}

extern "C" int g1_complete_add(const void* a, const void* b, void* out,
                               unsigned n, unsigned bmod, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  const int threads = 128;
  const unsigned blocks = (n + threads - 1) / threads;
  g1_add_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
      static_cast<uint32_t*>(out), n, bmod);
  return (int)cudaGetLastError();
}
