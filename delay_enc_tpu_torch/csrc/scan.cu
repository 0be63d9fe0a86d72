// field_scan: inclusive or exclusive, forward or reverse scans along the
// rows of a (G, n, 8) batch of Fr or Fq elements, with the Montgomery product
// or the modular sum as the operator.
//
// Replaces the scan graphs of delay_enc_tpu/ops/poly.py: prefix_product
// (:49), suffix_product (:79), suffix_sum (:146) and, with a constant input,
// powers_of (:100), which the port ran as ladders of elementwise launches
// (about 63 a scan of 2^16 rows, 32 for 2^16 powers).  Every prefix is one
// reduced field element, so any order of association gives the same words.
//
// One call is up to three launches on the stream (reduce, scan, apply):
//   1. every tile of 1024 elements leaves its total;
//   2. one block a row scans the row's totals in place (exclusive);
//   3. every tile scans itself again, starting from its row's prefix, and
//      stores.  A row of one tile is launch 3 alone.
// In a tile a thread scans 4 neighbouring elements in registers, a warp
// combines the threads' totals by shuffles of the eight words, and the
// warps' totals go through shared memory.  Reading the input twice costs
// less than storing partial results and reading them back.
//
// Bound: launch latency.  At (5, 2^16) the call moves 21 MB (6 us at
// 3.35 TB/s) and needs 3.3e5 products (5 us), less than three launches and
// the two dozen products a thread makes one after another.

#include <cuda_runtime.h>

#include "scan_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned TILE = THREADS * scan::ITEMS;

__device__ __forceinline__ void shuffle_up(uint32_t r[8], const uint32_t v[8], int delta) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = __shfl_up_sync(0xffffffffu, v[j], delta);
}

// Inclusive scan of v across the warp.  Every lane makes every product and
// keeps it where it has a lane d below: no branch around a shuffle.
template <int F, int OP>
__device__ __forceinline__ void warp_scan(uint32_t v[8], int lane) {
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    uint32_t up[8], both[8];
    shuffle_up(up, v, d);
    scan::combine<F, OP>(both, up, v);
    if (lane >= d) fld::copy(v, both);
  }
}

// pre = the combination of the totals of all threads before this one,
// all = that of every thread of the block
template <int F, int OP>
__device__ __forceinline__ void block_scan(uint32_t pre[8], uint32_t all[8],
                                           const uint32_t total[8],
                                           uint32_t (*warp_totals)[8]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc[8], before[8];
  fld::copy(inc, total);
  warp_scan<F, OP>(inc, lane);
  shuffle_up(before, inc, 1);
  if (lane == 0) scan::identity<F, OP>(before);
  if (lane == 31) fld::copy(warp_totals[warp], inc);
  __syncthreads();
  if (warp == 0) {
    uint32_t w[8];
    if (lane < WARPS) {
      fld::copy(w, warp_totals[lane]);
    } else {
      scan::identity<F, OP>(w);
    }
    warp_scan<F, OP>(w, lane);
    if (lane < WARPS) fld::copy(warp_totals[lane], w);
  }
  __syncthreads();
  if (warp > 0) {
    scan::combine<F, OP>(pre, warp_totals[warp - 1], before);
  } else {
    fld::copy(pre, before);
  }
  fld::copy(all, warp_totals[WARPS - 1]);
  __syncthreads();  // warp_totals is written again for the next tile
}

// A block scans `tiles` tiles of its row one after another, carrying the
// running combination, which starts from start[block] where start is given.
// With `totals` it stores no element, only the block's combination.  The
// scan of the totals runs in place (in == out): a thread reads its elements
// before it writes them, and no other thread touches them.
template <int F, int OP>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const uint32_t* in, uint32_t* out, const uint32_t* start,
            uint32_t* totals, uint32_t n, uint32_t in_stride, uint32_t blocks_a_row,
            uint32_t tiles, uint32_t flags) {
  __shared__ uint32_t warp_totals[WARPS][8];
  const uint32_t row = blockIdx.x / blocks_a_row;
  const uint32_t blk = blockIdx.x - row * blocks_a_row;
  const uint32_t* in_row = in + (size_t)row * in_stride * 8;
  uint32_t* out_row = out + (size_t)row * n * 8;
  uint32_t carry[8];
  if (start != nullptr) {
    scan::ld8(carry, start + (size_t)blockIdx.x * 8);
  } else {
    scan::identity<F, OP>(carry);
  }
  for (uint32_t t = 0; t < tiles; t++) {
    const uint32_t base = ((blk * tiles + t) * THREADS + threadIdx.x) * scan::ITEMS;
    uint32_t x[scan::ITEMS][8], pre[8], all[8];
    scan::thread_load<F, OP>(x, in_row, n, base, flags);
    block_scan<F, OP>(pre, all, x[scan::ITEMS - 1], warp_totals);
    if (totals == nullptr) {
      scan::combine<F, OP>(pre, carry, pre);
      scan::thread_store<F, OP>(x, pre, out_row, n, base, flags);
    }
    scan::combine<F, OP>(carry, carry, all);
  }
  if (totals != nullptr && threadIdx.x == 0) scan::st8(totals + (size_t)blockIdx.x * 8, carry);
}

template <int F, int OP>
int run(const uint32_t* in, uint32_t* out, uint32_t* scratch, uint32_t rows, uint32_t n,
        uint32_t flags, cudaStream_t s) {
  const uint32_t nt = (n + TILE - 1) / TILE;
  const uint32_t in_stride = (flags & scan::CONSTANT) ? 0u : n;
  if ((size_t)rows * nt > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  if (nt == 1) {
    scan_kernel<F, OP><<<rows, THREADS, 0, s>>>(in, out, nullptr, nullptr, n, in_stride,
                                                1u, 1u, flags);
    return (int)cudaGetLastError();
  }
  // 1. the tiles' totals; 2. each row's totals scanned in place, exclusive
  // and forward; 3. the tiles again, each from its prefix
  scan_kernel<F, OP><<<rows * nt, THREADS, 0, s>>>(in, out, nullptr, scratch, n, in_stride,
                                                   nt, 1u, flags);
  scan_kernel<F, OP><<<rows, THREADS, 0, s>>>(scratch, scratch, nullptr, nullptr, nt, nt, 1u,
                                              (nt + TILE - 1) / TILE, scan::EXCLUSIVE);
  scan_kernel<F, OP><<<rows * nt, THREADS, 0, s>>>(in, out, scratch, nullptr, n, in_stride,
                                                   nt, 1u, flags);
  return (int)cudaGetLastError();
}

}  // namespace

// in: (rows, n, 8), or one element (8 words) with the CONSTANT flag, which
// stands for every element of every row; out: (rows, n, 8); scratch:
// (rows, ceil(n / 1024), 8), used when a row is more than one tile.
extern "C" int field_scan(int op, int field, const void* in, void* out, void* scratch,
                          unsigned rows, unsigned n, unsigned flags, void* stream) {
  if (rows == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* a = static_cast<const uint32_t*>(in);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* t = static_cast<uint32_t*>(scratch);
  if (field == fld::FR) {
    if (op == scan::OP_MUL) return run<fld::FR, scan::OP_MUL>(a, o, t, rows, n, flags, s);
    return run<fld::FR, scan::OP_ADD>(a, o, t, rows, n, flags, s);
  }
  if (op == scan::OP_MUL) return run<fld::FQ, scan::OP_MUL>(a, o, t, rows, n, flags, s);
  return run<fld::FQ, scan::OP_ADD>(a, o, t, rows, n, flags, s);
}
