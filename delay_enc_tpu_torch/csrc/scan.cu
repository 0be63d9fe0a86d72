// field_scan: inclusive or exclusive, forward or reverse scans along the
// rows of a (G, n, 8) batch of Fr or Fq elements, with the Montgomery product
// or the modular sum as the operator.
//
// Replaces the scan graphs of delay_enc_tpu/ops/poly.py: prefix_product
// (:49), suffix_product (:79), suffix_sum (:146) and, with a constant input,
// powers_of (:100).  Every prefix is one reduced field element, so any order
// of association gives the same words.
//
// One launch a call, one pass over the data: the single-pass scan with
// decoupled look-back (Merrill and Garland, 2016).  A block takes the next
// tile number from a counter in the scratch (so a block only ever waits for
// blocks that started before it), copies its tile into shared memory, and:
//   1. each thread combines its ITEMS elements one after another;
//   2. the block scans the threads' totals: shuffles within a warp, then one
//      warp over the warps' totals, which gives the tile's total;
//   3. the tile publishes its total in its record, then walks back over its
//      predecessors' records a warp at a time, one lane a predecessor, until
//      a lane finds a published inclusive prefix; each lane combines what it
//      read window after window, the lanes' combinations then combine into
//      the tile's prefix, and the tile publishes its own inclusive prefix.  A record is eight words, written, fenced, and then
//      flagged by a release store of its state; the reader acquires the
//      state before it reads the words;
//   4. each thread applies its prefix to its elements one after another, and
//      the block copies the tile out.
// A row of one tile needs no record.  The constant form (the powers of one
// element, its own in each row) needs none either: every full tile's total
// is c^TILE, so tile t's prefix is that tile total to the power t, by
// squaring.
//
// About 2.6 products an element (7/8 to reduce, 5/8 in the warp scan, 1/8
// to combine the thread's prefix, 1 to apply), against about 8 in the
// earlier three-launch design.  The tile a shape takes, and the scratch its
// call needs, are scan::plan's (csrc/scan_tile.cuh), which the wrapper reads
// through field_scan_plan.
//
// Bound: operations.  At (5, 2^16) the call moves 21 MB (6 us at
// 3.35 TB/s) and needs 3.3e5 products (5 us at the integer rate).

#include <cuda_runtime.h>

#include "scan_tile.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void shuffle_up(uint32_t r[8], const uint32_t v[8], int delta) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = __shfl_up_sync(FULL, v[j], delta);
}

// Inclusive scan of v across the first LANES lanes of the warp.  Every lane
// makes every product and keeps it where it has a lane d below: no branch
// around a shuffle.
template <int F, int OP, int LANES>
__device__ __forceinline__ void warp_scan(uint32_t v[8], int lane) {
#pragma unroll
  for (int d = 1; d < LANES; d *= 2) {
    uint32_t up[8], both[8];
    shuffle_up(up, v, d);
    scan::combine<F, OP>(both, up, v);
    if (lane >= d) fld::copy(v, both);
  }
}

// v combined over all 32 lanes, in every lane
template <int F, int OP>
__device__ __forceinline__ void warp_reduce(uint32_t v[8]) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) {
    uint32_t o[8];
#pragma unroll
    for (int j = 0; j < 8; j++) o[j] = __shfl_xor_sync(FULL, v[j], d);
    scan::combine<F, OP>(v, v, o);
  }
}

__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// the eight words of a record, then its state
__device__ __forceinline__ void publish(const scan::Records& recs, uint32_t rec, uint32_t state,
                                        const uint32_t v[8]) {
  uint4* dst = reinterpret_cast<uint4*>((state == scan::PREFIX ? recs.prefix : recs.total) +
                                        (size_t)rec * 8);
  __stcg(dst, make_uint4(v[0], v[1], v[2], v[3]));
  __stcg(dst + 1, make_uint4(v[4], v[5], v[6], v[7]));
  __threadfence();
  store_release(recs.state + rec, state);
}

// Warp 0: the combination of everything in the row before tile t, whose
// record is `rec`; `all` is the tile's total.
template <int F, int OP>
__device__ void tile_prefix(uint32_t pre[8], const uint32_t all[8], const scan::Records& recs,
                            uint32_t rec, uint32_t t, bool lookback, uint32_t flags, int lane) {
  if (!lookback) {
    if (flags & scan::CONSTANT) {
      scan::power<F, OP>(pre, all, t);
    } else {
      scan::identity<F, OP>(pre);
    }
    return;
  }
  scan::identity<F, OP>(pre);
  if (t == 0) {
    if (lane == 0) publish(recs, rec, scan::PREFIX, all);
    return;
  }
  if (lane == 0) publish(recs, rec, scan::AGGREGATE, all);
  // Each lane combines its own predecessors, window after window, and the
  // lanes combine once at the end: a window costs one product in sequence.
  uint32_t mine[8];
  scan::identity<F, OP>(mine);
  for (long long last = (long long)t - 1;; last -= scan::WINDOW) {
    const long long p = last - lane;  // this lane's predecessor in the row
    const long long r = p >= 0 ? (long long)rec - (long long)t + p : -1;
    uint32_t state;
    do {
      state = r >= 0 ? load_acquire(recs.state + r) : (uint32_t)scan::PREFIX;
    } while (__any_sync(FULL, state == scan::EMPTY));
    const unsigned found = __ballot_sync(FULL, state == scan::PREFIX);
    const int stop = found ? __ffs(found) - 1 : scan::WINDOW;
    uint32_t v[8];
    scan::window_value<F, OP>(v, recs, r, lane, stop);
    scan::combine<F, OP>(mine, v, mine);
    if (found) break;
  }
  warp_reduce<F, OP>(mine);
  fld::copy(pre, mine);
  if (lane == 0) {
    uint32_t inc[8];
    scan::combine<F, OP>(inc, pre, all);
    publish(recs, rec, scan::PREFIX, inc);
  }
}

template <int F, int OP, int THREADS, int ITEMS>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const uint32_t* in, uint32_t* out, uint32_t* scratch, uint32_t n,
            uint32_t tiles_a_row, uint32_t tiles, uint32_t flags) {
  constexpr int WARPS = THREADS / 32;
  constexpr uint32_t TILE = THREADS * ITEMS;
  extern __shared__ uint4 tile_mem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(tile_mem);
  __shared__ uint32_t warp_vals[WARPS][8];  // the warps' totals, then their prefixes
  __shared__ uint32_t number;
  const bool lookback = tiles_a_row > 1 && !(flags & scan::CONSTANT);
  const scan::Records recs(scratch, tiles);
  uint32_t rec = blockIdx.x;
  if (lookback) {
    if (threadIdx.x == 0) number = atomicAdd(recs.counter, 1u);
    __syncthreads();
    rec = number;
  }
  const uint32_t row = rec / tiles_a_row, t = rec - row * tiles_a_row;
  const uint32_t* in_row = in + (size_t)row * ((flags & scan::CONSTANT) ? 1u : n) * 8;
  uint32_t* out_row = out + (size_t)row * n * 8;
  const uint32_t first = t * TILE;
  for (uint32_t q = threadIdx.x; q < 2 * TILE; q += THREADS)
    scan::load_quad<F, OP, ITEMS>(tile, in_row, n, first, q, flags);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc[8], before[8];
  scan::thread_reduce<F, OP, ITEMS>(inc, tile, threadIdx.x);
  warp_scan<F, OP, 32>(inc, lane);
  shuffle_up(before, inc, 1);
  if (lane == 0) scan::identity<F, OP>(before);
  if (lane == 31) fld::copy(warp_vals[warp], inc);
  __syncthreads();
  if (warp == 0) {
    uint32_t w[8], w_before[8], all[8], pre[8];
    if (lane < WARPS) {
      fld::copy(w, warp_vals[lane]);
    } else {
      scan::identity<F, OP>(w);
    }
    warp_scan<F, OP, WARPS>(w, lane);
    shuffle_up(w_before, w, 1);
    if (lane == 0) scan::identity<F, OP>(w_before);
#pragma unroll
    for (int j = 0; j < 8; j++) all[j] = __shfl_sync(FULL, w[j], WARPS - 1);
    tile_prefix<F, OP>(pre, all, recs, rec, t, lookback, flags, lane);
    if (lane < WARPS) scan::combine<F, OP>(warp_vals[lane], pre, w_before);
  }
  __syncthreads();
  scan::combine<F, OP>(before, warp_vals[warp], before);
  scan::thread_apply<F, OP, ITEMS>(tile, threadIdx.x, before, flags);
  __syncthreads();
  for (uint32_t q = threadIdx.x; q < 2 * TILE; q += THREADS)
    scan::store_quad<ITEMS>(out_row, tile, n, first, q, flags);
}

template <int F, int OP, int THREADS, int ITEMS>
int launch(const uint32_t* in, uint32_t* out, uint32_t* scratch, const scan::Plan& p, uint32_t n,
           uint32_t flags, cudaStream_t s) {
  static_assert(THREADS % 32 == 0 && THREADS / 32 <= 32, "one warp scans the warps' totals");
  constexpr uint32_t TILE = THREADS * ITEMS;
  constexpr size_t SMEM = scan::tile_words<THREADS, ITEMS>() * 4;
  const uint32_t nt = (n + TILE - 1) / TILE;
  const size_t tiles = p.tiles;
  if (tiles > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  static bool sized = false;  // above 48 KB of shared memory only when asked for
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(scan_kernel<F, OP, THREADS, ITEMS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  if (p.scratch_words != 0) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaMemsetAsync(scratch, 0, scan::reset_words(tiles) * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  scan_kernel<F, OP, THREADS, ITEMS><<<(unsigned)tiles, THREADS, SMEM, s>>>(
      in, out, scratch, n, nt, (uint32_t)tiles, flags);
  return (int)cudaGetLastError();
}

template <int F, int OP>
int run(const uint32_t* in, uint32_t* out, uint32_t* scratch, uint32_t rows, uint32_t n,
        uint32_t flags, cudaStream_t s) {
  const scan::Plan p = scan::plan(rows, n, flags);
  if (scan::large_tile(rows, n))
    return launch<F, OP, scan::LARGE_THREADS, scan::LARGE_ITEMS>(in, out, scratch, p, n, flags, s);
  return launch<F, OP, scan::SMALL_THREADS, scan::SMALL_ITEMS>(in, out, scratch, p, n, flags, s);
}

}  // namespace

// The tile (threads, elements a thread) that field_scan takes for `rows`
// rows of n elements, and the words of scratch the call needs (0: none).
extern "C" int field_scan_plan(unsigned rows, unsigned n, unsigned flags, unsigned* tile,
                               unsigned long long* scratch_words) {
  const scan::Plan p = scan::plan(rows, n, flags);
  tile[0] = p.threads;
  tile[1] = p.items;
  *scratch_words = p.scratch_words;
  return 0;
}

// in: (rows, n, 8), or with the CONSTANT flag (rows, 8): one element a
// row, which stands for every element of its row; out: (rows, n, 8); scratch: the
// look-back records, field_scan_plan's words of them (null where it says 0).
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
