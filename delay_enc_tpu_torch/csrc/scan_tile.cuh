// The per-thread and per-tile bodies of the scan kernel (csrc/scan.cu).
//
// A row of n elements is scanned in tiles of THREADS * ITEMS elements.  In
// scan order, element j of a row lies at index j, or at n - 1 - j for a
// reverse scan; tile t holds the elements j = t * TILE .. t * TILE + TILE - 1
// of its row in scan order, and thread tid of its block the ITEMS of them
// from tid * ITEMS on.  Elements from n on count as the identity and are
// never stored.  With the CONSTANT flag the input is one element that stands
// for every element of every row; every slot of a tile holds it, those past
// n too, so that a tile's total is always c^TILE.
//
// A tile goes through shared memory, thread tid's elements side by side with
// 4 words of padding after them (`slot`): the copies in and out move 16 bytes
// a thread with neighbouring threads on neighbouring addresses, and the
// threads' own passes read their elements without bank conflicts.
//
//   load_quad / store_quad   one 16-byte quarter of the tile copy, in or out;
//   thread_reduce            the combination of the thread's ITEMS elements;
//   thread_apply             from `pre`, the combination of everything before
//                            the thread's first element, overwrite its slots
//                            with their inclusive or exclusive prefixes;
//   power                    base combined with itself t times: the prefix
//                            of tile t in the CONSTANT form, from c^TILE;
//   Records, window_value    the look-back records in the scratch, and what a
//                            lane of a look-back window contributes;
//   plan                     the tile the kernel takes for a shape, and the
//                            scratch the call needs.
//
// The kernel scans the threads' totals across the block with warp shuffles
// and walks the look-back with one lane a predecessor.  The functions here
// are __host__ __device__, so a host C++ compiler can build them and do those
// two steps with plain loops (tests/test_torch_scan.py).

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace scan {

enum { OP_MUL = 0, OP_ADD = 1 };
enum { EXCLUSIVE = 1, REVERSE = 2, CONSTANT = 4 };  // flag bits
enum { EMPTY = 0, AGGREGATE = 1, PREFIX = 2 };      // state of a tile's record
constexpr int WINDOW = 32;  // predecessors one look-back step reads: a warp

using fld::ld8;
using fld::st8;

// the operator's identity: Montgomery 1 for the product, 0 for the sum
template <int F, int OP>
FDEV void identity(uint32_t r[8]) {
#pragma unroll
  for (int j = 0; j < 8; j++) r[j] = OP == OP_MUL ? fld::onew<F>(j) : 0u;
}

template <int F, int OP>
FDEV void combine(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  if (OP == OP_MUL) {
    fld::mont_mul<F>(r, a, b);
  } else {
    fld::add<F>(r, a, b);
  }
}

// index in the row of element j in scan order
FDEV size_t place(uint32_t j, uint32_t n, uint32_t flags) {
  return (flags & REVERSE) ? (size_t)(n - 1u - j) : (size_t)j;
}

// word offset in the tile's shared memory of local element e
template <int ITEMS>
FDEV unsigned slot(unsigned e) {
  return (e / ITEMS) * (ITEMS * 8 + 4) + (e % ITEMS) * 8;
}

template <int THREADS, int ITEMS>
constexpr unsigned tile_words() {
  return THREADS * (ITEMS * 8 + 4);
}

// four words, in one 16-byte access on the device
FDEV void copy4(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  for (int j = 0; j < 4; j++) dst[j] = src[j];
#endif
}

// Quarter q of the copy in: half q & 1 of local element q >> 1 of the tile
// whose first element in scan order is `first`.
template <int F, int OP, int ITEMS>
FDEV void load_quad(uint32_t* tile, const uint32_t* in_row, uint32_t n, uint32_t first,
                    uint32_t q, uint32_t flags) {
  const uint32_t e = q >> 1, half = q & 1u, j = first + e;
  uint32_t* dst = tile + slot<ITEMS>(e) + half * 4;
  if (flags & CONSTANT) {
    copy4(dst, in_row + half * 4);
  } else if (j < n) {
    copy4(dst, in_row + place(j, n, flags) * 8 + half * 4);
  } else {
    uint32_t id[8];
    identity<F, OP>(id);
    copy4(dst, id + half * 4);
  }
}

template <int ITEMS>
FDEV void store_quad(uint32_t* out_row, const uint32_t* tile, uint32_t n, uint32_t first,
                     uint32_t q, uint32_t flags) {
  const uint32_t e = q >> 1, half = q & 1u, j = first + e;
  if (j < n) copy4(out_row + place(j, n, flags) * 8 + half * 4, tile + slot<ITEMS>(e) + half * 4);
}

template <int F, int OP, int ITEMS>
FDEV void thread_reduce(uint32_t total[8], const uint32_t* tile, unsigned tid) {
  const uint32_t* x = tile + slot<ITEMS>(tid * ITEMS);
  ld8(total, x);
  for (int j = 1; j < ITEMS; j++) {
    uint32_t v[8];
    ld8(v, x + j * 8);
    combine<F, OP>(total, total, v);
  }
}

template <int F, int OP, int ITEMS>
FDEV void thread_apply(uint32_t* tile, unsigned tid, const uint32_t pre[8], uint32_t flags) {
  uint32_t* x = tile + slot<ITEMS>(tid * ITEMS);
  uint32_t acc[8];
  fld::copy(acc, pre);
  for (int j = 0; j < ITEMS; j++) {
    uint32_t v[8];
    ld8(v, x + j * 8);
    if (flags & EXCLUSIVE) {
      st8(x + j * 8, acc);
      if (j + 1 < ITEMS) combine<F, OP>(acc, acc, v);
    } else {
      combine<F, OP>(acc, acc, v);
      st8(x + j * 8, acc);
    }
  }
}

// base combined with itself t times (base^t, or t * base), by squaring
template <int F, int OP>
FDEV void power(uint32_t r[8], const uint32_t base[8], uint32_t t) {
  uint32_t b[8];
  fld::copy(b, base);
  identity<F, OP>(r);
  while (t != 0) {
    if (t & 1u) combine<F, OP>(r, r, b);
    t >>= 1;
    if (t != 0) combine<F, OP>(b, b, b);
  }
}

// The look-back records in the scratch, one a tile (the tiles of all rows
// numbered row * tiles_a_row + t): the counter that hands out tile numbers,
// the states, then the tiles' totals, then their inclusive prefixes.  The
// counter and the states are zeroed before each launch.
FDEV size_t round8(size_t v) { return (v + 7) / 8 * 8; }
FDEV size_t reset_words(size_t tiles) { return 8 + round8(tiles); }
FDEV size_t records_words(size_t tiles) { return reset_words(tiles) + 16 * tiles; }

struct Records {
  uint32_t* counter;
  uint32_t* state;
  uint32_t* total;
  uint32_t* prefix;
  FDEV Records(uint32_t* scratch, size_t tiles)
      : counter(scratch),
        state(scratch + 8),
        total(scratch + reset_words(tiles)),
        prefix(scratch + reset_words(tiles) + 8 * tiles) {}
};

// The kernel's two tiles, both of 8 elements a thread: 256 threads, and 128
// where the large tiles would give fewer than MIN_TILES blocks (two for each
// of the H100's 132 SMs), so that one row of 2^16 still fills the card.  A
// thread's products run one after another, so the chain of a tile, not the
// count of blocks, sets the time of a short scan: the 1024-element tile beat
// the 2048 and those of 512 and 256 at (5, 2^16) and (1, 2^16)
// (tools/torch_ntt_scan_bench.py).  To try another, change it here: the
// wrapper takes the tile and the scratch from `plan` (field_scan_plan).
constexpr int LARGE_THREADS = 256, LARGE_ITEMS = 8;
constexpr int SMALL_THREADS = 128, SMALL_ITEMS = 8;
constexpr size_t MIN_TILES = 264;

struct Plan {
  unsigned threads, items;
  size_t tiles;          // of all rows
  size_t scratch_words;  // the records where a row is more than one tile, else 0
};

FDEV bool large_tile(size_t rows, uint32_t n) {
  constexpr size_t LARGE = (size_t)LARGE_THREADS * LARGE_ITEMS;
  return rows * ((n + LARGE - 1) / LARGE) >= MIN_TILES;
}

FDEV Plan plan(size_t rows, uint32_t n, uint32_t flags) {
  const bool large = large_tile(rows, n);
  Plan p;
  p.threads = large ? LARGE_THREADS : SMALL_THREADS;
  p.items = large ? LARGE_ITEMS : SMALL_ITEMS;
  const size_t tile = (size_t)p.threads * p.items, nt = (n + tile - 1) / tile;
  p.tiles = rows * nt;
  p.scratch_words = nt > 1 && !(flags & CONSTANT) ? records_words(p.tiles) : 0;
  return p;
}

// one element written by another block: from L2, past this SM's L1
FDEV void ld8_shared_by_blocks(uint32_t r[8], const uint32_t* p) {
#ifdef __CUDA_ARCH__
  const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
#else
  ld8(r, p);
#endif
}

// What lane `lane` of a look-back window contributes, for the predecessor
// whose record is `rec` (-1: before the row's first tile).  `stop` is the
// first lane whose predecessor has published its inclusive prefix (WINDOW if
// none has): the lanes before it give their tiles' totals, it gives its
// prefix, and the lanes after it the identity.
template <int F, int OP>
FDEV void window_value(uint32_t v[8], const Records& recs, long long rec, int lane, int stop) {
  if (rec < 0 || lane > stop) {
    identity<F, OP>(v);
  } else {
    ld8_shared_by_blocks(v, (lane == stop ? recs.prefix : recs.total) + (size_t)rec * 8);
  }
}

}  // namespace scan
