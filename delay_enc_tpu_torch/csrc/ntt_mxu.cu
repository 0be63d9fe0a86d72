// K11: the four-step NTT over byte planes on the tensor cores.
//
// Replaces delay_enc_tpu/ops/ntt_mxu.py ntt_mxu_raw (:307) and ntt_mxu_stack
// (:352), which plonk/kernels.py _jit_quotient_mxu (:308) ends with.  A
// transform of length n = n1 * n2 is two matrix steps (ops/ntt_mxu.py):
//   B = REDC(W1 . A), C = B (.) T, Y = REDC(W2 . C^T),
// with A the input as (n1, n2), W1, W2 and T fixed tables of the plan in
// Montgomery form (the coset scale, 1/n and zeta^-i folded in), and Y in
// natural order.  Each step is two launches:
//  - mxu_split_kernel cuts the data matrix into 32 byte planes, in the order
//    the product's shared memory holds them (csrc/ntt_mxu_row.cuh); for the
//    second step it reads C transposed, so no transpose is stored;
//  - mxu_product_kernel multiplies the fixed planes by the data planes with
//    wgmma (u8 x u8 -> s32) and, in its epilogue, carries each output
//    element's 63 byte columns, Montgomery-reduces them with 32-bit integer
//    multiplies and, in the first step, multiplies by T.
// The TPU graph multiplied 64 nibble planes in bf16 and reduced with band
// matmuls and a Barrett tail; the card's int8 tensor cores take bytes, and
// its integer units reduce.
//
// Bound: operations.  A step multiplies 1024 byte pairs for every term:
// 1024 * m * K * q multiply-adds for an (m, K) by (K, q) step, against
// 32 bytes an element moved.  The product's design:
//  - a persistent grid, one block an SM, walks the 64 x 8 output tiles (row
//    tile fastest, so the blocks in flight share the data tiles, and the
//    fixed operand, at most 32 MB, stays in L2);
//  - one producer thread brings each K tile of 32 (the tile's 32 fixed
//    planes, 64 KB, and 32 data planes, 8 KB, each contiguous in global
//    memory) into shared memory with bulk copies (TMA): the fixed planes
//    into a ring of five half K tiles, the data planes into a ring of
//    three K tiles, once in order and once, a plane at a time, in reverse;
//    each slot has a full and an empty mbarrier;
//  - two consumer warpgroups own disjoint halves of the byte columns: the
//    first c = a + b < 32 (528 plane pairs), the second 32 <= c < 63 (496),
//    32 accumulator slots of 64 x 8 each, 128 registers a thread: the 63
//    columns of the tile's 512 elements are held once, with no atomics;
//  - for each fixed plane a, a warpgroup issues one wgmma.m64nNk32 (u8,
//    both operands in shared memory) over the data planes b of its half,
//    which lie one after another (descending for the low half): N = 8 x
//    their count, from the first accumulator slot on.  So a K tile is 63
//    wide wgmmas, not 1024 narrow ones: an m64n8k32 costs 16 or more
//    clocks on an H100, at N >= 64 a wgmma runs at the tensor cores' full
//    rate (tools/torch_wgmma_rates.py); 1052 slots of 1024 are worked;
//  - each half K tile's wgmmas are one group, and a slot is freed when the
//    groups that read it are done, so the tensor cores always hold half a
//    K tile's work while the next loads;
//  - the epilogue: each warpgroup carries its half of its four elements'
//    columns into 9 words (mxu::carry_half); the two swap the halves of two
//    elements each through shared memory, and each finishes two elements
//    (merge, REDC, the quotient estimate, the product by T) while the
//    producer already loads the next tile's slots.  (Finishing them
//    after issuing the next tile's first K tile instead, to overlap the
//    tensor cores, measured slower on an H100: PERF.md, K11's findings.)
// Exactness: a column of one output element sums, over K <= 1024 terms, at
// most 32 byte products (one for each plane pair with a + b = c), so it is
// at most 32 * 1024 * 255^2 = 2,130,739,200 < 2^31: the s32 accumulators
// hold it exactly.  The data planes' K tiles may be fewer than the fixed
// operand's: the coset transform's input is zero from row n1 / 8 of A on,
// and its first step runs only the K tiles that hold data.
//
// mxu_reduce_kernel runs the same reduction over given columns (the
// adversarial cases of chip_smoke.py); no transform launches it.

#include <cuda_runtime.h>

#include <utility>

#include "ntt_mxu_row.cuh"
#include "ntt_mxu_wgmma.cuh"

namespace {

using mxu::COLS;
using mxu::HALF_COLS;
using mxu::HALF_WORDS;
using mxu::PLANE_A_BYTES;
using mxu::PLANE_B_BYTES;
using mxu::PLANES;
using mxu::TILE_K;
using mxu::TILE_M;
using mxu::TILE_N;

constexpr int CONSUMERS = 2;  // warpgroups: columns 0..31 and 32..62
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and the producer's warpgroup
// registers a thread: ptxas allocates a wgmma kernel by warpgroups (168 a
// thread for 384 threads); setmaxnreg moves the producer's to the consumers
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
static_assert(128 * PRODUCER_REGS + CONSUMERS * 128 * CONSUMER_REGS <= 65536, "registers");
// Two rings in shared memory: the fixed planes in half K tiles (16 planes,
// 32 KB), the data planes a K tile at a time in both orders (the low half's
// wgmmas read them descending); with one ring of three K tiles there is no
// room for the second order, and with two K tiles the loads stalled the
// tensor cores.
constexpr int W_SLOTS = 5, D_SLOTS = 3;
constexpr int HALF_PLANES = PLANES / 2;
constexpr uint32_t W_BYTES = PLANES * PLANE_A_BYTES;  // a K tile of the fixed planes
constexpr uint32_t W_HALF = HALF_PLANES * PLANE_A_BYTES;
constexpr uint32_t D_BYTES = PLANES * PLANE_B_BYTES;  // a K tile of the data planes
// a data slot: planes 0..31, a zero tile, planes 31..0, a zero tile
constexpr uint32_t D_ASC = 0, D_DESC = D_BYTES + PLANE_B_BYTES, D_SLOT = 2 * D_DESC;
// the half of one element each consumer thread hands over at a time
constexpr uint32_t XCH_WORDS = CONSUMERS * HALF_WORDS * 128;
constexpr uint32_t D_RING = W_SLOTS * W_HALF, XCH = D_RING + D_SLOTS * D_SLOT;
constexpr uint32_t BARS = XCH + XCH_WORDS * 4;  // full then empty, W ring then D ring
constexpr uint32_t SMEM_BYTES = BARS + 2 * (W_SLOTS + D_SLOTS) * 8;
static_assert(SMEM_BYTES <= 232448, "the rings exceed a block's shared memory");
static_assert(32u * 1024u * 255u * 255u < (1u << 31), "a column overflows s32");

struct Split {
  uint32_t n_in;      // elements a source row holds; later indices read as zero
  uint32_t src_row;   // elements between source rows
  uint32_t k_stride;  // element (k, col) of the data matrix is k * k_stride
  uint32_t c_stride;  //   + col * c_stride of its row
  uint32_t cols, kdim;  // q and K: columns and K rows that hold data
  uint32_t col_tiles, ktiles;
};

struct Step {
  uint32_t rows, cols;  // m and q: the output of a polynomial is (m, q)
  uint32_t row_tiles, col_tiles;
  uint32_t w_ktiles;  // K tiles of the fixed operand's buffer
  uint32_t ktiles;    // K tiles of the data operand, which this step runs
  uint32_t tiles;     // batch * row_tiles * col_tiles
};

// One thread a (polynomial, column tile, K tile, word u of a plane's 64):
// the four elements of bytes 4u..4u+3 (mxu::plane_pos), one column and four
// consecutive K; the 64 threads of a group store a plane's 64 words.
__global__ void __launch_bounds__(256)
mxu_split_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, Split S,
                 size_t groups) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t grp = tid >> 6;
  if (grp >= groups) return;
  const uint32_t u = tid & 63u;
  const uint32_t kt = grp % S.ktiles;
  const size_t zj = grp / S.ktiles;
  const uint32_t jt = zj % S.col_tiles;
  const size_t z = zj / S.col_tiles;
  uint32_t e[4][fld::NW];
#pragma unroll
  for (uint32_t q = 0; q < 4; q++) {
    uint32_t col, k;
    mxu::plane_pos(4 * u + q, col, k);
    col += jt * TILE_N;
    k += kt * TILE_K;
    const uint32_t idx = k * S.k_stride + col * S.c_stride;
    if (col < S.cols && k < S.kdim && idx < S.n_in) {
      fld::ld8(e[q], src + (z * S.src_row + idx) * fld::NW);
    } else {
#pragma unroll
      for (int w = 0; w < fld::NW; w++) e[q][w] = 0;
    }
  }
  uint32_t* o = dst + grp * PLANES * 64 + u;
#pragma unroll
  for (int b = 0; b < PLANES; b++) {
    const int w = b >> 2, sh = 8 * (b & 3);
    o[b * 64] = ((e[0][w] >> sh) & 0xffu) | (((e[1][w] >> sh) & 0xffu) << 8) |
                (((e[2][w] >> sh) & 0xffu) << 16) | (((e[3][w] >> sh) & 0xffu) << 24);
  }
}

// ---- shared memory, mbarriers, bulk copies and wgmma (PTX)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity.  The loop is in the asm, so
// that the compiler sees no divergent path between the warpgroup's wgmmas;
// a copy that never lands ends the launch with an error (trap) after 2^26
// tries of up to a microsecond each rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u32 n;\n mov.u32 n, 0;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, 1000;\n"
      " @p bra.uni DONE;\n add.u32 n, n, 1;\n setp.lt.u32 p, n, %2;\n @p bra.uni WAIT;\n"
      " trap;\nDONE:\n}"
      ::"r"(bar), "r"(parity), "n"(1 << 26)
      : "memory");
}

// bytes (a multiple of 16) from global memory to shared memory, counted on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the two consumer warpgroups, not the producer's
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
}

// keeps the compiler from moving an accumulator across the asynchronous wgmma
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The shared-memory descriptor of a run of plane tiles from addr on: no
// swizzle, K-major core matrices of 8 rows x 16 bytes (128 bytes each), the
// next 16 bytes of K 128 bytes on (leading offset), the next 8 rows 256 on
// (stride offset): a fixed plane's 8 row groups, or the next data planes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void tile_pos(const Step& S, uint32_t tile, uint32_t& it,
                                         uint32_t& jt, uint32_t& z) {
  it = tile % S.row_tiles;
  const uint32_t rest = tile / S.row_tiles;
  jt = rest % S.col_tiles;
  z = rest / S.col_tiles;
}

// A slot of a ring of N and the parity of its current round.
template <int N>
struct Ring {
  uint32_t slot = 0, phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == N) slot = 0, phase ^= 1;
  }
};

// The mbarriers: full and empty of each slot of the W ring, then of the D ring.
struct Bars {
  uint32_t base;
  __device__ __forceinline__ uint32_t w_full(uint32_t i) const { return base + 8 * i; }
  __device__ __forceinline__ uint32_t w_empty(uint32_t i) const {
    return base + 8 * (W_SLOTS + i);
  }
  __device__ __forceinline__ uint32_t d_full(uint32_t i) const {
    return base + 8 * (2 * W_SLOTS + i);
  }
  __device__ __forceinline__ uint32_t d_empty(uint32_t i) const {
    return base + 8 * (2 * W_SLOTS + D_SLOTS + i);
  }
};

// ---- the product's three roles

__device__ __forceinline__ void produce(const uint8_t* __restrict__ wf,
                                        const uint8_t* __restrict__ df, const Step& S,
                                        uint32_t base, Bars bars) {
  Ring<W_SLOTS> wr;
  Ring<D_SLOTS> dr;
  for (uint32_t tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
    uint32_t it, jt, z;
    tile_pos(S, tile, it, jt, z);
    const uint8_t* w = wf + (size_t)it * S.w_ktiles * W_BYTES;
    const uint8_t* d = df + ((size_t)z * S.col_tiles + jt) * S.ktiles * D_BYTES;
    for (uint32_t kt = 0; kt < S.ktiles; kt++) {
      // the data planes, in order and (a plane at a time) in reverse
      mbar_wait(bars.d_empty(dr.slot), dr.phase ^ 1);
      const uint32_t full = bars.d_full(dr.slot), dst = base + D_RING + dr.slot * D_SLOT;
      const uint8_t* src = d + (size_t)kt * D_BYTES;
      mbar_expect_tx(full, 2 * D_BYTES);
      bulk_load(dst + D_ASC, src, D_BYTES, full);
      for (int b = 0; b < PLANES; b++)
        bulk_load(dst + D_DESC + (PLANES - 1 - b) * PLANE_B_BYTES, src + b * PLANE_B_BYTES,
                  PLANE_B_BYTES, full);
      dr.next();
      for (int h = 0; h < 2; h++) {
        mbar_wait(bars.w_empty(wr.slot), wr.phase ^ 1);
        mbar_expect_tx(bars.w_full(wr.slot), W_HALF);
        bulk_load(base + wr.slot * W_HALF, w + (size_t)kt * W_BYTES + h * W_HALF, W_HALF,
                  bars.w_full(wr.slot));
        wr.next();
      }
    }
  }
}

// Fixed plane A's wgmma in half H of the columns, over the data planes b
// with A + b in the half.  Every wgmma of a warpgroup starts at its first
// accumulator slot (ptxas pipelines wgmmas whose accumulators share their
// first register or are disjoint, and serializes partly overlapping ones):
// the high half's slot s is column 32 + s, so plane A runs over planes
// 32 - A.. in order; the low half's slot s is column 31 - s, so plane A
// runs over planes 31 - A, .., 0, in the descending copy.  N = 8 x their
// count, made a width u8 wgmma takes (8..32, or a multiple of 16) by one
// more slot over the zero tile after the run: a product of zero.
template <int H, int A>
__device__ __forceinline__ void mma_plane(uint32_t (&acc)[HALF_COLS][4], uint32_t w,
                                          uint32_t d) {
  constexpr int n = H == 0 ? PLANES - A : A;
  constexpr int L = n <= 4 || n % 2 == 0 ? n : n + 1;
  constexpr uint32_t run = H == 0 ? D_DESC + A * PLANE_B_BYTES
                                  : D_ASC + (PLANES - A) * PLANE_B_BYTES;
  if constexpr (n > 0)
    mxu::wgmma_ss<L>(&acc[0], smem_desc(w + (A % HALF_PLANES) * PLANE_A_BYTES),
                     smem_desc(d + run));
}

// the fixed planes A0.. of one half K tile
template <int H, int A0, int... A>
__device__ __forceinline__ void mma_half(uint32_t (&acc)[HALF_COLS][4], uint32_t w,
                                         uint32_t d, std::integer_sequence<int, A...>) {
  (mma_plane<H, A0 + A>(acc, w, d), ...);
}

template <int H>
__device__ __forceinline__ void consume(const uint32_t* __restrict__ t_tab,
                                        uint32_t* __restrict__ out, const Step& S,
                                        uint32_t base, Bars bars, uint32_t* xch) {
  const uint32_t tid = threadIdx.x - 128 * H;
  const uint32_t warp = tid >> 5, lane = tid & 31u;
  Ring<W_SLOTS> wr;
  Ring<D_SLOTS> dr;
  const auto half_planes = std::make_integer_sequence<int, HALF_PLANES>();
  for (uint32_t tile = blockIdx.x; tile < S.tiles; tile += gridDim.x) {
    uint32_t it, jt, z;
    tile_pos(S, tile, it, jt, z);
    uint32_t acc[HALF_COLS][4];
#pragma unroll
    for (int c = 0; c < HALF_COLS; c++)
#pragma unroll
      for (int r = 0; r < 4; r++) acc[c][r] = 0, keep(acc[c][r]);
    // each half K tile's wgmmas are one group; a slot is freed once the
    // groups that read it are done, while the next group runs
    bool held = false;
    uint32_t held_w = 0, held_d = 0;  // the previous K tile's upper fixed half and its data
    for (uint32_t kt = 0; kt < S.ktiles; kt++) {
      const uint32_t ds = dr.slot, d = base + D_RING + ds * D_SLOT;
      mbar_wait(bars.d_full(ds), dr.phase);
      dr.next();
      const uint32_t lo = wr.slot;
      mbar_wait(bars.w_full(lo), wr.phase);
      wr.next();
      wg_fence();
      mma_half<H, 0>(acc, base + lo * W_HALF, d, half_planes);
      wg_commit();
      if (held) {
        wg_wait<1>();
        mbar_arrive(bars.w_empty(held_w)), mbar_arrive(bars.d_empty(held_d));
      }
      const uint32_t hi = wr.slot;
      mbar_wait(bars.w_full(hi), wr.phase);
      wr.next();
      wg_fence();  // after the wait's branches: else ptxas fences there and serializes
      mma_half<H, HALF_PLANES>(acc, base + hi * W_HALF, d, half_planes);
      wg_commit();
      wg_wait<1>();
      mbar_arrive(bars.w_empty(lo));
      held = true, held_w = hi, held_d = ds;
    }
    wg_wait<0>();
    mbar_arrive(bars.w_empty(held_w)), mbar_arrive(bars.d_empty(held_d));
#pragma unroll
    for (int c = 0; c < HALF_COLS; c++)
#pragma unroll
      for (int r = 0; r < 4; r++) keep(acc[c][r]);

    // the epilogue: this half of the four elements' columns as 9 words each
    uint32_t half[4][HALF_WORDS];
#pragma unroll
    for (int r = 0; r < 4; r++)
      mxu::carry_half<H>(half[r], [&](int i) { return acc[H == 0 ? HALF_COLS - 1 - i : i][r]; });
    // keep elements 2H and 2H + 1 (row g + 8H), hand over the other two
    uint32_t* mine = xch + H * HALF_WORDS * 128 + tid;
    const uint32_t* theirs = xch + (1 - H) * HALF_WORDS * 128 + tid;
    uint32_t other[2][HALF_WORDS];
#pragma unroll
    for (int e = 0; e < 2; e++) {
#pragma unroll
      for (int w = 0; w < HALF_WORDS; w++) mine[w * 128] = half[2 * (1 - H) + e][w];
      consumers_sync();
#pragma unroll
      for (int w = 0; w < HALF_WORDS; w++) other[e][w] = theirs[w * 128];
      consumers_sync();  // the exchange is free again
    }
#pragma unroll
    for (int e = 0; e < 2; e++) {
      const int r = 2 * H + e;
      uint32_t row, col;
      mxu::acc_elem(warp, lane, r, row, col);
      const uint32_t i = it * TILE_M + row, j = jt * TILE_N + col;
      if (i >= S.rows || j >= S.cols) continue;
      uint32_t v[17], res[fld::NW];
      if (H == 0)
        mxu::merge_halves(v, half[r], other[e]);
      else
        mxu::merge_halves(v, other[e], half[r]);
      mxu::reduce_words(res, v);
      const size_t idx = (size_t)i * S.cols + j;
      if (t_tab != nullptr) {
        uint32_t t[fld::NW], x[fld::NW];
        fld::ld8(t, t_tab + idx * fld::NW);
        fld::copy(x, res);
        fld::mont_mul<fld::FR>(res, x, t);
      }
      fld::st8(out + ((size_t)z * S.rows * S.cols + idx) * fld::NW, res);
    }
  }
}

// Warps 0-3 and 4-7 are the consumer warpgroups of the low and the high
// columns, warps 8-11 the producer's (one thread issues the copies).
__global__ void __launch_bounds__(THREADS, 1)
mxu_product_kernel(const uint8_t* __restrict__ wf, const uint8_t* __restrict__ df,
                   const uint32_t* __restrict__ t_tab, uint32_t* __restrict__ out, Step S) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem + XCH);
  const uint32_t base = smem_u32(smem);
  const Bars bars = {base + BARS};
  // the zero tile after each order of each data slot, seen by the wgmmas
  for (uint32_t i = threadIdx.x; i < D_SLOTS * 2 * PLANE_B_BYTES / 4; i += THREADS) {
    const uint32_t slot = i / (2 * PLANE_B_BYTES / 4), j = i % (2 * PLANE_B_BYTES / 4);
    const uint32_t off = D_RING + slot * D_SLOT + D_BYTES + (j < PLANE_B_BYTES / 4 ? D_ASC : D_DESC);
    reinterpret_cast<uint32_t*>(smem + off)[j % (PLANE_B_BYTES / 4)] = 0;
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (threadIdx.x == 0) {
    for (int i = 0; i < W_SLOTS; i++) {
      mbar_init(bars.w_full(i), 1);               // the producer's expect_tx
      mbar_init(bars.w_empty(i), CONSUMERS * 128);  // every consumer thread arrives
    }
    for (int i = 0; i < D_SLOTS; i++) {
      mbar_init(bars.d_full(i), 1);
      mbar_init(bars.d_empty(i), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const uint32_t warp = threadIdx.x >> 5;
  if (warp >= CONSUMERS * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) produce(wf, df, S, base, bars);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    if (warp < 4)
      consume<0>(t_tab, out, S, base, bars, xch);
    else
      consume<1>(t_tab, out, S, base, bars, xch);
  }
}

__global__ void __launch_bounds__(128)
mxu_reduce_kernel(const uint32_t* __restrict__ cols, uint32_t* __restrict__ out,
                  uint32_t count) {
  const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  uint32_t r[fld::NW];
  mxu::reduce_columns(r, [&](int c) { return cols[(size_t)i * COLS + c]; });
  fld::st8(out + (size_t)i * fld::NW, r);
}

int set_smem() {
  return (int)cudaFuncSetAttribute(mxu_product_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
}

}  // namespace

// The data planes of `batch` polynomials for one step: dst holds
// batch * col_tiles * ktiles groups of 32 planes x 256 bytes.
extern "C" int ntt_mxu_split(const void* src, void* dst, unsigned batch, unsigned n_in,
                             unsigned src_row, unsigned k_stride, unsigned c_stride,
                             unsigned cols, unsigned kdim, unsigned col_tiles, unsigned ktiles,
                             void* stream) {
  if (batch == 0) return 0;
  if (col_tiles == 0 || ktiles == 0) return (int)cudaErrorInvalidValue;
  const Split S = {n_in, src_row, k_stride, c_stride, cols, kdim, col_tiles, ktiles};
  const size_t groups = (size_t)batch * col_tiles * ktiles;
  const size_t blocks = (groups * 64 + 255) / 256;
  if (blocks > 0x7fffffffu) return (int)cudaErrorInvalidValue;
  mxu_split_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(src), static_cast<uint32_t*>(dst), S, groups);
  return (int)cudaGetLastError();
}

// One step over `batch` polynomials: out (batch, rows, cols) elements;
// t_tab (rows, cols) elements or null.  wf and df 16-byte aligned.
extern "C" int ntt_mxu_product(const void* wf, const void* df, const void* t_tab, void* out,
                               unsigned batch, unsigned rows, unsigned cols, unsigned row_tiles,
                               unsigned col_tiles, unsigned w_ktiles, unsigned ktiles,
                               void* stream) {
  if (batch == 0) return 0;
  const uint64_t tiles = (uint64_t)batch * row_tiles * col_tiles;
  if (ktiles == 0 || ktiles > w_ktiles || tiles == 0 || tiles > 0x7fffffffu ||
      (uint64_t)row_tiles * TILE_M < rows || (uint64_t)col_tiles * TILE_N < cols ||
      (((uintptr_t)wf | (uintptr_t)df) & 15u) != 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = (cudaError_t)set_smem();
  if (e != cudaSuccess) return (int)e;
  const Step S = {rows, cols, row_tiles, col_tiles, w_ktiles, ktiles, (uint32_t)tiles};
  const unsigned grid = (unsigned)(tiles < (uint64_t)sms ? tiles : (uint64_t)sms);
  mxu_product_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wf), static_cast<const uint8_t*>(df),
      static_cast<const uint32_t*>(t_tab), static_cast<uint32_t*>(out), S);
  return (int)cudaGetLastError();
}

// The product kernel's resources: out[0..5] = registers a thread, local
// (spilled) bytes a thread, static and dynamic shared memory a block, blocks
// an SM, threads a block.  Launches nothing.
extern "C" int ntt_mxu_product_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, mxu_product_kernel);
  if (e == cudaSuccess) e = (cudaError_t)set_smem();
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mxu_product_kernel, THREADS,
                                                      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)SMEM_BYTES;
  out[4] = blocks;
  out[5] = THREADS;
  return 0;
}

// count elements' 63 columns (count, 63) -> (count, 8) reduced words.
extern "C" int ntt_mxu_reduce(const void* cols, void* out, unsigned count, void* stream) {
  if (count == 0) return 0;
  mxu_reduce_kernel<<<(count + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cols), static_cast<uint32_t*>(out), count);
  return (int)cudaGetLastError();
}
