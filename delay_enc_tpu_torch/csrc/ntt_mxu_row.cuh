// K11's layouts and per-element arithmetic (csrc/ntt_mxu.cu), host and device.
//
// A step of the four-step NTT is a product of a fixed (m, K) matrix of field
// elements by a (K, q) data matrix, each element split into 32 byte planes.
// The tensor cores multiply planes; an output element collects, for each of
// its 63 schoolbook byte columns c, the plane products of every pair of
// planes (a, b) with a + b = c.  Both operands are stored in global memory
// in the order the product's shared memory holds them, so that a step's
// tiles arrive by plain bulk copies, and in wgmma's K-major layout without
// swizzle: a plane's tile is a column of core matrices of 8 rows x 16 bytes
// of K (128 bytes each), two along K:
//   fixed: [row tile][K tile][plane a][8 row groups][2 K halves][8 rows][16 bytes]
//          (64 rows x 32 K: 2 KB a plane)
//   data:  [polynomial][column tile][K tile][plane b][2 K halves][8 columns][16 bytes]
//          (8 columns x 32 K: 256 bytes a plane)
// The 32 data planes of a K tile lie one after another, so the tiles of
// planes b0..b1 read as one operand of 8 (b1 - b0 + 1) columns: one wgmma
// multiplies fixed plane a by all of them at once, and its accumulator's
// 8-column slot s is byte column a + b0 + s.  plane_pos gives, for a byte
// of either operand's plane, the row (or column) of the tile and the K
// index it holds; acc_elem, for an accumulator register, the element of a
// slot's 64 x 8 tile.
//
// The columns of an element are carried in two halves (the product's two
// consumer warpgroups each hold one): carry_half turns columns 0..31, or
// 32..62, into a 9-word number; merge_halves adds the two into V's 17
// words; reduce_words turns V into V * 2^-256 mod p, fully reduced.
// reduce_columns is the three in a row.  The functions are
// __host__ __device__ so that a host C++ compiler can check them against
// Python integers (tests/test_torch_ntt_mxu.py).

#pragma once
#include "field.cuh"

namespace mxu {

constexpr int PLANES = 32;  // byte planes of a 256-bit element
constexpr int COLS = 63;    // schoolbook byte columns of a product of two elements
constexpr int HALF_COLS = 32;  // columns of the low half (the high half has 31)
constexpr int HALF_WORDS = 9;  // words of a carried half
constexpr int TILE_M = 64;  // rows of an output tile (one wgmma's M)
constexpr int TILE_N = 8;   // columns of an output tile (one slot of a wgmma's N)
constexpr int TILE_K = 32;  // K of one wgmma over bytes
constexpr int PLANE_A_BYTES = TILE_M * TILE_K;  // 2 KB of a fixed plane's tile
constexpr int PLANE_B_BYTES = TILE_N * TILE_K;  // 256 bytes of a data plane's tile
// floor(2^270 / p) for Fr: the quotient estimate of the last step
constexpr uint32_t MU = 86673u;

// Byte o of a plane's tile (o < 2048 for the fixed operand, o < 256 for
// the data): core matrix o / 128 = 2g + h holds rows 8g..8g+7 and K
// 16h..16h+15, a row's 16 bytes of K together.
FDEV void plane_pos(uint32_t o, uint32_t& row, uint32_t& k) {
  row = 8u * (o >> 8) + ((o >> 4) & 7u);
  k = 16u * ((o >> 7) & 1u) + (o & 15u);
}

// Accumulator register reg of a slot, for a lane of warp w: row 16w + g
// (reg 0, 1) or 16w + g + 8 (reg 2, 3), column 2t + (reg & 1) (g = lane / 4,
// t = lane % 4).
FDEV void acc_elem(uint32_t warp, uint32_t lane, uint32_t reg, uint32_t& row, uint32_t& col) {
  row = 16u * warp + (lane >> 2) + 8u * (reg >> 1);
  col = 2u * (lane & 3u) + (reg & 1u);
}

// The half H of an element's columns (H = 0: col(i) is column i, i < 32;
// H = 1: col(i) is column 32 + i, i < 31), each below 2^31, carried into
// v = sum_i col(i) 2^(8i): eight words and a ninth below 2^25 (a 64-bit
// accumulator: four shifted columns and the carry stay below 2^57).
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <int H, class Col>
FDEV void carry_half(uint32_t v[HALF_WORDS], Col col) {
  constexpr int n = H == 0 ? HALF_COLS : COLS - HALF_COLS;
  uint64_t acc = 0;
#pragma unroll
  for (int w = 0; w < 8; w++) {
#pragma unroll
    for (int j = 0; j < 4; j++)
      if (4 * w + j < n) acc += (uint64_t)col(4 * w + j) << (8 * j);
    v[w] = (uint32_t)acc;
    acc >>= 32;
  }
  v[8] = (uint32_t)acc;
}

// V = lo + 2^256 hi in 17 words (lo and hi from carry_half 0 and 1).
FDEV void merge_halves(uint32_t v[17], const uint32_t lo[HALF_WORDS],
                       const uint32_t hi[HALF_WORDS]) {
#pragma unroll
  for (int w = 0; w < 8; w++) v[w] = lo[w];
  uint64_t c = lo[8];
#pragma unroll
  for (int w = 0; w < HALF_WORDS; w++) {
    c += hi[w];
    v[8 + w] = (uint32_t)c;
    c >>= 32;
  }
}

// V < 2^518 in 17 words (a step's V is at most 1024 * (p - 1)^2) ->
// r = V * 2^-256 mod p, fully reduced; v is overwritten.
//  1. Montgomery: add m * p with m = -V / p mod 2^256, a word at a time, so
//     the low 8 words vanish and X = (V + m p) / 2^256 < 2^263 is left in
//     the top 9 (each multiply-add with its carry stays below 2^64);
//  2. q = floor(floor(X / 2^250) * MU / 2^20) <= X / p, and X / p - q is
//     below 1 + X / 2^270 + 2^250 / p < 1.09, so X - q p < 2p and one
//     conditional subtraction of p ends it.
FDEV void reduce_words(uint32_t r[fld::NW], uint32_t v[17]) {
  using namespace fld;
#pragma unroll
  for (int i = 0; i < NW; i++) {
    const uint32_t m = v[i] * nprime<FR>();
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; j++) {
      c += (uint64_t)m * pw<FR>(j) + v[i + j];
      v[i + j] = (uint32_t)c;
      c >>= 32;
    }
#pragma unroll
    for (int j = i + NW; j < 17; j++) {
      c += v[j];
      v[j] = (uint32_t)c;
      c >>= 32;
    }
  }
  // X = v[8..16]; v[16] < 2^7, so t < 2^13 and t * MU < 2^30
  const uint32_t t = (v[15] >> 26) | (v[16] << 6);
  const uint32_t q = (t * MU) >> 20;
  uint32_t x[NW];
  uint64_t qp = 0;
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; j++) {
    qp += (uint64_t)q * pw<FR>(j);
    const uint64_t d = (uint64_t)v[NW + j] - (uint32_t)qp - borrow;
    x[j] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
    qp >>= 32;
  }
  // the ninth word of X - q p is 0: the remainder is below 2p < 2^256
  reduce_once<FR>(r, x, 0);
}

// col(c) for c < 63: the byte columns of V = sum_c col(c) * 2^(8c), each
// below 2^31, V < 2^518 -> r = V * 2^-256 mod p, as the product's epilogue
// computes it from its two halves.
// (col may be a device lambda: no host instance is called from the card's code)
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Col>
FDEV void reduce_columns(uint32_t r[fld::NW], Col col) {
  uint32_t lo[HALF_WORDS], hi[HALF_WORDS], v[17];
  carry_half<0>(lo, [&](int i) { return col(i); });
  carry_half<1>(hi, [&](int i) { return col(HALF_COLS + i); });
  merge_halves(v, lo, hi);
  reduce_words(r, v);
}

}  // namespace mxu
