// K11's layouts and per-element arithmetic (csrc/ntt_mxu.cu), host and device.
//
// A step of the four-step NTT is a product of a fixed (m, K) matrix of field
// elements by a (K, q) data matrix, each element split into 32 byte planes.
// The tensor cores multiply planes; an output element collects, for each of
// its 63 schoolbook byte columns c, the plane products of every pair of
// planes (a, b) with a + b = c.  Both operands are stored in the order one
// `mma.m16n8k32` (u8 x u8 -> s32) takes them, so that a lane loads its
// whole fragment of one plane with one 16-byte (fixed) or 8-byte (data)
// access:
//   fixed: [row tile][K tile][plane a][lane][4 registers x 4 bytes]
//   data:  [polynomial][column tile][K tile][plane b][lane][2 registers x 4 bytes]
// The functions below give, for a lane, a register and a byte of it, the
// row (or column) of the tile and the K index that byte holds, and, for an
// accumulator register, the element of the 16 x 8 output tile.
//
// reduce_columns turns the 63 columns of V = sum_j W[i,j] * D[j,c] (W in
// Montgomery form) into V * 2^-256 mod p, fully reduced.  The functions
// are __host__ __device__ so that a host C++ compiler can check them
// against Python integers (tests/test_torch_ntt_mxu.py).

#pragma once
#include "field.cuh"

namespace mxu {

constexpr int PLANES = 32;  // byte planes of a 256-bit element
constexpr int COLS = 63;    // schoolbook byte columns of a product of two elements
constexpr int TILE_M = 16;  // rows of an output tile (one mma's M)
constexpr int TILE_N = 8;   // columns of an output tile (one mma's N)
constexpr int TILE_K = 32;  // K of one mma over bytes
constexpr int TILE_ELEMS = TILE_M * TILE_N;
// floor(2^270 / p) for Fr: the quotient estimate of the last step
constexpr uint32_t MU = 86673u;

// Fixed operand (A, row-major): register reg of a lane holds 4 bytes of
// one row; reg 0 and 2 the tile's row g, reg 1 and 3 row g + 8; reg 0 and 1
// K 4t..4t+3, reg 2 and 3 K 16+4t..16+4t+3 (g = lane / 4, t = lane % 4).
FDEV void a_pos(uint32_t lane, uint32_t reg, uint32_t byte, uint32_t& row, uint32_t& k) {
  row = (lane >> 2) + 8u * (reg & 1u);
  k = 16u * (reg >> 1) + 4u * (lane & 3u) + byte;
}

// Data operand (B, column-major): column g of the tile, reg 0 K 4t..4t+3,
// reg 1 K 16+4t..16+4t+3.
FDEV void b_pos(uint32_t lane, uint32_t reg, uint32_t byte, uint32_t& col, uint32_t& k) {
  col = lane >> 2;
  k = 16u * reg + 4u * (lane & 3u) + byte;
}

// Accumulator register reg of a lane: row g (reg 0, 1) or g + 8 (reg 2, 3),
// column 2t + (reg & 1); the element's place in the 16 x 8 tile, row-major.
FDEV uint32_t acc_elem(uint32_t lane, uint32_t reg) {
  return ((lane >> 2) + 8u * (reg >> 1)) * TILE_N + 2u * (lane & 3u) + (reg & 1u);
}

// col(c) for c < 63: the byte columns of V = sum_c col(c) * 2^(8c), each
// below 2^31, V < 2^518 (a step's V is at most 1024 * (p - 1)^2).
// r = V * 2^-256 mod p, fully reduced.
//  1. carry the columns into 17 words (a 64-bit accumulator: four shifted
//     columns and the carry stay below 2^57);
//  2. Montgomery: add m * p with m = -V / p mod 2^256, a word at a time, so
//     the low 8 words vanish and X = (V + m p) / 2^256 < 2^263 is left in
//     the top 9 (each multiply-add with its carry stays below 2^64);
//  3. q = floor(floor(X / 2^250) * MU / 2^20) <= X / p, and X / p - q is
//     below 1 + X / 2^270 + 2^250 / p < 1.09, so X - q p < 2p and one
//     conditional subtraction of p ends it.
// (col may be a device lambda: no host instance is called from the card's code)
#ifdef __CUDACC__
#pragma nv_exec_check_disable
#endif
template <class Col>
FDEV void reduce_columns(uint32_t r[fld::NW], Col col) {
  using namespace fld;
  uint32_t v[17];
  uint64_t acc = 0;
#pragma unroll
  for (int w = 0; w < 16; w++) {
    acc += (uint64_t)col(4 * w) + ((uint64_t)col(4 * w + 1) << 8) +
           ((uint64_t)col(4 * w + 2) << 16);
    if (4 * w + 3 < COLS) acc += (uint64_t)col(4 * w + 3) << 24;
    v[w] = (uint32_t)acc;
    acc >>= 32;
  }
  v[16] = (uint32_t)acc;
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

}  // namespace mxu
