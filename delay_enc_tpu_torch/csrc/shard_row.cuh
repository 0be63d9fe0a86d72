// The bodies of K12, the sharded NTT's two kernels (csrc/shard.cu), for one
// position of the launch:
//
//   stages_at:     the m cross-shard stages at local position l, as a
//                  D-point network over the blocks' elements x_0[l] ..
//                  x_{D-1}[l] (D = 2^m), kept in registers;
//   reshuffle_at:  one element of the gather that puts the local
//                  transforms' outputs in natural block order, or takes
//                  them out of it.
//
// The wrapper (parallel/ntt.py _Args, the same layout) fills one Args a
// launch, passed by value: the address of every shard's block, local or a
// peer card's; the card's own shards and where their outputs go; and, for
// the stages, which nodes of each step the card's outputs need.  The
// functions are __host__ __device__, so that a host C++ compiler can build
// them (tests/test_torch_parallel.py).
//
// The network.  Stage s pairs node t (a top node: bit h of t clear,
// h = D >> (s + 1)) with b = t + h.  Forward (delay_enc_tpu/parallel/ntt.py
// _dif_stages), stages s = 0 .. m-1:
//
//   x_t <- x_t + x_b,    x_b <- (x_t - x_b) w_s,b[l]
//
// Inverse (sharded_intt's stages), s = m-1 .. 0, every inverse twiddle
// applied to the bottom operand before its butterfly, and 1/N as the
// outputs are stored:
//
//   x_b <- x_b w'_s,b[l];  x_t <- x_t + x_b,  x_b <- x_t - x_b
//
// w_s,b[l] = w^((i0 + l) 2^s), i0 = (b mod 2h - h) L, is row
// row_of(m, s, b) of the card's (D - 1, L, 8) table: the D - 1 distinct
// rows, stage after stage (D - (D >> s) rows before stage s's).  A node is
// computed only where the card's outputs need it (need[i], the nodes whose
// value after step i is read later): all of the network for a card that
// holds every shard, one path of D - 1 butterfly halves for a card that
// holds one.

#pragma once
#include <stddef.h>

#include "field.cuh"

namespace shard {

constexpr int MAX_SHARDS = 16;
constexpr int MAX_LOG = 4;  // log2 of MAX_SHARDS: the steps of the network

struct Args {
  uint64_t block[MAX_SHARDS];  // address of shard d's (n, 8) block, on any card
  uint64_t rows;               // stages: the (D - 1, n, 8) twiddle rows on this card
  uint64_t scale;              // inverse stages: 1/N, one element on this card
  uint64_t out;                // (count, n, 8) on this card
  int32_t slot[MAX_SHARDS];    // stages: output slot of shard d, -1 for another card's
  uint32_t shard[MAX_SHARDS];  // the shard of output slot i < count
  uint32_t need[MAX_LOG];      // stages: nodes whose value after step i is read
  uint32_t n, log_d, count, log_n;  // n = 2^log_n elements a block, D = 2^log_d
};

FDEV const uint32_t* at(uint64_t address) {
  return reinterpret_cast<const uint32_t*>(static_cast<uintptr_t>(address));
}

FDEV uint32_t* at_out(uint64_t address) {
  return reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(address));
}

// the row of the table that stage s's bottom node d multiplies by
FDEV int row_of(int log_d, int s, int d) {
  const int D = 1 << log_d, h = D >> (s + 1);
  return D - (D >> s) + (d & (h - 1));
}

FDEV uint32_t rev_bits(uint32_t x, uint32_t bits) {
  uint32_t r = 0;
  for (uint32_t i = 0; i < bits; i++) r |= ((x >> i) & 1u) << (bits - 1 - i);
  return r;
}

template <int LOG_D, bool INV>
FDEV void stages_at(const Args& a, uint32_t l) {
  constexpr int D = 1 << LOG_D;
  const size_t pos = (size_t)l * fld::NW;
  const size_t stride = (size_t)a.n * fld::NW;
  const uint32_t* rows = at(a.rows);
  uint32_t v[D][fld::NW];
#pragma unroll
  for (int d = 0; d < D; d++) fld::ld8(v[d], at(a.block[d]) + pos);
#pragma unroll
  for (int i = 0; i < LOG_D; i++) {
    const int s = INV ? LOG_D - 1 - i : i;
    const int h = D >> (s + 1);
    const uint32_t need = a.need[i];
#pragma unroll
    for (int t = 0; t < D; t++) {
      if (t & h) continue;
      const int b = t + h;
      const bool want_t = (need >> t) & 1u, want_b = (need >> b) & 1u;
      if (!want_t && !want_b) continue;
      uint32_t w[fld::NW], sum[fld::NW], diff[fld::NW];
      if (INV) {
        fld::ld8(w, rows + row_of(LOG_D, s, b) * stride + pos);
        fld::mont_mul<fld::FR>(v[b], v[b], w);
      }
      if (want_t) fld::add<fld::FR>(sum, v[t], v[b]);
      if (want_b) {
        fld::sub<fld::FR>(diff, v[t], v[b]);
        if (INV) {
          fld::copy(v[b], diff);
        } else {
          fld::ld8(w, rows + row_of(LOG_D, s, b) * stride + pos);
          fld::mont_mul<fld::FR>(v[b], diff, w);
        }
      }
      if (want_t) fld::copy(v[t], sum);
    }
  }
  uint32_t scale[fld::NW];
  if (INV) fld::ld8(scale, at(a.scale));
  uint32_t* out = at_out(a.out);
#pragma unroll
  for (int d = 0; d < D; d++) {
    const int slot = a.slot[d];
    if (slot < 0) continue;
    if (INV) fld::mont_mul<fld::FR>(v[d], v[d], scale);
    fld::st8(out + (size_t)slot * stride + pos, v[d]);
  }
}

// Thread i < count * n of the card's (count, n, 8) output.  Forward:
// out[q][t D + r] = y[rev(r)][q n/D + t] for the card's shard q, thread i
// the output's element i, so that a warp writes one run and reads runs of
// n/D-apart chunks.  Inverse: y[b][q n/D + t] = x[q][t D + rev(b)] for the
// card's shard b, thread i element i / count of slot i % count, so that
// neighbouring threads read neighbouring elements of x[q] (all D of
// t D .. t D + D - 1 where the card holds every shard) and write runs of
// each slot.
template <bool INV>
FDEV void reshuffle_at(const Args& a, size_t i) {
  const uint32_t chunk_log = a.log_n - a.log_d;
  uint32_t slot, j, src;
  size_t src_pos;
  if (INV) {
    const uint32_t k = (uint32_t)i;  // count * n < 2^32 (the wrapper checks)
    slot = k % a.count;
    j = k / a.count;
    src = j >> chunk_log;
    src_pos = ((size_t)(j & ((1u << chunk_log) - 1)) << a.log_d) +
              rev_bits(a.shard[slot], a.log_d);
  } else {
    slot = (uint32_t)(i >> a.log_n);
    j = (uint32_t)(i & (a.n - 1));
    src = rev_bits(j & ((1u << a.log_d) - 1), a.log_d);
    src_pos = ((size_t)a.shard[slot] << chunk_log) + (j >> a.log_d);
  }
  uint32_t v[fld::NW];
  fld::ld8(v, at(a.block[src]) + src_pos * fld::NW);
  fld::st8(at_out(a.out) + ((size_t)slot * a.n + j) * fld::NW, v);
}

}  // namespace shard
