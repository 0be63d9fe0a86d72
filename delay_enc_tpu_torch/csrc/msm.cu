// K-c: MSM plane sums (complete-add reduction of each row of points) over
// the base-4 pair table, plane_sums16 the same over the base-16 one, the
// selector kernel that feeds both, K-d: elementwise complete addition, and
// the fixed-base batch scalar multiplication.  BN254 G1, projective
// Montgomery (X : Y : Z) over Fq, 24 words a point.
//
// K-c is the counterpart of delay_enc_tpu/ops/msm.py _jit_plane_sums
// (:328): the base-4 select and its XLA add tree.  plane_sums16 is the
// counterpart of the repo's one Pallas kernel, ops/msm_pallas.py _stage /
// tree_reduce (lane-halving complete-add tree levels over (C, 48, W)
// blocks), whose only caller is ops/msm16.py _jit_plane_sums16 (:180), with
// the one-hot s8 MXU select before it (:170).
// Blocks on the card run in parallel in no order, so nothing is carried
// from one block to the next, and a tree in which half of the threads drop
// out at every level wastes the integer pipe.  So the sum is cut into
// serial runs:
//   pass 1  every thread adds up a run of `run` consecutive lanes of one
//           row in registers and writes its partial sum; there is no tree,
//           no shared memory and no barrier, and all threads finish
//           together;
//   pass 2  one small block a row adds up that row's partials the same
//           way and folds its threads' sums with warp shuffles, then across
//           its warps through shared memory.
// The run, the block size and whether pass 1 is worth a launch are chosen
// per call from the rows and the width (ops/msm_tree.py: plan), so that the
// grid fills the card when there are few rows.  The row index is the
// fastest one in the grid: blocks that run together read the same lanes of
// the pair table.  In selector mode lane i of row c reads
// table[sel[c, i], i] from the (OPTS, W) pair table at load (the select
// fused), and a thread reads the selectors of its run 16 at a time.  Every
// lane is added whatever its selector: the time does not depend on the
// scalars.  The base-4 table (16 options, 50 MB at W = 2^15) stays in the
// L2 cache; the base-16 one (256 options, 805 MB) does not, so each of its
// loads is a 96-byte read from device memory: 5.8 GB a delay_enc k=16 proof,
// under 2 ms at 3.35 TB/s against 11.2 ms of products.  The 12 resident
// warps an SM hide those loads' latency: loading the next lane's point
// before the current addition (24 more registers, 168 a thread) measured
// the same on the H100 (PERF.md), so each point is loaded just before
// its addition.
//
// The selector kernel (pair_sel) is the counterpart of ops/msm.py
// _jit_pair_sel (:393, base 4) and ops/msm16.py _jit_pair_sel16 (:112,
// base 16): one thread a pair of scalars reads their 64 bytes and writes a
// byte to each plane's row (csrc/sel_row.cuh); neighbouring threads write
// neighbouring bytes.  Bound: bytes.
//
// K-d serves ops/msm.py _jit_pair_tables (:267) and ops/msm16.py
// _jit_pair_tables16 (:55): out[i] = a[i] + b[i % bmod].
//
// The fixed-base kernel replaces delay_enc_tpu/ops/msm.py
// fixed_base_batch_mul (:508), a 254-step scan of batched additions:
// out[i] = sum over bits b of bit_b(s_i) * table[b].  The (254, 24)-word
// table goes to shared memory once a block.  `split` threads share a
// scalar, thread s taking bits s, s + split, ... (neighbouring table
// entries, so their shared-memory reads do not collide), and fold their
// sums with shuffles.  A zero bit adds the identity.
//
// Bound of the sums: integer multiplies.  A complete addition is 12 Fq
// Montgomery products of 128 wide (32x32->64) multiplies each; the bytes
// moved (96 B a point read once) are small beside that.  The sums run in
// registers; the order of the additions differs from the TPU tree, so
// projective results differ while the affine points are the same.

#include <cuda_runtime.h>

#include "field.cuh"
#include "sel_row.cuh"

// Blocks of SUM_THREADS that must fit an SM: caps the registers a thread.
// tools/torch_msm_bench.py --define MSM_MIN_BLOCKS=n times another value;
// ops/msm_tree.py (SM_THREADS) lays its launches out for this one.
#ifndef MSM_MIN_BLOCKS
#define MSM_MIN_BLOCKS 3
#endif

namespace {

constexpr int PW = 24;  // words per point
constexpr int SUM_THREADS = 128;  // largest block of the sum kernels
constexpr int FB_BITS = 254;  // entries of the fixed-base table

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

// o = the point that lane + off of the warp holds in p
__device__ __forceinline__ void shfl_down_pt(fld::G1& o, const fld::G1& p, uint32_t off) {
#pragma unroll
  for (int j = 0; j < fld::NW; j++) {
    o.x[j] = __shfl_down_sync(0xffffffffu, p.x[j], off);
    o.y[j] = __shfl_down_sync(0xffffffffu, p.y[j], off);
    o.z[j] = __shfl_down_sync(0xffffffffu, p.z[j], off);
  }
}

// acc of lane 0 = the sum of acc over lanes 0..span-1 (span a power of two)
__device__ __forceinline__ void warp_fold(fld::G1& acc, uint32_t span) {
  fld::G1 p;
#pragma unroll 1
  for (uint32_t off = span >> 1; off > 0; off >>= 1) {
    shfl_down_pt(p, acc, off);
    fld::g1_add(acc, acc, p);
  }
}

// The point lane i of a row reads: point i of the row when srow is null,
// else option srow[i] of the (OPTS, width) table.  Called for i = lo, lo + 1,
// ... in order: where `wide`, the selectors come 16 at a time through s16.
template <uint32_t OPTS>
__device__ __forceinline__ size_t lane_point(const uint8_t* __restrict__ srow, bool wide,
                                             uint32_t lo, uint32_t i, uint32_t width,
                                             uint32_t row, uint4& s16) {
  if (srow == nullptr) return (size_t)row * width + i;
  uint32_t s;
  if (wide) {
    if (((i - lo) & 15u) == 0) s16 = *reinterpret_cast<const uint4*>(srow + i);
    s = s16.x;
    s16.x = __funnelshift_r(s16.x, s16.y, 8);
    s16.y = __funnelshift_r(s16.y, s16.z, 8);
    s16.z = __funnelshift_r(s16.z, s16.w, 8);
    s16.w >>= 8;
  } else {
    s = srow[i];
  }
  return (size_t)(s & (OPTS - 1u)) * width + i;
}

// grid (rows, chunks); block of 32, 64 or 128 threads.  Thread t of block
// (c, q) sums lanes [g * run, min(width, (g + 1) * run)) of row c, with
// g = q * blockDim.x + t.  Without FOLD it writes that sum to
// out[(c * chunks + q) * blockDim.x + t]; with FOLD the block adds up its
// threads' sums and writes one point to out[c * chunks + q].
// pts is (rows, width, 24) when sel is null, else the (OPTS, width, 24)
// table.
template <bool FOLD, uint32_t OPTS>
__device__ __forceinline__ void plane_sums_body(const uint32_t* __restrict__ pts,
                                                const uint8_t* __restrict__ sel,
                                                uint32_t* __restrict__ out, uint32_t width,
                                                uint32_t run) {
  const uint32_t row = blockIdx.x, q = blockIdx.y, chunks = gridDim.y;
  const uint32_t t = threadIdx.x;
  const uint64_t first = ((uint64_t)q * blockDim.x + t) * run;
  const uint32_t lo = first < width ? (uint32_t)first : width;
  const uint32_t hi = first + run < width ? (uint32_t)(first + run) : width;

  const uint8_t* srow = sel == nullptr ? nullptr : sel + (size_t)row * width;
  const bool wide = sel != nullptr && ((width | run) & 15u) == 0 &&
                    (reinterpret_cast<uintptr_t>(sel) & 15u) == 0;
  uint4 s16 = make_uint4(0, 0, 0, 0);

  fld::G1 acc, p;
  fld::g1_identity(acc);
#pragma unroll 1
  for (uint32_t i = lo; i < hi; i++) {
    load_pt(p, pts + lane_point<OPTS>(srow, wide, lo, i, width, row, s16) * PW);
    fld::g1_add(acc, acc, p);
  }

  if (!FOLD) {
    store_pt(out + (((size_t)row * chunks + q) * blockDim.x + t) * PW, acc);
    return;
  }
  __shared__ uint32_t sh[(SUM_THREADS / 32) * PW];
  const uint32_t lane = t & 31u, warp = t >> 5, nwarps = blockDim.x >> 5;
  warp_fold(acc, 32);
  if (nwarps > 1) {
    if (lane == 0) store_pt(sh + warp * PW, acc);
    __syncthreads();
    if (warp != 0) return;
    if (lane < nwarps) {
      load_pt(acc, sh + lane * PW);
    } else {
      fld::g1_identity(acc);
    }
    warp_fold(acc, nwarps);
  }
  if (t == 0) store_pt(out + ((size_t)row * chunks + q) * PW, acc);
}

// K-c: the base-4 table of 16 options
template <bool FOLD>
__global__ void __launch_bounds__(SUM_THREADS, MSM_MIN_BLOCKS)
plane_sums_kernel(const uint32_t* __restrict__ pts, const uint8_t* __restrict__ sel,
                  uint32_t* __restrict__ out, uint32_t width, uint32_t run) {
  plane_sums_body<FOLD, 16>(pts, sel, out, width, run);
}

// plane_sums16: the base-16 table of 256 options
template <bool FOLD>
__global__ void __launch_bounds__(SUM_THREADS, MSM_MIN_BLOCKS)
plane_sums16_kernel(const uint32_t* __restrict__ pts, const uint8_t* __restrict__ sel,
                    uint32_t* __restrict__ out, uint32_t width, uint32_t run) {
  plane_sums_body<FOLD, 256>(pts, sel, out, width, run);
}

// thread g serves pair g % m of batch g / m: scalars (B, 2m, 8) words, out
// (B, planes, m) selector bytes
template <uint32_t DB>
__global__ void __launch_bounds__(SUM_THREADS)
pair_sel_kernel(const uint32_t* __restrict__ scalars, uint8_t* __restrict__ out, uint32_t m,
                uint64_t total) {
  const uint64_t g = (uint64_t)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (g >= total) return;
  const uint64_t b = g / m, i = g % m;
  const uint4* src = reinterpret_cast<const uint4*>(scalars + g * 2 * fld::NW);
  uint32_t w[2 * fld::NW];
#pragma unroll
  for (int c = 0; c < 4; c++) {
    const uint4 v = src[c];
    w[4 * c] = v.x; w[4 * c + 1] = v.y; w[4 * c + 2] = v.z; w[4 * c + 3] = v.w;
  }
  psel::pair_sel_row<DB>(w, w + fld::NW, out + b * psel::planes<DB>() * m + i, m);
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

// block SUM_THREADS; thread g of the grid serves scalar g / split with the
// bits congruent to g % split; split divides 32, so the threads of a scalar
// share a warp.  table is (254, 24) words, scalars (n, 8) canonical words.
__global__ void __launch_bounds__(SUM_THREADS, MSM_MIN_BLOCKS)
fixed_base_kernel(const uint32_t* __restrict__ table,
                  const uint32_t* __restrict__ scalars,
                  uint32_t* __restrict__ out, uint32_t n, uint32_t split) {
  __shared__ uint4 tab[FB_BITS * PW / 4];
  const uint4* table4 = reinterpret_cast<const uint4*>(table);
  for (uint32_t i = threadIdx.x; i < FB_BITS * PW / 4; i += blockDim.x) tab[i] = table4[i];
  __syncthreads();

  const uint64_t g = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const uint64_t idx = g / split;
  const uint32_t s = (uint32_t)(g % split);
  // threads past the last scalar walk scalar 0 and store nothing: the
  // shuffles below need every lane of the warp
  const bool live = idx < n;
  const uint32_t* words = scalars + (live ? (size_t)idx * fld::NW : 0);

  fld::G1 acc, p;
  fld::g1_identity(acc);
  uint32_t word = 0;
#pragma unroll 1
  for (uint32_t b = s; b < FB_BITS; b += split) {
    if ((b & 31u) < split) word = words[b >> 5];  // this thread's first bit of the word
    const uint32_t mask = 0u - ((word >> (b & 31u)) & 1u);
    load_pt(p, reinterpret_cast<const uint32_t*>(tab) + b * PW);
#pragma unroll
    for (int j = 0; j < fld::NW; j++) {  // a zero bit adds (0 : 1 : 0)
      p.x[j] &= mask;
      p.y[j] = (p.y[j] & mask) | (fld::onew<fld::FQ>(j) & ~mask);
      p.z[j] &= mask;
    }
    fld::g1_add(acc, acc, p);
  }
  warp_fold(acc, split);
  if (live && s == 0) store_pt(out + (size_t)idx * PW, acc);
}

}  // namespace

// One pass of the plane sums: see plane_sums_body.  threads is 32, 64 or
// 128; out holds rows * chunks points with fold, else rows * chunks *
// threads.  plane_sums takes the base-4 table, plane_sums16 the base-16 one.
static int launch_sums(bool opts256, const void* pts, const void* sel, void* out,
                       unsigned rows, unsigned width, unsigned run, unsigned threads,
                       unsigned chunks, int fold, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0 || chunks == 0) return 0;
  if ((threads != 32 && threads != 64 && threads != SUM_THREADS) || run == 0 ||
      chunks > 65535u || (uint64_t)chunks * threads * run < width) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(rows, chunks);
  const uint32_t* p = static_cast<const uint32_t*>(pts);
  const uint8_t* sl = static_cast<const uint8_t*>(sel);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (opts256 && fold) {
    plane_sums16_kernel<true><<<grid, threads, 0, s>>>(p, sl, o, width, run);
  } else if (opts256) {
    plane_sums16_kernel<false><<<grid, threads, 0, s>>>(p, sl, o, width, run);
  } else if (fold) {
    plane_sums_kernel<true><<<grid, threads, 0, s>>>(p, sl, o, width, run);
  } else {
    plane_sums_kernel<false><<<grid, threads, 0, s>>>(p, sl, o, width, run);
  }
  return (int)cudaGetLastError();
}

extern "C" int plane_sums(const void* pts, const void* sel, void* out, unsigned rows,
                          unsigned width, unsigned run, unsigned threads, unsigned chunks,
                          int fold, void* stream) {
  return launch_sums(false, pts, sel, out, rows, width, run, threads, chunks, fold, stream);
}

extern "C" int plane_sums16(const void* pts, const void* sel, void* out, unsigned rows,
                            unsigned width, unsigned run, unsigned threads, unsigned chunks,
                            int fold, void* stream) {
  return launch_sums(true, pts, sel, out, rows, width, run, threads, chunks, fold, stream);
}

// (B, 2m, 8) canonical scalar words -> (B, planes, m) selector bytes, planes
// 127 for digit_bits 2 and 64 for digit_bits 4.  scalars 16-byte aligned.
extern "C" int pair_sel(const void* scalars, void* out, unsigned batch, unsigned m,
                        unsigned digit_bits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t total = (uint64_t)batch * m;
  if (total == 0) return 0;
  if ((digit_bits != 2 && digit_bits != 4) ||
      (reinterpret_cast<uintptr_t>(scalars) & 15u) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const uint64_t blocks = (total + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  const uint32_t* sc = static_cast<const uint32_t*>(scalars);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (digit_bits == 2) {
    pair_sel_kernel<2><<<(unsigned)blocks, SUM_THREADS, 0, s>>>(sc, o, m, total);
  } else {
    pair_sel_kernel<4><<<(unsigned)blocks, SUM_THREADS, 0, s>>>(sc, o, m, total);
  }
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

// out[i] = scalars[i] * P for the (254, 24) table of 2^b * P; split is 1,
// 2, 4, 8, 16 or 32 threads a scalar.
extern "C" int g1_fixed_base_mul(const void* table, const void* scalars,
                                 void* out, unsigned n, unsigned split,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return 0;
  if (split == 0 || split > 32 || (32 % split) != 0) return (int)cudaErrorInvalidValue;
  const uint64_t blocks = ((uint64_t)n * split + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > 0x7fffffffull) return (int)cudaErrorInvalidValue;
  fixed_base_kernel<<<(unsigned)blocks, SUM_THREADS, 0, s>>>(
      static_cast<const uint32_t*>(table), static_cast<const uint32_t*>(scalars),
      static_cast<uint32_t*>(out), n, split);
  return (int)cudaGetLastError();
}
