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
//    the product reads them (csrc/ntt_mxu_row.cuh); for the second step it
//    reads C transposed, so no transpose is stored;
//  - mxu_product_kernel multiplies the fixed planes by the data planes with
//    mma.m16n8k32 (u8 x u8 -> s32) and, in its epilogue, carries each
//    output element's 63 byte columns, Montgomery-reduces them with 32-bit
//    integer multiplies and, in the first step, multiplies by T.
// The TPU graph multiplied 64 nibble planes in bf16 and reduced with band
// matmuls and a Barrett tail; the card's int8 tensor cores take bytes, and
// its integer units reduce.
//
// Exactness: a column of one output element sums, over K <= 1024 terms, at
// most 32 byte products (one for each plane pair with a + b = c), so it is
// at most 32 * 1024 * 255^2 = 2,130,739,200 < 2^31: the s32 accumulators
// and the u32 sums in shared memory hold it exactly.  A warp sums 16 x 16
// plane pairs (a quadrant), at most half of a column.
//
// Bound: operations.  A step multiplies 1024 byte pairs for every term:
// 1024 * m * K * q multiply-adds for an (m, K) by (K, q) step, against
// 32 bytes an element moved.  A block computes one 16 x 8 tile of output
// elements with 4 warps, one a quadrant of the 32 x 32 plane pairs, each
// holding 31 columns of 16 x 8 accumulators (124 registers); the fragments
// come straight from global memory (each is read by two warps of the block,
// through L1).  The data planes' K tiles may be fewer than the fixed
// operand's: the coset transform's input is zero from row n1 / 8 of A on,
// and its first step runs only the K tiles that hold data.
//
// mxu_reduce_kernel runs the same reduction over given columns (the
// adversarial cases of chip_smoke.py); no transform launches it.

#include <cuda_runtime.h>

#include "ntt_mxu_row.cuh"

namespace {

using mxu::COLS;
using mxu::PLANES;
using mxu::TILE_ELEMS;
using mxu::TILE_K;
using mxu::TILE_M;
using mxu::TILE_N;

constexpr int WARPS = 4;  // the four quadrants of the plane pairs
constexpr int QUAD = PLANES / 2;
constexpr int QUAD_COLS = 2 * QUAD - 1;  // 31 columns a quadrant touches

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
  uint32_t col_tiles;   // ceil(q / 8)
  uint32_t w_ktiles;    // K tiles of the fixed operand's buffer
  uint32_t ktiles;      // K tiles of the data operand, which this step runs
};

// One thread a (polynomial, column tile, K tile, lane, register): four
// elements of one column, 4 bytes of each of the 32 planes.  For a fixed
// plane the 64 threads of a group store 64 consecutive words.
__global__ void __launch_bounds__(256)
mxu_split_kernel(const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, Split S,
                 size_t groups) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t grp = tid >> 6;
  if (grp >= groups) return;
  const uint32_t lane = (tid >> 1) & 31u, reg = tid & 1u;
  const uint32_t kt = grp % S.ktiles;
  const size_t zj = grp / S.ktiles;
  const uint32_t jt = zj % S.col_tiles;
  const size_t z = zj / S.col_tiles;
  uint32_t e[4][fld::NW];
#pragma unroll
  for (uint32_t q = 0; q < 4; q++) {
    uint32_t col, k;
    mxu::b_pos(lane, reg, q, col, k);
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
  uint32_t* o = dst + grp * PLANES * 64 + lane * 2 + reg;
#pragma unroll
  for (int b = 0; b < PLANES; b++) {
    const int w = b >> 2, sh = 8 * (b & 3);
    o[b * 64] = ((e[0][w] >> sh) & 0xffu) | (((e[1][w] >> sh) & 0xffu) << 8) |
                (((e[2][w] >> sh) & 0xffu) << 16) | (((e[3][w] >> sh) & 0xffu) << 24);
  }
}

__device__ __forceinline__ void mma_u8(uint32_t (&d)[4], const uint4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// One block a 16 x 8 output tile (blockIdx.x its column tile, .y its row
// tile, .z the polynomial); warp w sums the plane pairs a in
// [16 (w / 2), +16), b in [16 (w % 2), +16) into its 31 columns.
__global__ void __launch_bounds__(WARPS * 32, 2)
mxu_product_kernel(const uint4* __restrict__ wf, const uint2* __restrict__ df,
                   const uint32_t* __restrict__ t_tab, uint32_t* __restrict__ out, Step S) {
  __shared__ uint32_t cols[COLS * TILE_ELEMS];
  const uint32_t lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const uint32_t qa = warp >> 1, qb = warp & 1u;
  const uint32_t jt = blockIdx.x, it = blockIdx.y;
  const size_t z = blockIdx.z;
  uint32_t acc[QUAD_COLS][4];
#pragma unroll
  for (int c = 0; c < QUAD_COLS; c++)
#pragma unroll
    for (int r = 0; r < 4; r++) acc[c][r] = 0;
  const uint4* wp = wf + ((size_t)it * S.w_ktiles * PLANES + qa * QUAD) * 32 + lane;
  const uint2* dp = df + (((z * S.col_tiles + jt) * S.ktiles) * PLANES + qb * QUAD) * 32 + lane;
  for (uint32_t kt = 0; kt < S.ktiles; kt++) {
    uint2 b[QUAD];
#pragma unroll
    for (int j = 0; j < QUAD; j++) b[j] = __ldg(dp + j * 32);
#pragma unroll
    for (int i = 0; i < QUAD; i++) {
      const uint4 a = __ldg(wp + i * 32);
#pragma unroll
      for (int j = 0; j < QUAD; j++) mma_u8(acc[i + j], a, b[j]);
    }
    wp += PLANES * 32;
    dp += PLANES * 32;
  }
  for (uint32_t e = threadIdx.x; e < COLS * TILE_ELEMS; e += blockDim.x) cols[e] = 0;
  __syncthreads();
  const uint32_t c0 = QUAD * (qa + qb);
#pragma unroll
  for (int c = 0; c < QUAD_COLS; c++)
#pragma unroll
    for (int r = 0; r < 4; r++)
      atomicAdd(&cols[(c0 + c) * TILE_ELEMS + mxu::acc_elem(lane, r)], acc[c][r]);
  __syncthreads();
  const uint32_t e = threadIdx.x;
  const uint32_t i = it * TILE_M + e / TILE_N, j = jt * TILE_N + e % TILE_N;
  if (i >= S.rows || j >= S.cols) return;
  uint32_t r[fld::NW];
  mxu::reduce_columns(r, [&](int c) { return cols[c * TILE_ELEMS + e]; });
  const size_t idx = (size_t)i * S.cols + j;
  if (t_tab != nullptr) {
    uint32_t t[fld::NW], x[fld::NW];
    fld::ld8(t, t_tab + idx * fld::NW);
    fld::copy(x, r);
    fld::mont_mul<fld::FR>(r, x, t);
  }
  fld::st8(out + (z * S.rows * S.cols + idx) * fld::NW, r);
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

}  // namespace

// The data planes of `batch` polynomials for one step: dst holds
// batch * col_tiles * ktiles groups of 32 planes x 64 words.
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
// t_tab (rows, cols) elements or null.
extern "C" int ntt_mxu_product(const void* wf, const void* df, const void* t_tab, void* out,
                               unsigned batch, unsigned rows, unsigned cols, unsigned row_tiles,
                               unsigned col_tiles, unsigned w_ktiles, unsigned ktiles,
                               void* stream) {
  if (batch == 0) return 0;
  if (ktiles == 0 || ktiles > w_ktiles || batch > 65535 || row_tiles > 65535 ||
      row_tiles * TILE_M < rows || col_tiles * TILE_N < cols)
    return (int)cudaErrorInvalidValue;
  const Step S = {rows, cols, col_tiles, w_ktiles, ktiles};
  const dim3 grid(col_tiles, row_tiles, batch);
  mxu_product_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(wf), static_cast<const uint2*>(df),
      static_cast<const uint32_t*>(t_tab), static_cast<uint32_t*>(out), S);
  return (int)cudaGetLastError();
}

// count elements' 63 columns (count, 63) -> (count, 8) reduced words.
extern "C" int ntt_mxu_reduce(const void* cols, void* out, unsigned count, void* stream) {
  if (count == 0) return 0;
  mxu_reduce_kernel<<<(count + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(cols), static_cast<uint32_t*>(out), count);
  return (int)cudaGetLastError();
}
