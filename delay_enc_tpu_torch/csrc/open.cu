// K7: the openings' contractions of coefficient rows with the powers of a
// point, for all the points of a proof in one launch each.
//
// Replaces delay_enc_tpu/plonk/kernels.py _jit_eval_stack (:396) and the
// v-weighted sum of _jit_gwc_witness (:411) with the * z^i of
// ops/poly.py:137 divide_by_linear, which XLA ran as limb graphs over
// (m, n, 16) stacks, and which the port ran as K-a products, a transposed
// copy of each stack and a K-a add launch a level of each add tree: 68
// launches a delay_enc proof.  The rest of divide_by_linear (the exclusive
// suffix sum, csrc/scan.cu, and the product by z^-(i+1)) is unchanged.
//
// open_eval: a block a (chunk of EVAL_CHUNK elements, row); each thread
// multiplies and adds its elements (csrc/open_row.cuh), the block sums its
// threads in shared memory and leaves a partial sum in the scratch; the last
// block of a row to finish, which an atomic ticket after a fence names (the
// CUDA programming guide's "last block" pattern), sums the row's partials.
// open_combine: a thread a column of one point; it walks the point's rows,
// so a warp reads 32 neighbouring elements of each row.  Both take one table
// an instance of the batched prover (_jit_eval_stack_batch and
// _jit_gwc_witness_batch, delay_enc_tpu/plonk/batch_prover.py:103-107), up to
// opening::MAX_TABLES a launch, the instance from blockIdx.z: a block past
// its own table's chunks, rows or points returns at once.
//
// Bound: operations.  At delay_enc k=16 (57 rows of 2^16 over 3 points)
// eval makes 57 x 2^16 Montgomery products (0.057 ms at 1.673e13
// multiply-adds a second) and reads 126 MB (0.038 ms at 3.35 TB/s);
// combine makes (57 + 3) x 2^16 (0.060 ms).

#include <cuda_runtime.h>

#include <cstring>

#include "open_row.cuh"

namespace {

constexpr unsigned COMBINE_THREADS = 128;

// The sum of every thread's acc, into every thread's acc: an add tree over
// shared memory.
template <unsigned THREADS>
__device__ void block_sum(uint32_t acc[8], uint32_t (*red)[8]) {
  fld::copy(red[threadIdx.x], acc);
  __syncthreads();
  for (unsigned w = THREADS / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) fld::add<fld::FR>(red[threadIdx.x], red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  fld::copy(acc, red[0]);
  __syncthreads();  // red is written again by the next sum
}

__device__ __forceinline__ void st8_to_l2(uint32_t* p, const uint32_t v[8]) {
  __stcg(reinterpret_cast<uint4*>(p), make_uint4(v[0], v[1], v[2], v[3]));
  __stcg(reinterpret_cast<uint4*>(p) + 1, make_uint4(v[4], v[5], v[6], v[7]));
}

__device__ __forceinline__ void ld8_from_l2(uint32_t r[8], const uint32_t* p) {
  const uint4 lo = __ldcg(reinterpret_cast<const uint4*>(p));
  const uint4 hi = __ldcg(reinterpret_cast<const uint4*>(p) + 1);
  r[0] = lo.x; r[1] = lo.y; r[2] = lo.z; r[3] = lo.w;
  r[4] = hi.x; r[5] = hi.y; r[6] = hi.z; r[7] = hi.w;
}

__global__ void __launch_bounds__(opening::EVAL_THREADS)
open_eval_kernel(const __grid_constant__ opening::Tables all) {
  __shared__ uint32_t red[opening::EVAL_THREADS][8];
  __shared__ bool last;
  const opening::Table& t = all.t[blockIdx.z];
  const uint32_t r = blockIdx.y, chunk = blockIdx.x, chunks = opening::chunks(t);
  if (r >= opening::rows(t) || chunk >= chunks) return;
  uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(t.out));
  uint32_t* partial = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(t.scratch));
  uint32_t acc[8];
  opening::eval_thread(acc, t, r, chunk, threadIdx.x);
  block_sum<opening::EVAL_THREADS>(acc, red);
  if (chunks == 1) {
    if (threadIdx.x == 0) fld::st8(out + (size_t)r * 8, acc);
    return;
  }
  if (threadIdx.x == 0) {
    uint32_t* counter = partial + (size_t)opening::rows(t) * chunks * 8 + r;
    st8_to_l2(partial + ((size_t)r * chunks + chunk) * 8, acc);
    __threadfence();
    last = atomicAdd(counter, 1u) == chunks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  opening::zero(acc);
  for (uint32_t c = threadIdx.x; c < chunks; c += opening::EVAL_THREADS) {
    uint32_t v[8];
    ld8_from_l2(v, partial + ((size_t)r * chunks + c) * 8);
    fld::add<fld::FR>(acc, acc, v);
  }
  block_sum<opening::EVAL_THREADS>(acc, red);
  if (threadIdx.x == 0) fld::st8(out + (size_t)r * 8, acc);
}

__global__ void __launch_bounds__(COMBINE_THREADS)
open_combine_kernel(const __grid_constant__ opening::Tables all) {
  __shared__ __align__(16) uint32_t vp[opening::MAX_ROWS * 8];
  const opening::Table& t = all.t[blockIdx.z];
  const uint32_t s = blockIdx.y;
  if (s >= t.points || (size_t)blockIdx.x * COMBINE_THREADS >= t.n) return;
  const uint32_t words = (t.first[s + 1] - t.first[s]) * 8;
  const uint32_t* v = opening::at(t.vpows);
  for (uint32_t w = threadIdx.x; w < words; w += COMBINE_THREADS) vp[w] = v[w];
  __syncthreads();
  const size_t i = (size_t)blockIdx.x * COMBINE_THREADS + threadIdx.x;
  if (i >= t.n) return;
  uint32_t o[8];
  opening::combine_column(o, t, s, i, vp);
  uint32_t* out = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(t.out));
  fld::st8(out + ((size_t)s * t.n + i) * 8, o);
}

int check(const opening::Table& t) {
  if (t.points == 0 || t.points > opening::MAX_POINTS) return (int)cudaErrorInvalidValue;
  for (uint32_t s = 0; s < t.points; s++)
    if (t.first[s + 1] < t.first[s]) return (int)cudaErrorInvalidValue;
  if (t.first[0] != 0 || opening::rows(t) > opening::MAX_ROWS) return (int)cudaErrorInvalidValue;
  return 0;
}

// `count` host tables into `all`, each checked; the grid's x and y: the
// largest count of eval chunks (or combine blocks) and of rows (or points)
int gather(opening::Tables& all, const void* tables, unsigned count, bool eval, uint32_t& x,
           uint32_t& y) {
  if (count == 0 || count > (unsigned)opening::MAX_TABLES) return (int)cudaErrorInvalidValue;
  std::memcpy(all.t, tables, count * sizeof(opening::Table));
  x = y = 0;
  for (unsigned b = 0; b < count; b++) {
    const opening::Table& t = all.t[b];
    if (const int e = check(t)) return e;
    const uint32_t bx = eval ? opening::chunks(t) : (t.n + COMBINE_THREADS - 1) / COMBINE_THREADS;
    const uint32_t by = eval ? opening::rows(t) : t.points;
    if (bx > x) x = bx;
    if (by > y) y = by;
  }
  return 0;
}

}  // namespace

// tables: host memory, `count` opening::Table; each table's scratch holds
// rows * chunks * 8 + rows words for eval (chunks = ceil(n / EVAL_CHUNK)).
extern "C" int open_eval(const void* tables, unsigned count, void* stream) {
  opening::Tables all;
  uint32_t chunks, rows;
  if (const int e = gather(all, tables, count, true, chunks, rows)) return e;
  if (chunks == 0 || rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (unsigned b = 0; b < count; b++) {
    const opening::Table& t = all.t[b];
    const uint32_t c = opening::chunks(t);
    if (c <= 1 || opening::rows(t) == 0) continue;
    uint32_t* counters = reinterpret_cast<uint32_t*>(static_cast<uintptr_t>(t.scratch)) +
                         (size_t)opening::rows(t) * c * 8;
    const cudaError_t e = cudaMemsetAsync(counters, 0, opening::rows(t) * 4, s);
    if (e != cudaSuccess) return (int)e;
  }
  open_eval_kernel<<<dim3(chunks, rows, count), opening::EVAL_THREADS, 0, s>>>(all);
  return (int)cudaGetLastError();
}

// tables: host memory, `count` opening::Table; no scratch.
extern "C" int open_combine(const void* tables, unsigned count, void* stream) {
  opening::Tables all;
  uint32_t blocks, points;
  if (const int e = gather(all, tables, count, false, blocks, points)) return e;
  if (blocks == 0) return 0;
  open_combine_kernel<<<dim3(blocks, points, count), COMBINE_THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(all);
  return (int)cudaGetLastError();
}
