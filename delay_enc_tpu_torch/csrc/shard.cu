// K12: the sharded NTT's cross-shard stages and its reshuffle, one launch
// of each a card and direction.
//
// Replaces delay_enc_tpu/parallel/ntt.py _dif_stages (:99-114), the
// inverse stages of sharded_intt (:164-182), and the all_to_all, take and
// transpose of _forward_local (:117-129) and sharded_intt (:155-160).
// There each stage is a ppermute of a whole block and three or four limb
// passes, and the reshuffle an all_to_all and two copies.  On Hopper a
// kernel reads its partners' blocks in place (over NVLink through peer
// pointers, or as plain loads when the shards share the card), so:
//
//   shard_stages:     all m stages at once, a thread a local position l:
//                     the D elements x_d[l] are loaded with 16-byte vector
//                     loads (the l axis is contiguous in every block), the
//                     network runs in registers (csrc/shard_row.cuh
//                     stages_at, D a template argument so that every index
//                     is a constant), and only the card's own shards are
//                     stored, into one (s, L, 8) stack, which K-b then
//                     transforms in one call;
//   shard_reshuffle:  the gather out[q][t D + r] = y[rev(r)][q L/D + t]
//                     (or its inverse), a thread an output element, from
//                     the D stacks wherever they lie.
//
// Nothing is kept in shared memory: no element is read twice.  The wrapper
// orders the launch after every producer card's stream and keeps remote
// blocks alive until it has run (parallel/ntt.py).
//
// Bound: bytes.  shard_stages reads D L 32 B of blocks and the rows its
// nodes use, and writes s L 32 B; at D = 4 with the four shards on one card
// and L = 2^14 that is 5.5 MB, 1.6 us at 3.35 TB/s, against 4 Montgomery
// products a position (1.0 us of integer work at 1.67e13 multiply-adds a
// second).  shard_reshuffle reads and writes s L 32 B.

#include <cuda_runtime.h>

#include "shard_row.cuh"

namespace {

constexpr unsigned STAGE_THREADS = 128;
constexpr unsigned RESHUFFLE_THREADS = 256;

template <int LOG_D, bool INV>
__global__ void __launch_bounds__(STAGE_THREADS) shard_stages_kernel(const shard::Args a) {
  const uint32_t l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= a.n) return;
  shard::stages_at<LOG_D, INV>(a, l);
}

template <bool INV>
__global__ void __launch_bounds__(RESHUFFLE_THREADS) shard_reshuffle_kernel(const shard::Args a) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ((size_t)a.count << a.log_n)) return;
  shard::reshuffle_at<INV>(a, i);
}

template <bool INV>
int launch_stages(const shard::Args& a, cudaStream_t s) {
  const unsigned blocks = (a.n + STAGE_THREADS - 1) / STAGE_THREADS;
  switch (a.log_d) {
    case 0: shard_stages_kernel<0, INV><<<blocks, STAGE_THREADS, 0, s>>>(a); break;
    case 1: shard_stages_kernel<1, INV><<<blocks, STAGE_THREADS, 0, s>>>(a); break;
    case 2: shard_stages_kernel<2, INV><<<blocks, STAGE_THREADS, 0, s>>>(a); break;
    case 3: shard_stages_kernel<3, INV><<<blocks, STAGE_THREADS, 0, s>>>(a); break;
    case 4: shard_stages_kernel<4, INV><<<blocks, STAGE_THREADS, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

bool valid(const shard::Args& a) {
  return a.log_d <= (unsigned)shard::MAX_LOG && a.log_n < 32 && a.n == (1u << a.log_n) &&
         a.log_d <= a.log_n && a.count >= 1 && a.count <= (1u << a.log_d) && a.out != 0;
}

}  // namespace

// args: host memory, one shard::Args; inverse 0 or 1
extern "C" int shard_stages(const void* args, int inverse, void* stream) {
  const shard::Args a = *static_cast<const shard::Args*>(args);
  if (!valid(a) || (inverse && a.scale == 0) || (a.log_d > 0 && a.rows == 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return inverse ? launch_stages<true>(a, s) : launch_stages<false>(a, s);
}

extern "C" int shard_reshuffle(const void* args, int inverse, void* stream) {
  const shard::Args a = *static_cast<const shard::Args*>(args);
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)a.count << a.log_n;
  const unsigned blocks = (unsigned)((total + RESHUFFLE_THREADS - 1) / RESHUFFLE_THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (inverse) {
    shard_reshuffle_kernel<true><<<blocks, RESHUFFLE_THREADS, 0, s>>>(a);
  } else {
    shard_reshuffle_kernel<false><<<blocks, RESHUFFLE_THREADS, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// Lets card `device` read card `peer`'s memory; access that is already on
// is no error.  The calling thread's current card is left as it was.
extern "C" int shard_enable_peer(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return (int)e;
  if ((e = cudaSetDevice(device)) != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    e = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return (int)(e != cudaSuccess ? e : back);
}
