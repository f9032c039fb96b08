// Per-pixel fusion winner selection for Hopper (sm_90a).
//
// Replaces tools/diag_winner_radix.py::_rmw_kernel (launched by pallas_rmw,
// call at :137, body at :110): a per-pixel table that every candidate is
// folded into with a read-modify-write min. It is the bucket form of the
// fusion winner selection that the JAX package does with a 4-key lax.sort
// (gradslam_tpu/slam/fusionutils.py:609 on the dense window path, :904 on
// the exact and rows paths); in this port it replaces that sort, a cumsum
// and two scatters in every fusion step.
//
// Contract, identical to the plain version
// (ops/winner.py::pixel_winner_reference): for each pixel p < P of each
// batch entry b, out[b, p] is the slot of the candidate with the
// lexicographically smallest (k_hi, k_lo, slot) among the candidates with
// pix == p, the keys compared as unsigned 32-bit words; `sentinel` where
// there is none. Candidates with pix outside [0, P) never win. Slots lie in
// [0, sentinel).
//
// Design: two passes of one thread per candidate.
//   - Pass 1 folds the 64-bit key (u64)k_hi << 32 | k_lo into a (B, P) u64
//     table with atomicMin. The table starts at all ones (cudaMemsetAsync
//     0xff); the same pass fills the output table with `sentinel`.
//   - Pass 2: each candidate whose key equals its pixel's table entry folds
//     its slot into the output table with a 32-bit atomicMin.
// atomicMin is commutative, so the result does not depend on block order:
// it is exact and the same on every run. A single pass (a 128-bit
// compare-and-swap loop, or a key packed with a bounded slot width) is
// later work.
//
// What bounds it: bytes and L2 atomics, not arithmetic. Each candidate
// reads 12 bytes in pass 1 and 16 in pass 2 and issues one or two atomics
// that resolve in L2; each pixel costs 8 bytes of key table and 4 of output.
// There is no arithmetic to speak of.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // grid-stride beyond this

__device__ __forceinline__ unsigned long long pack_key(int hi, int lo) {
  return (static_cast<unsigned long long>(static_cast<unsigned int>(hi)) << 32) |
         static_cast<unsigned int>(lo);
}

__global__ void __launch_bounds__(kThreads)
winner_fold_keys(const int* __restrict__ pix, const int* __restrict__ k_hi,
                 const int* __restrict__ k_lo, unsigned long long* __restrict__ best,
                 int* __restrict__ out, long long n_cand, long long n_out, int N,
                 int P, int sentinel) {
  const long long total = n_cand > n_out ? n_cand : n_out;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < total; i += stride) {
    if (i < n_out) out[i] = sentinel;
    if (i < n_cand) {
      const int p = pix[i];
      if (static_cast<unsigned int>(p) < static_cast<unsigned int>(P)) {
        const long long b = i / N;
        atomicMin(best + b * P + p, pack_key(k_hi[i], k_lo[i]));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
winner_fold_slots(const int* __restrict__ pix, const int* __restrict__ k_hi,
                  const int* __restrict__ k_lo, const int* __restrict__ slot,
                  const unsigned long long* __restrict__ best, int* __restrict__ out,
                  long long n_cand, int N, int P) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_cand; i += stride) {
    const int p = pix[i];
    if (static_cast<unsigned int>(p) >= static_cast<unsigned int>(P)) continue;
    const long long t = (i / N) * P + p;
    if (best[t] == pack_key(k_hi[i], k_lo[i])) atomicMin(out + t, slot[i]);
  }
}

int blocks_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// pix, k_hi, k_lo, slot (B, N) int32; best (B, P) uint64 scratch; out (B, P)
// int32; all contiguous on one device. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int gst_pixel_winner(const int* pix, const int* k_hi, const int* k_lo,
                                const int* slot, unsigned long long* best, int* out,
                                int B, int N, int P, int sentinel, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n_cand = static_cast<long long>(B) * N;
  const long long n_out = static_cast<long long>(B) * P;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(best, 0xff, n_out * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = n_cand > n_out ? n_cand : n_out;
  winner_fold_keys<<<blocks_for(total), kThreads, 0, st>>>(
      pix, k_hi, k_lo, best, out, n_cand, n_out, N, P, sentinel);
  if (n_cand > 0) {
    winner_fold_slots<<<blocks_for(n_cand), kThreads, 0, st>>>(
        pix, k_hi, k_lo, slot, best, out, n_cand, N, P);
  }
  return static_cast<int>(cudaGetLastError());
}
