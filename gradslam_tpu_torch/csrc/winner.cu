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
// What bounds it: not arithmetic, and not HBM bytes (16 B a candidate and
// 4 B a pixel, about 2 us at the ScanNet geometry, usually still in L2),
// but the fixed cost of each device operation (a few microseconds: the
// launch, and the grid barrier between the two folds) and the L2 atomics of
// the two folds. So the design makes one launch per selection, with no
// memset:
//
//   1. One cooperative launch, no more blocks than the card holds at once,
//      a grid-stride loop over the (B * N) candidates. Each thread keeps
//      its first kKeep candidates' (pixel, key, slot) in registers for the
//      second fold; the rest are read again there (from L2).
//   2. Fold the keys: a 64-bit atomicMin of (u64)k_hi << 32 | k_lo into a
//      (B, P) u64 table `best` in global memory (native on global memory;
//      Hopper has no 64-bit min on shared memory, which is a compare-and-
//      swap loop there). The same phase fills `out` with the sentinel.
//   3. grid.sync(), then fold the slots: each candidate whose key equals its
//      pixel's entry folds its slot into `out` with a 32-bit atomicMin.
//   4. No memset: `best` is all ones on entry. The wrapper keeps two such
//      tables a stream and alternates them; phase 2 also resets to all ones
//      the first `n_other` entries of the other table, which the previous
//      call on the stream left dirty. So one grid barrier is enough. (A
//      call captured into a CUDA graph gets a table of its own, which the
//      graph fills before the kernel: ops/winner.py.)
//
// The launch goes through cudaLaunchKernelEx with the cooperative
// attribute, which a CUDA graph can hold as a kernel node, so a stream
// capture takes it as it takes the eager call.
//
// When every candidate of a warp's round lands on one pixel (a hot pixel),
// the warp folds in registers first and issues one atomic. atomicMin
// commutes with itself and the table values only fall, so the result is
// exact and the same for any block order and on every run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kKeep = 2;  // candidates a thread keeps in registers between the folds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long pack_key(int hi, int lo) {
  return (static_cast<unsigned long long>(static_cast<unsigned int>(hi)) << 32) |
         static_cast<unsigned int>(lo);
}

// True when the warp's lanes in mask `m`, more than one, all hold the same t.
__device__ __forceinline__ bool one_pixel(unsigned m, bool in, long long t) {
  const long long t0 = __shfl_sync(kFull, t, __ffs(m) - 1);
  return __popc(m) > 1 && __all_sync(kFull, !in || t == t0);
}

// Fold 1 for one warp round: every lane with `in` folds its key into
// best[t]. Warp-uniform; all 32 lanes call it.
__device__ __forceinline__ void fold_key(bool in, long long t, unsigned long long key,
                                         unsigned long long* best) {
  const unsigned m = __ballot_sync(kFull, in);
  if (m == 0) return;
  if (one_pixel(m, in, t)) {
    unsigned long long k = in ? key : ~0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) k = min(k, __shfl_xor_sync(kFull, k, o));
    if ((threadIdx.x & 31) == __ffs(m) - 1) atomicMin(best + t, k);
  } else if (in) {
    atomicMin(best + t, key);
  }
}

// Fold 2 for one warp round: every lane with `in` whose key is best[t]
// folds its slot into out[t].
__device__ __forceinline__ void fold_slot(bool in, long long t, unsigned long long key, int slot,
                                          const unsigned long long* best, int* out) {
  const bool hit = in && best[t] == key;
  const unsigned m = __ballot_sync(kFull, hit);
  if (m == 0) return;
  if (one_pixel(m, hit, t)) {
    const int s = __reduce_min_sync(kFull, hit ? slot : INT_MAX);
    if ((threadIdx.x & 31) == __ffs(m) - 1) atomicMin(out + t, s);
  } else if (hit) {
    atomicMin(out + t, slot);
  }
}

// A candidate i of the flattened (B, N) inputs: in (pix in [0, P)), its
// table entry t = b * P + pix, and its key.
struct Cand {
  bool in;
  long long t;
  unsigned long long key;
};

__device__ __forceinline__ Cand candidate(const int* pix, const int* k_hi, const int* k_lo,
                                          long long i, long long n_cand, int N, int P) {
  const int p = i < n_cand ? pix[i] : -1;
  const bool in = static_cast<unsigned>(p) < static_cast<unsigned>(P);
  return Cand{in, in ? (i / N) * P + p : 0, in ? pack_key(k_hi[i], k_lo[i]) : 0ull};
}

// Grid: blocks (all resident, cooperative launch); kThreads threads.
__global__ void __launch_bounds__(kThreads)
winner_grid(const int* __restrict__ pix, const int* __restrict__ k_hi,
            const int* __restrict__ k_lo, const int* __restrict__ slot,
            unsigned long long* __restrict__ best, unsigned long long* __restrict__ other,
            long long n_other, int* __restrict__ out, int B, int N, int P, int sentinel) {
  cg::grid_group grid = cg::this_grid();
  const long long n_cand = static_cast<long long>(B) * N;
  const long long n_out = static_cast<long long>(B) * P;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;

  // 2. fold the keys; fill the output; reset the previous call's table
  for (long long i = tid; i < n_out; i += stride) out[i] = sentinel;
  for (long long i = tid; i < n_other; i += stride) other[i] = ~0ull;
  Cand kept[kKeep];
  int kept_slot[kKeep];
#pragma unroll
  for (int u = 0; u < kKeep; ++u) {
    const long long i = tid + u * stride;
    kept[u] = candidate(pix, k_hi, k_lo, i, n_cand, N, P);
    kept_slot[u] = kept[u].in ? slot[i] : 0;
  }
#pragma unroll
  for (int u = 0; u < kKeep; ++u) fold_key(kept[u].in, kept[u].t, kept[u].key, best);
  // the rest, a warp-uniform loop so that all lanes fold together
  for (long long w = tid - lane + kKeep * stride; w < n_cand; w += stride) {
    const Cand c = candidate(pix, k_hi, k_lo, w + lane, n_cand, N, P);
    fold_key(c.in, c.t, c.key, best);
  }
  grid.sync();

  // 3. fold the slots of the candidates whose key is their pixel's
#pragma unroll
  for (int u = 0; u < kKeep; ++u) fold_slot(kept[u].in, kept[u].t, kept[u].key, kept_slot[u], best, out);
  for (long long w = tid - lane + kKeep * stride; w < n_cand; w += stride) {
    const Cand c = candidate(pix, k_hi, k_lo, w + lane, n_cand, N, P);
    fold_slot(c.in, c.t, c.key, c.in ? slot[w + lane] : 0, best, out);
  }
}

}  // namespace

// How many blocks of the kernel the current device holds at once (the most
// a cooperative launch may have) into *blocks. Returns a cudaError_t.
extern "C" int gst_pixel_winner_max_blocks(int* blocks) {
  *blocks = 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, winner_grid, kThreads, 0);
  if (err == cudaSuccess) *blocks = sms * per_sm;
  return static_cast<int>(err);
}

// pix, k_hi, k_lo, slot (B, N) int32; best (B * P) uint64, all ones; other
// (n_other) uint64, reset to all ones here; out (B, P) int32; all
// contiguous on one device. One cooperative launch of `blocks` blocks on
// `stream` (captured when the stream is); returns the launch's own
// cudaError_t, not an error left pending by an earlier call (a launch the
// card refuses never runs).
extern "C" int gst_pixel_winner(const int* pix, const int* k_hi, const int* k_lo,
                                const int* slot, unsigned long long* best,
                                unsigned long long* other, long long n_other, int* out, int B,
                                int N, int P, int sentinel, int blocks, void* stream) {
  if (B <= 0 || P <= 0) return static_cast<int>(cudaSuccess);
  if (N < 0 || blocks < 1 || n_other < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, winner_grid, pix, k_hi, k_lo, slot, best, other,
                                             n_other, out, B, N, P, sentinel));
}
