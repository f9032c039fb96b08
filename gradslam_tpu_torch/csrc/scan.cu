// Batched masked prefix count for Hopper (sm_90a): the row scan of a (B, N)
// bool mask that turns its selected positions into compacted indices or
// into append slots.
//
// Replaces no TPU kernel. The JAX package's compact_masked
// (gradslam_tpu/ops/masking.py) is XLA's scatter or sort and its appends a
// cumsum, none of them a Pallas kernel. It was added because the port's
// plain form, torch.cumsum(mask, dim=1, dtype=int32) and the elementwise
// passes around it, took 37% of a whole sequence's device time: for more
// than one row ATen's scan_innermost_dim gives a long row one thread block
// of 512 threads, so a (2, 4,915,200) arena mask went to two blocks that
// each walked their row in 4,800 sequential chunks (7.4 ms a frame step)
// while 130 of the 132 SMs sat idle.
//
// Contract, identical to the plain versions (ops/masking.py::
// compact_masked_reference and append_slots_reference):
//   - compact: idx (B, out_size) int32, zeroed by the caller, gets the
//     position of the r-th selected entry of row b at [b, r] for every
//     r < out_size (the lowest positions win); count[b] = min(selected,
//     out_size);
//   - slots: slots[b, i] = num_points[b] + (selected entries of row b at or
//     before i) - 1 for every i, selected or not; count[b] = selected.
// Any nonzero mask byte counts as selected.
//
// What bounds it: bytes. Each mask byte is read once from HBM and each
// written index once: B*N + 4*B*out_size bytes, 11 MB at (2, 4,915,200) ->
// 153,600, 3.3 us at 3.35 TB/s. No arithmetic to speak of. So the design
// spreads every row over the whole card and reads it once from HBM:
//
//   1. gs_mask_scan_count: grid (tiles, B), one tile of 8,192 entries a
//      block of 512 threads. A thread makes one 16-byte load where the row
//      starts 16-byte aligned (byte loads otherwise and for a ragged tail),
//      turns its 16 bytes into a 16-bit mask and counts it with __popc; one
//      int32 a tile.
//   2. gs_mask_scan_place: the same grid. A block sums the counts of the
//      tiles before it in its row (a few hundred int32 from L2) and, in the
//      compact epilogue, leaves at once where that base is already past
//      out_size or its own tile holds nothing. Otherwise it reads its tile
//      again (from L2: the count pass just read it) in 16 rounds of one
//      entry a thread, so a warp's loads and stores are contiguous, and
//      ranks the entries with a block-wide ballot scan: a __ballot_sync a
//      round and warp, an exclusive scan of the 16 x 16 popcounts in
//      (round, warp) order, and __popc of the lanes below. It then writes
//      either the selected entries' positions at base + rank below
//      out_size or every entry's slot. The last tile of each row writes the
//      row's count.
//
// Integer sums and no atomics: every result is the same on every run and
// for any block order. The wrapper allocates every buffer on PyTorch's
// current stream and the launches go on that stream, so a CUDA graph
// captures them as it captures the eager calls.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;  // mask bytes a thread counts with one 16-byte load
constexpr int kTile = kThreads * kChunk;  // entries a block takes
constexpr unsigned kFull = 0xffffffffu;

// Bit k set where row[e + k] is nonzero, for the kChunk entries from e
// (entries at or past n read as 0). `vec`: the row starts 16-byte aligned.
__device__ __forceinline__ unsigned chunk_bits(const unsigned char* row, long long e, long long n,
                                               bool vec) {
  unsigned bits = 0;
  if (vec && e + kChunk <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + e));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if ((w[j] >> (8 * k)) & 0xffu) bits |= 1u << (4 * j + k);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (e + k < n && row[e + k]) bits |= 1u << k;
    }
  }
  return bits;
}

// The sum of x over the block, on every thread. Every thread calls it.
__device__ __forceinline__ int block_sum(int x) {
  __shared__ int warp_sum[kWarps];
  x = __reduce_add_sync(kFull, x);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
  __syncthreads();  // warp_sum is free again for the next call
  return total;
}

// The sum of x over the threads before this one (thread order), and the
// block's sum in *total. Every thread calls it.
__device__ __forceinline__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  const int before = warp ? warp_sum[warp - 1] : 0;
  *total = warp_sum[kWarps - 1];
  __syncthreads();  // warp_sum is free again for the next call
  return before + inc - x;
}

__global__ void __launch_bounds__(kThreads)
    gs_mask_scan_count(const unsigned char* __restrict__ mask, long long n, int* __restrict__ counts) {
  const int t = blockIdx.x, b = blockIdx.y;
  const unsigned char* row = mask + b * n;
  const bool vec = (reinterpret_cast<uintptr_t>(row) & 15) == 0;
  const long long e = static_cast<long long>(t) * kTile + threadIdx.x * kChunk;
  const int c = block_sum(__popc(chunk_bits(row, e, n, vec)));
  if (threadIdx.x == 0) counts[static_cast<long long>(b) * gridDim.x + t] = c;
}

// The compact epilogue (idx, out_size) or, with `to_slots`, the slots
// epilogue (num_points, slots).
__global__ void __launch_bounds__(kThreads)
    gs_mask_scan_place(const unsigned char* __restrict__ mask, long long n,
                       const int* __restrict__ counts, bool to_slots, int out_size,
                       int* __restrict__ idx, const int* __restrict__ num_points,
                       int* __restrict__ slots, int* __restrict__ row_count) {
  __shared__ int before[kChunk * kWarps];  // entries of the tile before each (round, warp)
  const int t = blockIdx.x, b = blockIdx.y, tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool compact = !to_slots;
  const bool last = t == tiles - 1;
  const int* rc = counts + static_cast<long long>(b) * tiles;
  // the row's entries before this tile (the last tile: in the whole row)
  int s = 0;
  for (int i = threadIdx.x; i < (last ? tiles : t); i += kThreads) s += rc[i];
  int base = block_sum(s);
  const int own = rc[t];
  if (last) {
    if (threadIdx.x == 0) row_count[b] = compact ? min(base, out_size) : base;
    base -= own;
  }
  if (compact && (base >= out_size || own == 0)) return;  // block-uniform

  // round k takes the tile's entries [k * kThreads, (k + 1) * kThreads), one
  // a thread in thread order, so a warp's loads and stores are contiguous
  const unsigned char* row = mask + b * n;
  const long long e0 = static_cast<long long>(t) * kTile + threadIdx.x;
  unsigned ballot[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const long long e = e0 + k * kThreads;
    ballot[k] = __ballot_sync(kFull, e < n && row[e] != 0);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) before[k * kWarps + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  int unused;
  const int x = threadIdx.x < kChunk * kWarps ? before[threadIdx.x] : 0;
  const int ex = block_exclusive_scan(x, &unused);
  if (threadIdx.x < kChunk * kWarps) before[threadIdx.x] = ex;
  __syncthreads();

  const unsigned lower = (1u << lane) - 1;  // the lanes before this one
  if (compact) {
    int* out = idx + static_cast<long long>(b) * out_size;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int rank = base + before[k * kWarps + warp] + __popc(ballot[k] & lower);
      if ((ballot[k] >> lane & 1u) && rank < out_size) out[rank] = static_cast<int>(e0 + k * kThreads);
    }
  } else {
    int* out = slots + static_cast<long long>(b) * n;
    const int start = num_points[b] + base - 1;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const long long e = e0 + k * kThreads;
      if (e < n) out[e] = start + before[k * kWarps + warp] + __popc(ballot[k] & (lower | (1u << lane)));
    }
  }
}

}  // namespace

// mask (B, n) bytes; counts (B, ceil(n / 8192)) int32 scratch; row_count
// (B,) int32. to_slots 0: idx (B, out_size) int32, zeroed. to_slots 1:
// num_points (B,) int32 and slots (B, n) int32. All contiguous on one
// device. Two launches on `stream`; returns the launches' own cudaError_t.
extern "C" int gs_mask_scan(const void* mask, int B, long long n, int* counts, int to_slots, int out_size,
                            int* idx, const int* num_points, int* slots, int* row_count, void* stream) {
  if (B <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const long long tiles = (n + kTile - 1) / kTile;
  if (B > 65535 || out_size < 0 || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(B));
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const unsigned char*>(mask);
  gs_mask_scan_count<<<grid, kThreads, 0, s>>>(m, n, counts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gs_mask_scan_place<<<grid, kThreads, 0, s>>>(m, n, counts, to_slots != 0, out_size, idx, num_points, slots,
                                               row_count);
  return static_cast<int>(cudaGetLastError());
}
