// Exact float32 1-nearest-neighbour for Hopper (sm_90a).
//
// Replaces gradslam_tpu/ops/knn.py::_knn_kernel (launched by _knn_pallas):
// for each of the (B, S, 3) sources, the squared distance and int32 index of
// the nearest valid target among (B, T, 4) packed targets [x, y, z, w], where
// w = +inf marks an invalid target that never wins.
//
// Contract, identical to the plain version (ops/knn.py::knn_reference):
//   - d = (dx*dx + dy*dy) + dz*dz with d_c = s_c - t_c, each operation
//     rounded on its own (__fmul_rn / __fadd_rn): nvcc would otherwise fuse
//     it into FMAs, whose rounding flips near-tie indices;
//   - ties go to the lowest target index;
//   - with no valid target the result is (inf, 0).
//
// What bounds it: float32 ALU work, 8 operations per (source, valid target)
// pair (3 sub, 3 mul, 2 add, then a compare) on the non-tensor float32
// units, each its own instruction since nothing is fused, so at half the
// card's FMA-counted float32 peak; the bytes moved (12 per source, 16 per
// target, 8 per output) are negligible next to S*T pairs.
//
// Design: one thread per source keeps its running (min, argmin) in
// registers. A block owns 128 sources and one chunk of 512 targets, which
// it stages once in shared memory (8 KB) and walks in ascending order with
// a strict `<`, so the first minimum of the chunk wins. Chunks run in
// parallel blocks (grid.y), so a frame's small source set still fills the
// card. Each block folds its chunk result into a per-source 64-bit key
// (distance bits << 32 | index) with atomicMin: distances are non-negative,
// so their IEEE bits order like the values, and equal distances fall back
// to the lower index. The result is the same for any block order.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;  // sources per block
constexpr int kTile = 512;     // targets per block
constexpr unsigned long long kEmpty = ~0ull;

__global__ void knn_init(unsigned long long* __restrict__ best, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) best[i] = kEmpty;
}

__global__ void __launch_bounds__(kThreads)
knn_chunk(const float* __restrict__ src, const float4* __restrict__ tgt,
          unsigned long long* __restrict__ best, int S, int T) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.z;
  const int t0 = blockIdx.y * kTile;
  const int nt = min(kTile, T - t0);
  const float4* tb = tgt + (size_t)b * T + t0;
  for (int j = threadIdx.x; j < nt; j += kThreads) tile[j] = tb[j];
  __syncthreads();

  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const float* sp = src + ((size_t)b * S + s) * 3;
  const float sx = sp[0], sy = sp[1], sz = sp[2];

  float best_d = INFINITY;
  int best_j = 0;
  for (int j = 0; j < nt; ++j) {
    const float4 t = tile[j];
    const float dx = __fsub_rn(sx, t.x);
    const float dy = __fsub_rn(sy, t.y);
    const float dz = __fsub_rn(sz, t.z);
    float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                        __fmul_rn(dz, dz));
    if (isinf(t.w)) d = INFINITY;
    if (d < best_d) {
      best_d = d;
      best_j = j;
    }
  }
  if (best_d < INFINITY) {
    const unsigned long long key =
        ((unsigned long long)__float_as_uint(best_d) << 32) |
        (unsigned int)(t0 + best_j);
    atomicMin(best + (size_t)b * S + s, key);
  }
}

__global__ void knn_finalize(const unsigned long long* __restrict__ best,
                             float* __restrict__ dist, int* __restrict__ idx,
                             int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = best[i];
  if (key == kEmpty) {
    dist[i] = INFINITY;
    idx[i] = 0;
  } else {
    dist[i] = __uint_as_float((unsigned int)(key >> 32));
    idx[i] = (int)(key & 0xffffffffull);
  }
}

}  // namespace

// src (B, S, 3) float32, tgt (B, T, 4) float32, dist (B, S) float32,
// idx (B, S) int32, scratch (B, S) uint64; all contiguous on one device.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int gst_knn(const float* src, const float* tgt, float* dist,
                       int* idx, unsigned long long* scratch, int B, int S,
                       int T, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = B * S;
  if (n == 0) return static_cast<int>(cudaGetLastError());
  const int pt = 256;
  knn_init<<<(n + pt - 1) / pt, pt, 0, st>>>(scratch, n);
  if (T > 0) {
    dim3 grid((S + kThreads - 1) / kThreads, (T + kTile - 1) / kTile, B);
    knn_chunk<<<grid, kThreads, 0, st>>>(
        src, reinterpret_cast<const float4*>(tgt), scratch, S, T);
  }
  knn_finalize<<<(n + pt - 1) / pt, pt, 0, st>>>(scratch, dist, idx, n);
  return static_cast<int>(cudaGetLastError());
}
