// Exact float32 1-nearest-neighbour for Hopper (sm_90a).
//
// Replaces gradslam_tpu/ops/knn.py::_knn_kernel (launched by _knn_pallas):
// for each of the (B, S, 3) sources, the squared distance and int32 index of
// the nearest valid target among (B, T, 4) packed targets [x, y, z, w], where
// w = +inf marks an invalid target that never wins. limit (B,) int32 is one
// past the last valid target of each batch entry (ops/knn.py::
// prepare_targets): no target at or beyond it is read.
//
// Contract, identical to the plain version (ops/knn.py::knn_reference):
//   - d = (dx*dx + dy*dy) + dz*dz with d_c = s_c - t_c, each operation
//     rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn, and -fmad=false):
//     nvcc would otherwise fuse it into FMAs, whose rounding flips near-tie
//     indices;
//   - ties go to the lowest target index;
//   - with no valid target the result is (inf, 0).
//
// What bounds it: float32 issue on the valid pairs. Each (source, valid
// target) pair costs 8 operations (3 sub, 3 mul, 2 add), each its own
// instruction on the non-tensor float32 units since nothing is fused; the
// bytes (12 per source, 16 per target, 8 per output) are negligible next to
// S * (valid targets) pairs. The design keeps other work off the pairs and
// fills the card from one launch:
//
//   1. Only the valid targets' work. [0, limit_b) is cut into equal
//      contiguous parts, one per warp of the cluster (below). A warp stages
//      its part through shared memory 64 targets a round; a ballot and a
//      prefix count drop the invalid ones on the way in, so the stage holds
//      valid targets only, as float4 {x, y, z, index bits} in ascending
//      index order, and no pair pays a validity test. On the main path the
//      valid targets are a prefix (compact_masked puts them first), so the
//      padded tail past limit_b is never read.
//   2. Register-tiled sources and a cheap argmin. Each lane keeps K sources
//      in registers, so a staged target is read once (one broadcast LDS.128
//      per warp) for K sources. A distance is +0 or more (or the canonical,
//      positive NaN), so its bits order as int32 like the float: a DPX
//      3-way min (__vimin3_s32) folds a run of 8 targets two at a time, and
//      one __vibmin_s32 a run keeps the running best with a strict `<`
//      together with the index of the run's first target. No pair pays a
//      compare-and-select for its index.
//   3. One launch. A thread-block cluster of `splits` blocks (at most 8, the
//      portable size) shares one tile of 32 * K sources; its splits * 4
//      warps walk the parts in (rank, warp) order, which is the targets'
//      order. The warps of a block fold in shared memory, then each block
//      folds a slice of the tile's sources across the cluster through
//      distributed shared memory after cluster.sync(), always in part order
//      with a strict `<`, so the first part to reach the minimum keeps it.
//      Only then is the index found, once per source: the first valid
//      target from the winning run on whose distance is the minimum (every
//      target before that run is farther). No scratch, no fill, no decode.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kStep = 64;     // targets a warp stages a round
constexpr int kPerLane = kStep / 32;
constexpr int kRun = 8;       // targets a run: one best update per run
constexpr int kWarps = 4;      // warps a block
constexpr int kMaxSplits = 8;  // the portable cluster size
static_assert(kStep % kRun == 0, "the padded round must fit the stage");
static_assert(kRun % 2 == 0, "a run folds its distances two at a time");

__device__ __forceinline__ float sq_dist(float sx, float sy, float sz, float4 t) {
  const float dx = __fsub_rn(sx, t.x);
  const float dy = __fsub_rn(sy, t.y);
  const float dz = __fsub_rn(sz, t.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__device__ __forceinline__ float4 load_target(const float4* tb, int j, int hi) {
  return j < hi ? tb[j] : make_float4(0.f, 0.f, 0.f, INFINITY);
}

// Grid: (source tiles * splits, B); cluster: (splits, 1, 1); kWarps warps a
// block. A cluster owns one tile of 32 * K sources, which every warp of
// every block holds (lane l: sources s0 + l + 32 k, k < K). [0, limit_b) is
// cut into splits * kWarps equal contiguous parts in (rank, warp) order; each
// warp walks its own part, so the parts' order is the targets' order.
template <int K>
__global__ void __launch_bounds__(32 * kWarps)
knn_cluster(const float* __restrict__ src, const float4* __restrict__ tgt,
            const int* __restrict__ limit, float* __restrict__ dist,
            int* __restrict__ idx, int S, int T) {
  constexpr int kTileS = 32 * K;
  __shared__ float4 stage[kWarps][kStep];
  __shared__ float part_d[kWarps][kTileS];
  __shared__ int part_r[kWarps][kTileS];
  __shared__ float block_d[kTileS];
  __shared__ int block_r[kTileS];

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int s0 = (blockIdx.x / splits) * kTileS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // best: the least distance's bits; best_run: index of the first target of
  // the run that reached it
  float sx[K], sy[K], sz[K];
  int best[K], best_run[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = min(s0 + lane + 32 * k, S - 1);
    const float* p = src + (static_cast<size_t>(b) * S + s) * 3;
    sx[k] = p[0];
    sy[k] = p[1];
    sz[k] = p[2];
    best[k] = __float_as_int(INFINITY);
    best_run[k] = 0;
  }

  // this warp's part of [0, limit_b)
  const int lim = min(max(limit[b], 0), T);
  const int parts = splits * kWarps;
  const int chunk = (lim + parts - 1) / parts;
  const int lo = min((rank * kWarps + warp) * chunk, lim);
  const int hi = min(lo + chunk, lim);
  const float4* tb = tgt + static_cast<size_t>(b) * T;
  const unsigned below = (1u << lane) - 1u;
  float4* buf = stage[warp];

  // the next round's targets load while this round is compared
  float4 a[kPerLane];
#pragma unroll
  for (int u = 0; u < kPerLane; ++u) a[u] = load_target(tb, lo + 32 * u + lane, hi);
  for (int base = lo; base < hi; base += kStep) {
    unsigned mask[kPerLane];
    bool valid[kPerLane];
    int n = 0;
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      valid[u] = base + 32 * u + lane < hi && !isinf(a[u].w);
      mask[u] = __ballot_sync(0xffffffffu, valid[u]);
    }
    __syncwarp();  // the warp is done with the previous round
#pragma unroll
    for (int u = 0; u < kPerLane; ++u) {
      const int j = base + 32 * u + lane;
      if (valid[u]) buf[n + __popc(mask[u] & below)] = make_float4(a[u].x, a[u].y, a[u].z, __int_as_float(j));
      n += __popc(mask[u]);
      a[u] = load_target(tb, j + kStep, hi);
    }
    // NaN pads the last run: the canonical NaN's bits exceed every
    // distance's, and == never hits it
    const int n_pad = (n + kRun - 1) / kRun * kRun;
    if (lane < n_pad - n) buf[n + lane] = make_float4(NAN, NAN, NAN, 0.f);
    __syncwarp();

    // a distance is +0 or more, or the canonical NaN, positive: its bits
    // order as int32 like the float, and a DPX 3-way min folds two a step
    for (int r0 = 0; r0 < n_pad; r0 += kRun) {
      int m[K], d_prev[K];
      int run = 0;
#pragma unroll
      for (int j = 0; j < kRun; ++j) {
        const float4 t = buf[r0 + j];
        if (j == 0) run = __float_as_int(t.w);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int d = __float_as_int(sq_dist(sx[k], sy[k], sz[k], t));
          if (j == 1) m[k] = min(d_prev[k], d);
          else if (j % 2 == 1) m[k] = __vimin3_s32(m[k], d_prev[k], d);
          d_prev[k] = d;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        bool keep;  // best <= m: an earlier run keeps a tie
        best[k] = __vibmin_s32(best[k], m[k], &keep);
        best_run[k] = keep ? best_run[k] : run;
      }
    }
  }

  // fold the block's warps, then the cluster's blocks, each in part order
  // with a strict `<`: the first part to reach the minimum keeps it
#pragma unroll
  for (int k = 0; k < K; ++k) {
    part_d[warp][lane + 32 * k] = __int_as_float(best[k]);
    part_r[warp][lane + 32 * k] = best_run[k];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kTileS; q += 32 * kWarps) {
    float bd = INFINITY;
    int br = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (part_d[w][q] < bd) {
        bd = part_d[w][q];
        br = part_r[w][q];
      }
    }
    block_d[q] = bd;
    block_r[q] = br;
  }
  cluster.sync();

  // block `rank` finishes sources [rank * per, (rank + 1) * per) of the
  // tile, each on the lane of warp 0 that holds it in registers
  const int per = (kTileS + splits - 1) / splits;
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = lane + 32 * k;
      const int s = s0 + q;
      if (q < rank * per || q >= (rank + 1) * per || s >= S) continue;
      float rd[kMaxSplits];
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r)
        rd[r] = r < splits ? cluster.map_shared_rank(block_d, r)[q] : INFINITY;
      float bd = rd[0];
      int rank_d = 0;
#pragma unroll
      for (int r = 1; r < kMaxSplits; ++r) {
        if (rd[r] < bd) {
          bd = rd[r];
          rank_d = r;
        }
      }
      const int br = cluster.map_shared_rank(block_r, rank_d)[q];
      // the index: the first valid target from the best run on whose
      // distance is bd. Every target before that run is farther, so it is
      // the first minimum; it lies in the run, so the scan ends there.
      int bi = 0;
      bool found = !(bd < INFINITY);
      for (int j = br; !found && j < lim; j += kRun) {
        float4 t[kRun];
#pragma unroll
        for (int u = 0; u < kRun; ++u) t[u] = load_target(tb, j + u, lim);
#pragma unroll
        for (int u = 0; u < kRun; ++u) {
          if (!found && !isinf(t[u].w) && sq_dist(sx[k], sy[k], sz[k], t[u]) == bd) {
            found = true;
            bi = j + u;
          }
        }
      }
      dist[static_cast<size_t>(b) * S + s] = bd;
      idx[static_cast<size_t>(b) * S + s] = bi;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int K>
cudaError_t launch(cudaLaunchConfig_t cfg, const float* src, const float4* tgt,
                   const int* limit, float* dist, int* idx, int S, int T) {
  cfg.gridDim.x *= (S + 32 * K - 1) / (32 * K);
  cfg.blockDim = dim3(32 * kWarps, 1, 1);
  return cudaLaunchKernelEx(&cfg, knn_cluster<K>, src, tgt, limit, dist, idx, S, T);
}

}  // namespace

// src (B, S, 3) float32, tgt (B, T, 4) float32 (16-byte aligned), limit (B,)
// int32, dist (B, S) float32, idx (B, S) int32; all contiguous on one device.
// k in {2, 4} sources a lane, splits in [1, 8] blocks a cluster. One launch
// on `stream`; returns its cudaError_t.
extern "C" int gst_knn(const float* src, const float* tgt, const int* limit,
                       float* dist, int* idx, int B, int S, int T, int k,
                       int splits, void* stream) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (splits < 1 || splits > kMaxSplits || (k != 2 && k != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const float4* t4 = reinterpret_cast<const float4*>(tgt);
  const cudaError_t err = k == 4 ? launch<4>(cfg, src, t4, limit, dist, idx, S, T)
                                 : launch<2>(cfg, src, t4, limit, dist, idx, S, T);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
