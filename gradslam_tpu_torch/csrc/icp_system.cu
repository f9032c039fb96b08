// One gradLM point-to-plane ICP iteration for Hopper (sm_90a), around the
// two KNN launches of csrc/knn.cu: the linearization at the current sources
// and its normal-equation sums, the damped 6x6 solve and its lookahead step,
// and the gated step that moves the sources and the pose.
//
// Replaces no TPU kernel. The JAX package's gradICP
// (gradslam_tpu/odometry/icputils.py::point_to_plane_gradICP) is XLA's
// fusion of gathers, products, sums and a batched solve. It was added
// because the port's op-by-op form of the same iteration
// (odometry/icputils.py::_gradicp_loop: the gather, the rows' stack, the
// broadcast products and per-element sums of solve_linear_system, two
// se3_exp, three transform_pointcloud and the gates) is about 206 ATen
// kernels besides its two KNN launches, each a few microseconds long on
// kilobytes of data: at B = 2, S = 4,800 (a 240x320 frame at dsratio 4)
// that took 3.4 ms a frame, 54% of a PointFusion step's device time on an
// H100.
//
// Contract, that of the op-by-op iteration (ops/icp_system.py has the plain
// versions, which the CPU runs):
//   - gs_icp_linearize: for each source i of batch element b, with the
//     KNN's (dist, idx) and the packed target row [t, n] = tgt[b, idx]:
//     w = isfinite(dist) * [dist < thresh] * src_w * huber(r, delta), the
//     row a = [n, s x n] and r = n . (t - s); the block's sums of
//     a_j w a_k (j <= k, 21 in row-major order), a_j w r (6) and w r^2 (1)
//     into partials[b, block, 0:28];
//   - gs_icp_lookahead: the element's sums over every block, x the solution
//     of (AtWA + damp I) x = AtWb, one_step = transform(src, se3_exp(x));
//     block 0 also writes xi = x and err = sum w r^2;
//   - gs_icp_update: new_err = the lookahead linearization's sum w r^2,
//     errdiff = clamp(new_err - err, -70, 70), damp *= lambda_min +
//     (lambda_max - lambda_min) / (1 + exp(-B errdiff)), rt = se3_exp(xi /
//     (1 + exp(-B2 errdiff))^(1/nu)); src = transform(src, rt) in place and,
//     in block 0, transform = rt . transform and the new damp.
// Every operation is float32 and follows the order in which PyTorch
// evaluates the op-by-op form. A Python number over a tensor is the
// tensor's reciprocal times the number there (Tensor.__rtruediv__), so
// huber_weights' delta / |r| is delta * (1 / |r|) here, and the damping's
// lambda_min + range / (1 + e) is range * (1 / (e + 1)) + lambda_min.
// transform(p, T) is (T0 x + T1 y) + (T2 z + T3) over the homogeneous
// divide of geometry/geometryutils.py::transform_pointcloud, with no FMA
// contraction (-fmad=false), so given the same pose its points are bit-equal
// to transform_pointcloud's. Only the sums run in another order.
//
// What bounds it: launches. One linearization reads 12 B of point, 4 + 4 B
// of KNN output, 4 B of weight and 24 B of target row a source and writes
// 112 B a block; a step reads and writes 12 B a source. At B·S = 9,600
// that is under 0.5 MB, 0.15 us at 3.35 TB/s, against a few microseconds a
// launch. So the design is the fewest launches that need no
// grid-wide barrier and no float atomics, with nothing read twice from HBM:
//
//   1. gs_icp_linearize: grid (blocks, B), 256 sources a block of 128
//      threads (two a thread, a warp's loads contiguous), each thread's 28
//      sums in registers, then a fixed shuffle tree in each warp and the
//      four warps in order. One (B, blocks, 28) float32 partial a block.
//   2. gs_icp_lookahead: the same grid. Every block folds its element's
//      partials in the same fixed order (lane k takes blocks k, k + 32, ...,
//      then a shuffle tree), so every block computes the same bits; thread 0
//      solves by LU with partial pivoting in registers and takes se3_exp;
//      the block then transforms its own 256 sources.
//   3. gs_icp_update: the same grid, after the lookahead's KNN and
//      linearization: the same fold of the error term alone, the gates and
//      the step on thread 0, the block's sources moved in place.
//
// The partition into blocks depends on S alone, never on B, and every sum
// has one fixed order: a batch element's pose has the same bits alone and in
// any batch, and every run gives the same bits. The wrapper allocates every
// buffer, and the launches go on PyTorch's current stream, so a CUDA graph
// captures them as it captures the eager calls.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 2;                      // sources a thread
constexpr int kSources = kThreads * kPerThread;    // sources a block (ops/icp_system.py: SOURCES_PER_BLOCK)
constexpr int kTerms = 28;                         // 21 of AtWA, 6 of AtWb, sum w r^2
constexpr int kErr = 27;
constexpr unsigned kFull = 0xffffffffu;
// se3_exp's small-angle gate: ||omega||^2 < (1e-6)^2, as geometry/se3.py
constexpr float kSmallAngleSq = static_cast<float>(1e-6 * 1e-6);

// The sum over the warp, in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// out[q] for q in [q0, q1): the sum of part[k * kTerms + q] over the nblk
// blocks k, lane l taking k = l, l + 32, ... then the warp's tree; quantity q
// goes to warp q % kWarps. The order depends on nblk alone.
__device__ __forceinline__ void fold(const float* __restrict__ part, int nblk, int q0, int q1, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int q = q0 + warp; q < q1; q += kWarps) {
    float s = 0.f;
    for (int k = lane; k < nblk; k += 32) s += part[static_cast<long long>(k) * kTerms + q];
    s = warp_sum(s);
    if (lane == 0) out[q] = s;
  }
}

// x in (-inf, lo) -> lo, (hi, inf) -> hi, NaN kept, as torch.clamp.
__device__ __forceinline__ float clampf(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

// geometry/se3.py::se3_exp of xi = [v, omega] into T (4x4, row-major).
__device__ void se3_exp(const float* xi, float* T) {
  const float ox = xi[3], oy = xi[4], oz = xi[5];
  const float h[9] = {0.f, -oz, oy, oz, 0.f, -ox, -oy, ox, 0.f};
  float h2[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) h2[3 * i + j] = (h[3 * i] * h[j] + h[3 * i + 1] * h[3 + j]) + h[3 * i + 2] * h[6 + j];
  }
  const float th_sq = (ox * ox + oy * oy) + oz * oz;
  const bool small = th_sq < kSmallAngleSq;
  const float th = sqrtf(small ? 1.f : th_sq);
  const float s = sinf(th), c = cosf(th);
  const float a = small ? 1.f : s / th;
  const float b = (1.f - c) / (th * th);
  const float br = small ? 0.f : b, bv = small ? 1.f : b;
  const float cv = small ? 0.f : (th - s) / (th * th * th);
  float V[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.f : 0.f;
      T[4 * i + j] = (eye + a * h[3 * i + j]) + br * h2[3 * i + j];
      V[3 * i + j] = (eye + bv * h[3 * i + j]) + cv * h2[3 * i + j];
    }
    T[4 * i + 3] = (V[3 * i] * xi[0] + V[3 * i + 1] * xi[1]) + V[3 * i + 2] * xi[2];
  }
  T[12] = 0.f, T[13] = 0.f, T[14] = 0.f, T[15] = 1.f;
}

// Solves (M + damp I) x = r, M symmetric from its 21 upper entries (row-major),
// by LU with partial pivoting (the first largest pivot), in float32.
__device__ void solve6(const float* upper, const float* rhs, float damp, float* x) {
  float M[6][6], r[6];
  int q = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = i; j < 6; ++j, ++q) M[i][j] = M[j][i] = upper[q];
    M[i][i] = M[i][i] + damp;
    r[i] = rhs[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(M[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(M[i][k]) > best) best = fabsf(M[i][k]), p = i;
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = M[k][j];
          M[k][j] = M[i][j], M[i][j] = t;
        }
        const float t = r[k];
        r[k] = r[i], r[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float f = M[i][k] / M[k][k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) M[i][j] = M[i][j] - f * M[k][j];
      r[i] = r[i] - f * r[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = r[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - M[i][j] * x[j];
    x[i] = s / M[i][i];
  }
}

// geometry/geometryutils.py::transform_pointcloud of one point.
__device__ __forceinline__ void transform_point(const float* T, const float* p, float* out) {
  const float x = p[0], y = p[1], z = p[2];
  const float w = (T[12] * x + T[13] * y) + (T[14] * z + T[15]);
  const float scale = fabsf(w) > 1e-6f ? 1.f / w : 1.f;
  const float o0 = ((T[0] * x + T[1] * y) + (T[2] * z + T[3])) * scale;
  const float o1 = ((T[4] * x + T[5] * y) + (T[6] * z + T[7])) * scale;
  const float o2 = ((T[8] * x + T[9] * y) + (T[10] * z + T[11])) * scale;
  out[0] = o0, out[1] = o1, out[2] = o2;
}

// Moves the block's sources of element b: out = transform(in, T). `in` and
// `out` may be the same buffer (each thread reads its point, then writes it).
__device__ __forceinline__ void transform_block(const float* T, const float* in, float* out, int b, int S) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = blockIdx.x * kSources + k * kThreads + threadIdx.x;
    if (i < S) {
      const long long p = (static_cast<long long>(b) * S + i) * 3;
      transform_point(T, in + p, out + p);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gs_icp_linearize(const float* __restrict__ src, const float* __restrict__ dist, const int* __restrict__ idx,
                     const float* __restrict__ tgt, long long T, const float* __restrict__ src_w, int S,
                     bool use_thresh, float thresh, bool use_huber, float delta, float* __restrict__ partials) {
  __shared__ float warp_part[kWarps][kTerms];
  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[kTerms];
#pragma unroll
  for (int q = 0; q < kTerms; ++q) acc[q] = 0.f;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = blockIdx.x * kSources + k * kThreads + threadIdx.x;
    if (i >= S) continue;
    const long long p = static_cast<long long>(b) * S + i;
    const float sx = src[3 * p], sy = src[3 * p + 1], sz = src[3 * p + 2];
    const float d = dist[p];
    float w = fabsf(d) < INFINITY ? 1.f : 0.f;  // isfinite(d)
    if (use_thresh) w = w * (d < thresh ? 1.f : 0.f);
    if (src_w != nullptr) w = w * src_w[p];
    float row[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // T = 0: no target, and w = 0
    if (T > 0) {
      const float* t = tgt + (static_cast<long long>(b) * T + idx[p]) * 6;
#pragma unroll
      for (int j = 0; j < 6; ++j) row[j] = t[j];
    }
    const float nx = row[3], ny = row[4], nz = row[5];
    const float a[6] = {nx, ny, nz, nz * sy - ny * sz, nx * sz - nz * sx, ny * sx - nx * sy};
    const float r = (nx * (row[0] - sx) + ny * (row[1] - sy)) + nz * (row[2] - sz);
    if (use_huber) w = w * clampf(delta * (1.f / clampf(fabsf(r), 1e-12f, INFINITY)), -INFINITY, 1.f);
    float aw[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) aw[j] = a[j] * w;
    int q = 0;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
#pragma unroll
      for (int l = j; l < 6; ++l, ++q) acc[q] += aw[j] * a[l];
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) acc[21 + j] += aw[j] * r;
    acc[kErr] += w * (r * r);
  }
#pragma unroll
  for (int q = 0; q < kTerms; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) warp_part[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTerms) {
    float s = warp_part[0][threadIdx.x];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) s += warp_part[v][threadIdx.x];
    partials[(static_cast<long long>(b) * gridDim.x + blockIdx.x) * kTerms + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
    gs_icp_lookahead(const float* __restrict__ src, int S, const float* __restrict__ partials,
                     const float* __restrict__ damp, float* __restrict__ xi, float* __restrict__ err,
                     float* __restrict__ one_step) {
  __shared__ float sums[kTerms];
  __shared__ float pose[16];
  const int b = blockIdx.y, nblk = gridDim.x;
  fold(partials + static_cast<long long>(b) * nblk * kTerms, nblk, 0, kTerms, sums);
  __syncthreads();
  if (threadIdx.x == 0) {
    float x[6];
    solve6(sums, sums + 21, damp[b], x);
    se3_exp(x, pose);
    if (blockIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < 6; ++j) xi[6 * b + j] = x[j];
      err[b] = sums[kErr];
    }
  }
  __syncthreads();
  transform_block(pose, src, one_step, b, S);
}

__global__ void __launch_bounds__(kThreads)
    gs_icp_update(float* __restrict__ src, int S, const float* __restrict__ partials, const float* __restrict__ xi,
                  const float* __restrict__ err, float* __restrict__ damp, float* __restrict__ transform,
                  float neg_b, float neg_b2, float inv_nu, float lambda_min, float lambda_range) {
  __shared__ float sums[kTerms];
  __shared__ float pose[16];
  const int b = blockIdx.y, nblk = gridDim.x;
  fold(partials + static_cast<long long>(b) * nblk * kTerms, nblk, kErr, kErr + 1, sums);
  __syncthreads();
  if (threadIdx.x == 0) {
    const float errdiff = clampf(sums[kErr] - err[b], -70.f, 70.f);
    const float sigmoid = 1.f / powf(expf(neg_b2 * errdiff) + 1.f, inv_nu);
    float x[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = sigmoid * xi[6 * b + j];
    se3_exp(x, pose);
    if (blockIdx.x == 0) {
      damp[b] = damp[b] * (lambda_range * (1.f / (expf(neg_b * errdiff) + 1.f)) + lambda_min);
      float* Tb = transform + 16 * b;
      float out[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          out[4 * i + j] = ((pose[4 * i] * Tb[j] + pose[4 * i + 1] * Tb[4 + j]) + pose[4 * i + 2] * Tb[8 + j]) +
                           pose[4 * i + 3] * Tb[12 + j];
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) Tb[j] = out[j];
    }
  }
  __syncthreads();
  transform_block(pose, src, src, b, S);
}

inline dim3 grid_of(int B, int S) { return dim3(static_cast<unsigned>(S > 0 ? (S + kSources - 1) / kSources : 1), B); }

}  // namespace

// src (B, S, 3), dist (B, S), idx (B, S) int32, tgt (B, T, 6), src_w (B, S)
// or null, partials (B, blocks, 28) with blocks = max(1, ceil(S / 256)); all
// float32 but idx, contiguous, on one device. Each entry point is one launch
// on `stream` and returns the launch's cudaError_t.
extern "C" int gs_icp_linearize_launch(const float* src, const float* dist, const int* idx, const float* tgt,
                                       long long T, const float* src_w, int B, int S, int use_thresh, float thresh,
                                       int use_huber, float delta, float* partials, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  gs_icp_linearize<<<grid_of(B, S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, dist, idx, tgt, T, src_w, S, use_thresh != 0, thresh, use_huber != 0, delta, partials);
  return static_cast<int>(cudaGetLastError());
}

// xi (B, 6), err (B,), damp (B,), one_step (B, S, 3).
extern "C" int gs_icp_lookahead_launch(const float* src, int B, int S, const float* partials, const float* damp,
                                       float* xi, float* err, float* one_step, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  gs_icp_lookahead<<<grid_of(B, S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(src, S, partials, damp, xi,
                                                                                       err, one_step);
  return static_cast<int>(cudaGetLastError());
}

// src (B, S, 3) and transform (B, 4, 4) updated in place; the gates as
// float32: -B, -B2, 1 / nu, lambda_min = 1 / lambda_max, lambda_max -
// lambda_min.
extern "C" int gs_icp_update_launch(float* src, int B, int S, const float* partials, const float* xi,
                                    const float* err, float* damp, float* transform, float neg_b, float neg_b2,
                                    float inv_nu, float lambda_min, float lambda_range, void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (B > 65535 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
  gs_icp_update<<<grid_of(B, S), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, S, partials, xi, err, damp, transform, neg_b, neg_b2, inv_nu, lambda_min, lambda_range);
  return static_cast<int>(cudaGetLastError());
}
