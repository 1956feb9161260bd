// Exact k-nearest-neighbour search over a masked map, for Hopper (sm_90a):
// the map preparation and the search.
//
// Replaces: lili_om_tpu/ops/knn_pallas.py:_knn_kernel_counted (launched by
// knn_pallas_counted, with its pre-pass :303-326), and _knn_kernel
// (knn_pallas) through the same entry: the dense launch is this search with
// the walk bounded by the prepared bound too. Contract of both: for each
// query, the k nearest valid map points, ascending squared distance, ties to
// the lower index; slots without a neighbour, and rows of invalid queries,
// hold (+inf, 0). The result equals the plain version's (ops/knn.py:knn)
// bit for bit.
//
// Two kernels:
//   * lili_knn_map: the map prepared once (ops/knn.py:KnnMap). Blocks 1..
//     write the float4 rows, the mask in lane 3 (0 valid, +inf masked);
//     block 0 reduces the walk bound, one past the last valid row (0 for an
//     empty or all-masked map), from 16-byte reads of the mask, and writes it
//     as a device int32: no host sync. It is knn_pallas_counted's pre-pass
//     (masking, padding, the last valid row) in one launch.
//   * lili_knn_f32: the search. kThreads threads a block, a warp per query
//     (kLanes = 32 lanes), so a block holds kThreads / 32 queries. The map
//     is staged in kTile-row tiles by cp.async into a double buffer (the
//     next tile copied while the current one is scanned) up to the bound;
//     lane l scans rows start + l, start + l + 32, ... of each tile, so over
//     the walk it sees the rows r = l (mod 32) in ascending order and keeps
//     their top-k in registers by insertion with a strict compare. The 32
//     lists of a query are merged once, after the walk, by (d^2, index) with
//     warp shuffles (knn_common.cuh:merge_lanes, B3's merge). A block whose
//     queries are all invalid skips the walk.
//
// Exactness. Distances are ((dx^2+dy^2)+dz^2) + mask lane with
// round-to-nearest intrinsics (no FMA contraction), the plain version's
// order. Each lane's list is the top-k of its rows in the (d^2, index)
// order (ascending rows, strict compare), and the merge takes the top-k of
// the union in that order, so neither the lane split nor the tile size can
// change ties: ops/knn.py:knn_lanes_schedule is this schedule in torch ops
// and equals knn. What is not carried over from the TPU kernel: the lane
// index packed into the low 12 mantissa bits of each distance, and the
// ||q||^2+||p||^2-2q.p expansion around the centroid (the direct (q-p)^2
// needs no centring).
//
// What bounds it on this card: operations, 8 f32 operations per (valid
// query, valid point) pair; the inputs are under 2 MB. The first version
// of this kernel ran one thread per query, 64 a block: at the Livox ICP
// site (0.9k-1.9k valid queries of 16384, valid-first) 15-30 active blocks
// of two warps, 30-60 warps on 132 SMs, each lane walking the whole valid
// map (3.5k points) in series. With a warp per query the active warps are
// the valid queries: at the Livox ICP site 0.9k-1.9k (7-14 a SM, each lane
// walking ~110 points), at the main-path odometry 2.7k (of 4096), fusion
// surf up to 6.1k (of 6144), fusion edge ~0.5k (of 3072); every staged
// tile is read by 8 queries at a time. A sweep of 4, 8, 16 and 32 lanes a
// query (PERF.md) found 32 fastest at 7 of the 10 sites of the path; at
// the fully valid fusion surf 8 lanes were 20 % faster (32 lanes 25 %
// slower). Known weakness: at k = 5 a lane inserts into its own list on
// ~1 point in 7 of a short walk, and the warp then runs the insertion for
// all its lanes, so k = 5 costs 2-3x k = 1 at the ICP site. The preparation
// moves the map once (12 B read, 16 B written a row, 1 B of mask read).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "knn_common.cuh"

namespace {

using namespace lili_knn;

constexpr int kThreads = 256;     // search threads per block
constexpr int kLanes = 32;        // threads per query: a warp
constexpr int kQB = kThreads / kLanes;  // queries per block
constexpr int kTile = 512;        // map rows per staged tile (8 KB), two buffers
constexpr int kMapThreads = 256;  // preparation threads per block

// ---- preparation: the float4 rows, and the walk bound ---------------------
__global__ void __launch_bounds__(kMapThreads)
map_kernel(const float* __restrict__ pts, long long stride, const unsigned char* __restrict__ mask,
           int n, float4* __restrict__ pts4, int* __restrict__ bound) {
  if (blockIdx.x > 0) {
    const int r = (blockIdx.x - 1) * kMapThreads + threadIdx.x;
    if (r < n) {
      const float* p = pts + r * stride;
      const bool ok = mask == nullptr || mask[r] != 0;
      pts4[r] = make_float4(p[0], p[1], p[2], ok ? 0.f : CUDART_INF_F);
    }
    return;
  }
  __shared__ int s_last[kMapThreads / 32];
  int last = 0;
  if (mask == nullptr) {
    last = n;
  } else {
    // 16 mask bytes a read where the mask is 16-byte aligned; a bool is 0
    // or 1, so the highest set bit of a nonzero word names its last valid row
    const bool vec = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
    const int n16 = vec ? (n & ~15) : 0;
    const uint4* m16 = reinterpret_cast<const uint4*>(mask);
#pragma unroll 4
    for (int c = threadIdx.x; c < n16 / 16; c += kMapThreads) {
      const uint4 v = m16[c];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (w[b] != 0u) last = max(last, 16 * c + 4 * b + (31 - __clz(w[b])) / 8 + 1);
    }
    for (int r = n16 + threadIdx.x; r < n; r += kMapThreads)
      if (mask[r] != 0) last = max(last, r + 1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) last = max(last, __shfl_xor_sync(kFull, last, off));
  if ((threadIdx.x & 31) == 0) s_last[threadIdx.x >> 5] = last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int m = 0;
#pragma unroll
    for (int w = 0; w < kMapThreads / 32; ++w) m = max(m, s_last[w]);
    *bound = m;
  }
}

// ---- search ----------------------------------------------------------------
// rows [start, start + len) of the map into shared memory by cp.async; every
// thread commits one group, copies or not
__device__ __forceinline__ void stage_tile(float4* dst, const float4* pts4, int start, int len) {
  for (int j = threadIdx.x; j < len; j += kThreads) cp_async16(&dst[j], pts4 + start + j);
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
search_kernel(const float* __restrict__ q, const unsigned char* __restrict__ q_mask, int n_q,
              const float4* __restrict__ pts4, const int* __restrict__ bound, int n_cap,
              float* __restrict__ out_d, long long* __restrict__ out_i) {
  __shared__ __align__(16) float4 s_pts[2][kTile];
  const int lane = threadIdx.x % kLanes;
  const int qi = blockIdx.x * kQB + threadIdx.x / kLanes;
  const bool in_range = qi < n_q;
  const bool active = in_range && (q_mask == nullptr || q_mask[qi] != 0);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  // a block with no valid query skips the walk (uniform branch)
  if (__syncthreads_or(active)) {
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
      qx = q[3 * qi];
      qy = q[3 * qi + 1];
      qz = q[3 * qi + 2];
    }
    const int n = min(*bound, n_cap);
    const int n_tiles = (n + kTile - 1) / kTile;
    if (n_tiles > 0) stage_tile(s_pts[0], pts4, 0, min(kTile, n));
    for (int t = 0; t < n_tiles; ++t) {
      const int start = t * kTile;
      if (t + 1 < n_tiles) {
        stage_tile(s_pts[(t + 1) & 1], pts4, start + kTile, min(kTile, n - start - kTile));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (active) {
        const float4* tp = s_pts[t & 1];
        const int len = min(kTile, n - start);
#pragma unroll 4
        for (int j = lane; j < len; j += kLanes) {
          const float d = sq_dist(qx, qy, qz, tp[j]);
          // ascending rows: an equal distance never displaces a lower index
          if (d < bd[K - 1]) insert<K>(bd, bi, d, start + j);
        }
      }
      __syncthreads();  // every thread is done with buffer t & 1
    }
  }

  merge_lanes<K, kLanes>(bd, bi);
  if (in_range && lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool found = bd[s] < CUDART_INF_F;
      out_d[static_cast<long long>(qi) * K + s] = found ? bd[s] : CUDART_INF_F;
      out_i[static_cast<long long>(qi) * K + s] = found ? static_cast<long long>(bi[s]) : 0LL;
    }
  }
}

template <int K>
void launch(const float* q, const unsigned char* qm, int n_q, const float4* p, const int* bound,
            int n_cap, float* od, long long* oi, cudaStream_t st) {
  search_kernel<K><<<(n_q + kQB - 1) / kQB, kThreads, 0, st>>>(q, qm, n_q, p, bound, n_cap, od,
                                                             oi);
}

}  // namespace

// pts: (n, 3) f32 rows, row r at pts + r * stride (stride >= 3 floats);
// mask: (n,) bool or null (all valid). Outputs: pts4 (n, 4) f32 with the
// mask as lane 3 (0 valid, +inf masked), bound: one int32, one past the last
// valid row (n without a mask, 0 for an empty or all-masked map). One
// launch. Returns cudaGetLastError() after it.
extern "C" int lili_knn_map(const void* pts, long long stride, const void* mask, int n,
                            void* pts4, void* bound, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = 1 + (n + kMapThreads - 1) / kMapThreads;
  map_kernel<<<grid, kMapThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), stride, static_cast<const unsigned char*>(mask), n,
      static_cast<float4*>(pts4), static_cast<int*>(bound));
  return static_cast<int>(cudaGetLastError());
}

// q: (n_q, 3) f32 contiguous; q_mask: (n_q,) bool or null (all valid); the
// map as lili_knn_map writes it: pts4 (n_cap, 4), bound (device int32, the
// walk stops at min(bound, n_cap)). k in 1..8.
// Outputs: out_d (n_q, k) f32, out_i (n_q, k) int64. Returns
// cudaGetLastError() after the launch.
extern "C" int lili_knn_f32(const void* q, const void* q_mask, int n_q, const void* pts4,
                            const void* bound, int n_cap, int k, void* out_d,
                            void* out_i, void* stream) {
  if (n_q <= 0) return 0;
  const float* qq = static_cast<const float*>(q);
  const unsigned char* qm = static_cast<const unsigned char*>(q_mask);
  const float4* pp = static_cast<const float4*>(pts4);
  const int* bd = static_cast<const int*>(bound);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 2: launch<2>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 3: launch<3>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 4: launch<4>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 5: launch<5>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 6: launch<6>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 7: launch<7>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    case 8: launch<8>(qq, qm, n_q, pp, bd, n_cap, od, oi, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
