// Exact k-nearest-neighbour search with Morton sorting and box-bound tile
// pruning, for Hopper (sm_90a): the map preparation and the search.
//
// Replaces: lili_om_tpu/ops/knn_pallas.py:_knn_kernel_pruned (launched by
// knn_pallas_pruned), with the sorts and bounds that knn_pallas_pruned runs
// around it. Contract: for each query, the k nearest valid map points,
// ascending squared distance, ties to the lower original map index; slots
// without a neighbour, and rows of invalid queries, hold (+inf, 0). The
// result equals the plain version's (ops/knn.py:knn) bit for bit.
//
// Three kernels:
//   * lili_knn_pruned_keys: one block reduces a cloud's valid bounding box
//     and writes each row's packed key (morton30 << 32) | row, invalid rows
//     with the key INT32_MAX. The wrapper sorts the keys with one torch.sort:
//     the row in the low bits makes every key unique, so any sort gives the
//     stable order, invalid rows last.
//   * lili_knn_pruned_scatter: one block per map tile writes the sorted map
//     as float4 rows (mask in lane 3: 0 valid, +inf masked or padding) beside
//     each row's original index, and the tile's valid box and flag. Keys,
//     sort and scatter make the prepared map (ops/knn.py:PrunedMap), built
//     once per map: ICP searches one target 101 times.
//   * lili_knn_pruned_f32: the search. One block per kQB queries in the order
//     q_order gives (Morton order of the queries; ICP computes it once in
//     the source's own frame, as a rigid motion keeps Morton neighbours
//     close). The block reads its queries through q_order, reduces its valid
//     queries' box, takes the lower bound lb against every tile box as
//     ((gx^2+gy^2)+gz^2), orders its tiles by (lb, tile id) with a rank sort
//     in shared memory (stable, the plain schedule's argsort), and walks them
//     nearest-first. It stops at the first tile whose lb*(1-2^-11) exceeds
//     the block's worst k-th distance (the bounds ascend and the worst only
//     falls), so a block never reads a (blocks x tiles) matrix.
//
// What bounds it on this card: operations, 8 f32 operations per scanned
// (query, point) pair; the inputs are a few hundred KB. The old kernel ran
// one thread per query over whole 1024-point tiles, 64 queries a block: at
// ICP 256 blocks of two warps on 132 SMs, its time set by the block whose
// Morton range jumps and whose wide box scans the most tiles. Now each query
// has kLanes threads, each scanning every kLanes-th point of a 512-point
// tile staged by cp.async into a double buffer (the next tile of the order
// is copied while the current one is scanned, and the copy is dropped if the
// walk stops). After a tile the kLanes partial top-k lists of a query are
// merged by (d^2, index) with warp shuffles, taking each element once, so
// every lane holds the exact top-k again: the worst distance is the merged
// one, and the walk visits exactly the tiles of the plain schedule
// (ops/knn.py:knn_pruned_schedule), whose visit count per block it writes.
// 32-query blocks give tighter boxes than 64-query ones, and twice the
// blocks of the old kernel, each of eight warps. Known weakness: the launch
// still lasts as long as its longest walk (at ICP a block scans 5 tiles on
// average and 14 at most, of 32).
//
// Exactness. Distances are ((dx^2+dy^2)+dz^2) with round-to-nearest
// intrinsics (no FMA contraction), on the original coordinates, as the
// plain version sums them. The top-k is ordered by (d^2, original index)
// taken together, so neither the visit order nor the lane split can change
// ties, and the merge is order-independent. Rounding is monotone, so for q
// in the block's box and p in the tile's box the f32 distance is at least
// the f32 bound summed in the same order; skipping only when
// lb*(1-2^-11) > worst (strict, with a margin) therefore drops no point that
// could enter, not even one at exactly the worst distance with a lower
// index. What is not carried over from the TPU kernel: the lane index packed
// into the low 12 mantissa bits, and the ||q||^2+||p||^2-2q.p expansion
// around the centroid.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "knn_common.cuh"

namespace {

using namespace lili_knn;

constexpr int kQB = 32;                 // queries per block
constexpr int kLanes = 8;               // threads per query
constexpr int kThreads = kQB * kLanes;  // 256
constexpr int kTile = 512;              // map points per tile
constexpr int kMaxTiles = 2048;         // 12 B of shared memory per tile
constexpr int kKeyThreads = 1024;
constexpr float kMargin = 1.0f - 0x1p-11f;
constexpr long long kInvalidKey = 0x7fffffffLL;

__device__ __forceinline__ unsigned spread10(unsigned x) {
  x &= 0x3FFu;
  x = (x | (x << 16)) & 0x30000FFu;
  x = (x | (x << 8)) & 0x300F00Fu;
  x = (x | (x << 4)) & 0x30C30C3u;
  return (x | (x << 2)) & 0x9249249u;
}

// lo/hi over a block of threads: warp shuffles, then one shared slot a warp
template <int NT>
__device__ __forceinline__ void block_box(float (&lo)[3], float (&hi)[3],
                                          float (*s_box)[6]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(kFull, lo[a], off));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(kFull, hi[a], off));
    }
  }
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_box[threadIdx.x >> 5][a] = lo[a];
      s_box[threadIdx.x >> 5][3 + a] = hi[a];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    lo[a] = s_box[0][a];
    hi[a] = s_box[0][3 + a];
  }
  for (int w = 1; w < NT / 32; ++w) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = fminf(lo[a], s_box[w][a]);
      hi[a] = fmaxf(hi[a], s_box[w][3 + a]);
    }
  }
}

// ---- keys: valid box, then (morton30 << 32) | row -----------------------
__global__ void __launch_bounds__(kKeyThreads)
keys_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int n,
            long long* __restrict__ keys) {
  __shared__ float s_box[kKeyThreads / 32][6];
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  for (int r = threadIdx.x; r < n; r += kKeyThreads) {
    if (valid == nullptr || valid[r]) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = pts[3 * r + a];
        lo[a] = fminf(lo[a], v);
        hi[a] = fmaxf(hi[a], v);
      }
    }
  }
  block_box<kKeyThreads>(lo, hi, s_box);
  // 1023 / max(hi - lo, 1e-6), correctly rounded, as ops/knn.py:morton30
  float scale[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) scale[a] = __fdiv_rn(1023.0f, fmaxf(__fsub_rn(hi[a], lo[a]), 1e-6f));
  for (int r = threadIdx.x; r < n; r += kKeyThreads) {
    long long key = kInvalidKey;
    if (valid == nullptr || valid[r]) {
      unsigned c[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float v = __fmul_rn(__fsub_rn(pts[3 * r + a], lo[a]), scale[a]);
        c[a] = static_cast<unsigned>(static_cast<int>(fminf(fmaxf(v, 0.0f), 1023.0f)));
      }
      key = static_cast<long long>((spread10(c[0]) << 2) | (spread10(c[1]) << 1) |
                                   spread10(c[2]));
    }
    keys[r] = (key << 32) | static_cast<long long>(r);
  }
}

// ---- scatter: the sorted map as float4 tiles, with the tile boxes --------
__global__ void __launch_bounds__(kTile)
scatter_kernel(const float* __restrict__ pts, const long long* __restrict__ sorted, int n,
               float4* __restrict__ pts4, int* __restrict__ p_idx, float* __restrict__ tile_lo,
               float* __restrict__ tile_hi, unsigned char* __restrict__ tile_any) {
  __shared__ float s_box[kTile / 32][6];
  const int r = blockIdx.x * kTile + threadIdx.x;
  float4 p = make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
  int row = 0;
  bool ok = false;
  if (r < n) {
    const long long key = sorted[r];
    row = static_cast<int>(key & 0xffffffffLL);
    ok = (key >> 32) != kInvalidKey;
    p = make_float4(pts[3 * row], pts[3 * row + 1], pts[3 * row + 2],
                    ok ? 0.f : CUDART_INF_F);
  }
  pts4[r] = p;
  p_idx[r] = row;
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  if (ok) {
    lo[0] = hi[0] = p.x;
    lo[1] = hi[1] = p.y;
    lo[2] = hi[2] = p.z;
  }
  block_box<kTile>(lo, hi, s_box);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      tile_lo[3 * blockIdx.x + a] = lo[a];
      tile_hi[3 * blockIdx.x + a] = hi[a];
    }
    tile_any[blockIdx.x] = lo[0] <= hi[0];
  }
}

// ---- search --------------------------------------------------------------
// whether the walk scans its t-th tile: one with a valid point whose bound,
// less the margin, does not exceed the block's worst distance
__device__ __forceinline__ bool walk_scans(const float* lb_walk, int t, int n_tiles,
                                          float worst) {
  if (t >= n_tiles) return false;
  const float b = lb_walk[t];
  return b < CUDART_INF_F && !(__fmul_rn(b, kMargin) > worst);
}

// one tile (float4 rows and indices) into shared memory by cp.async; every
// thread commits one group, copies or not
__device__ __forceinline__ void stage_tile(float4* s_pts, int* s_idx, const float4* pts4,
                                           const int* p_idx, long long start) {
  for (int j = threadIdx.x; j < kTile; j += kThreads) cp_async16(&s_pts[j], pts4 + start + j);
  for (int j = threadIdx.x; j < kTile / 4; j += kThreads)
    cp_async16(&s_idx[4 * j], p_idx + start + 4 * j);
  cp_async_commit();
}

template <int K>
__global__ void __launch_bounds__(kThreads)
search_kernel(const float* __restrict__ queries, const unsigned char* __restrict__ q_mask,
              const long long* __restrict__ q_order, int n_q, const float4* __restrict__ pts4,
              const int* __restrict__ p_idx, const float* __restrict__ tile_lo,
              const float* __restrict__ tile_hi, const unsigned char* __restrict__ tile_any,
              int n_tiles, float* __restrict__ out_d, long long* __restrict__ out_i,
              int* __restrict__ visited) {
  __shared__ __align__(16) float4 s_pts[2][kTile];
  __shared__ __align__(16) int s_idx[2][kTile];
  __shared__ float s_box[kThreads / 32][6];
  __shared__ float s_worst[kThreads / 32];
  extern __shared__ float s_dyn[];  // lb by tile id, lb in walk order, walk order
  float* lb_raw = s_dyn;
  float* lb_walk = s_dyn + n_tiles;
  int* walk = reinterpret_cast<int*>(s_dyn + 2 * n_tiles);

  const int lane = threadIdx.x % kLanes;
  const int r = blockIdx.x * kQB + threadIdx.x / kLanes;
  const bool in_range = r < n_q;
  int o = 0;
  bool active = false;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (in_range) {
    o = static_cast<int>(q_order[r] & 0xffffffffLL);
    active = q_mask == nullptr || q_mask[o] != 0;
    if (active) {
      qx = queries[3 * o];
      qy = queries[3 * o + 1];
      qz = queries[3 * o + 2];
    }
  }
  float lo[3] = {CUDART_INF_F, CUDART_INF_F, CUDART_INF_F};
  float hi[3] = {-CUDART_INF_F, -CUDART_INF_F, -CUDART_INF_F};
  if (active) {
    lo[0] = hi[0] = qx;
    lo[1] = hi[1] = qy;
    lo[2] = hi[2] = qz;
  }
  block_box<kThreads>(lo, hi, s_box);
  const bool q_any = lo[0] <= hi[0];

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }
  int n_visit = 0;
  if (q_any) {  // uniform over the block
    for (int j = threadIdx.x; j < n_tiles; j += kThreads) {
      float b = CUDART_INF_F;
      if (tile_any[j]) {
        float g[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          g[a] = fmaxf(fmaxf(__fsub_rn(lo[a], tile_hi[3 * j + a]),
                             __fsub_rn(tile_lo[3 * j + a], hi[a])), 0.0f);
        b = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1])),
                      __fmul_rn(g[2], g[2]));
      }
      lb_raw[j] = b;
    }
    __syncthreads();
    // rank sort by (lb, tile id): stable, the plain schedule's argsort
    for (int j = threadIdx.x; j < n_tiles; j += kThreads) {
      const float v = lb_raw[j];
      int rank = 0;
      for (int i = 0; i < n_tiles; ++i) rank += before(lb_raw[i], i, v, j);
      lb_walk[rank] = v;
      walk[rank] = j;
    }
    __syncthreads();

    // walk: tile t + 1 of the order is copied while tile t is scanned
    float worst = CUDART_INF_F;
    if (walk_scans(lb_walk, 0, n_tiles, worst))
      stage_tile(s_pts[0], s_idx[0], pts4, p_idx, static_cast<long long>(walk[0]) * kTile);
    for (int t = 0; walk_scans(lb_walk, t, n_tiles, worst); ++t) {
      const bool next = walk_scans(lb_walk, t + 1, n_tiles, worst);
      if (next) {
        stage_tile(s_pts[(t + 1) & 1], s_idx[(t + 1) & 1], pts4, p_idx,
                   static_cast<long long>(walk[t + 1]) * kTile);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      bool changed = false;
      if (active) {
        const float4* tp = s_pts[t & 1];
        const int* ti = s_idx[t & 1];
#pragma unroll 4
        for (int j = lane; j < kTile; j += kLanes) {
          const float d = sq_dist(qx, qy, qz, tp[j]);
          if (d <= bd[K - 1]) {
            const int idx = ti[j];
            if (d < bd[K - 1] || idx < bi[K - 1]) {
              insert<K>(bd, bi, d, idx);
              changed = true;
            }
          }
        }
      }
      if (__any_sync(kFull, changed)) merge_lanes<K, kLanes>(bd, bi);
      ++n_visit;
      // the block's worst: the largest merged k-th distance of a valid query
      float w = active ? bd[K - 1] : -CUDART_INF_F;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) w = fmaxf(w, __shfl_xor_sync(kFull, w, off));
      if ((threadIdx.x & 31) == 0) s_worst[threadIdx.x >> 5] = w;
      __syncthreads();  // also: every thread is done with buffer t & 1
      worst = s_worst[0];
#pragma unroll
      for (int i = 1; i < kThreads / 32; ++i) worst = fmaxf(worst, s_worst[i]);
    }
    cp_async_wait<0>();  // a prefetched tile the walk did not reach
  }

  if (threadIdx.x == 0) visited[blockIdx.x] = n_visit;
  if (in_range && lane == 0) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool found = active && bd[s] < CUDART_INF_F;
      out_d[static_cast<long long>(o) * K + s] = found ? bd[s] : CUDART_INF_F;
      out_i[static_cast<long long>(o) * K + s] = found ? static_cast<long long>(bi[s]) : 0LL;
    }
  }
}

template <int K>
void launch(const float* q, const unsigned char* qm, const long long* order, int n_q,
            const float4* p, const int* pi, const float* tlo, const float* thi,
            const unsigned char* tany, int n_tiles, float* od, long long* oi, int* v,
            cudaStream_t st) {
  const dim3 grid((n_q + kQB - 1) / kQB);
  const size_t dyn = static_cast<size_t>(n_tiles) * 12;
  search_kernel<K><<<grid, kThreads, dyn, st>>>(q, qm, order, n_q, p, pi, tlo, thi, tany,
                                                n_tiles, od, oi, v);
}

}  // namespace

// Sizes the wrapper lays its inputs out for.
extern "C" int lili_knn_pruned_block() { return kQB; }
extern "C" int lili_knn_pruned_tile() { return kTile; }
extern "C" int lili_knn_pruned_max_tiles() { return kMaxTiles; }

// pts: (n, 3) f32; valid: (n,) bool or null (all valid); keys: (n,) int64
// out, (morton30 << 32) | row, or (INT32_MAX << 32) | row for an invalid
// row. n < 2^31. Returns cudaGetLastError() after the launch.
extern "C" int lili_knn_pruned_keys(const void* pts, const void* valid, int n, void* keys,
                                    void* stream) {
  if (n <= 0) return 0;
  keys_kernel<<<1, kKeyThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const unsigned char*>(valid), n,
      static_cast<long long*>(keys));
  return static_cast<int>(cudaGetLastError());
}

// pts: (n, 3) f32 in original order; sorted: (n,) the sorted keys of
// lili_knn_pruned_keys. Outputs over n_tiles = ceil(n / kTile) tiles:
// pts4 (n_tiles*kTile, 4) f32, p_idx (n_tiles*kTile,) int32, tile_lo and
// tile_hi (n_tiles, 3) f32 (+inf / -inf for a tile without a valid point),
// tile_any (n_tiles,) bool.
extern "C" int lili_knn_pruned_scatter(const void* pts, const void* sorted, int n, int n_tiles,
                                       void* pts4, void* p_idx, void* tile_lo, void* tile_hi,
                                       void* tile_any, void* stream) {
  if (n_tiles <= 0) return 0;
  scatter_kernel<<<n_tiles, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const long long*>(sorted), n,
      static_cast<float4*>(pts4), static_cast<int*>(p_idx), static_cast<float*>(tile_lo),
      static_cast<float*>(tile_hi), static_cast<unsigned char*>(tile_any));
  return static_cast<int>(cudaGetLastError());
}

// queries: (n_q, 3) f32 in original order; q_mask: (n_q,) bool or null;
// q_order: (n_q,) int64, the original row of the r-th query of the walk in
// its low 32 bits (a permutation, or the sorted keys themselves); the map
// as lili_knn_pruned_scatter writes it, n_tiles <= kMaxTiles. Outputs:
// out_d (n_q, k) f32 and out_i (n_q, k) int64 in original query order;
// visited (ceil(n_q / kQB),) int32, the tiles each block scanned.
extern "C" int lili_knn_pruned_f32(const void* queries, const void* q_mask, const void* q_order,
                                   int n_q, const void* pts4, const void* p_idx,
                                   const void* tile_lo, const void* tile_hi,
                                   const void* tile_any, int n_tiles, int k, void* out_d,
                                   void* out_i, void* visited, void* stream) {
  if (n_q <= 0) return 0;
  if (n_tiles < 0 || n_tiles > kMaxTiles) return static_cast<int>(cudaErrorInvalidValue);
  const float* q = static_cast<const float*>(queries);
  const unsigned char* qm = static_cast<const unsigned char*>(q_mask);
  const long long* ord = static_cast<const long long*>(q_order);
  const float4* p = static_cast<const float4*>(pts4);
  const int* pi = static_cast<const int*>(p_idx);
  const float* tlo = static_cast<const float*>(tile_lo);
  const float* thi = static_cast<const float*>(tile_hi);
  const unsigned char* ta = static_cast<const unsigned char*>(tile_any);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  int* v = static_cast<int*>(visited);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 2: launch<2>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 3: launch<3>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 4: launch<4>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 5: launch<5>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 6: launch<6>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 7: launch<7>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    case 8: launch<8>(q, qm, ord, n_q, p, pi, tlo, thi, ta, n_tiles, od, oi, v, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
