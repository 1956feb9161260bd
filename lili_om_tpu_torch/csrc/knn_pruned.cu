// Exact k-nearest-neighbour search with Morton sorting and box-bound tile
// pruning, for Hopper (sm_90a).
//
// Replaces: lili_om_tpu/ops/knn_pallas.py:_knn_kernel_pruned (launched by
// knn_pallas_pruned). Contract: for each query, the k nearest valid map
// points, ascending squared distance, ties to the lower original map index;
// slots without a neighbour, and rows of invalid queries, hold (+inf, 0).
// The result equals the plain version's (ops/knn.py:knn) bit for bit.
//
// The wrapper (ops/knn.py:pruned_inputs) prepares everything in torch ops
// without a host sync: queries and map stably sorted on a 30-bit Morton key
// over each cloud's valid bounding box (invalid rows last), the map padded
// to whole tiles as float4 rows with the mask in lane 3 (0 valid, +inf
// masked) beside each row's original index, the (query block x map tile)
// box lower bounds lb, and each block's tiles in ascending-lb order.
//
// One block per kBlock Morton-consecutive queries, one thread per query, its
// running top-k in registers. Before each tile the block takes the largest
// k-th distance over its valid queries (warp shuffles, then shared memory)
// and stops when the tile's bound, less a margin, exceeds it: tiles come in
// ascending-bound order and the worst distance only falls, so every later
// tile would be skipped too. A tile is staged into shared memory as float4
// plus original indices and scanned by every thread.
//
// Exactness. Distances are ((dx^2+dy^2)+dz^2) with round-to-nearest
// intrinsics (no FMA contraction), on the original coordinates, as the
// plain version sums them. The top-k is ordered by (d^2, original index)
// taken together, so the visit order cannot change ties. Rounding is
// monotone, so for q in the block's box and p in the tile's box the f32
// distance is at least the f32 bound summed in the same order; skipping only
// when lb*(1-2^-11) > worst (strict, with a margin) therefore drops no point
// that could enter, not even one at exactly the worst distance with a lower
// index. What is not carried over from the TPU kernel: the lane index packed
// into the low 12 mantissa bits, and the ||q||^2+||p||^2-2q.p expansion
// around the centroid.
//
// What bounds it on this card: arithmetic, 8 f32 operations and a compare
// per visited (query, point) pair; the inputs are under 1 MB at the path's
// shapes. The design cuts the pairs: a block visits only the tiles whose
// boxes come near its own. Known weakness: one thread walks each visited
// tile serially, and the bound is one per (block, tile), so on clouds whose
// boxes overlap (a room seen from inside) most tiles survive.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 64;    // queries per block, one thread each
constexpr int kTile = 1024;   // map points per tile (20 KB of shared memory)
constexpr float kMargin = 1.0f - 0x1p-11f;

template <int K>
__global__ void __launch_bounds__(kBlock)
knn_pruned_kernel(const float* __restrict__ qs, const unsigned char* __restrict__ q_ok,
                  const long long* __restrict__ q_pos, const float4* __restrict__ pts,
                  const int* __restrict__ p_idx, const int* __restrict__ order,
                  const float* __restrict__ lb, int n_q, int n_tiles,
                  float* __restrict__ out_d, long long* __restrict__ out_i,
                  int* __restrict__ visited) {
  __shared__ float4 tile[kTile];
  __shared__ int tile_idx[kTile];
  __shared__ float warp_worst[kBlock / 32];
  const int r = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = r < n_q;
  const bool active = in_range && q_ok[r] != 0;

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = qs[3 * r + 0];
    qy = qs[3 * r + 1];
    qz = qs[3 * r + 2];
  }

  const int* ord = order + (long long)blockIdx.x * n_tiles;
  const float* bound = lb + (long long)blockIdx.x * n_tiles;
  int n_visit = 0;
  for (int t = 0; t < n_tiles; ++t) {
    // block worst: the largest k-th distance over the valid queries
    float w = active ? bd[K - 1] : -CUDART_INF_F;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, off));
    if ((threadIdx.x & 31) == 0) warp_worst[threadIdx.x >> 5] = w;
    __syncthreads();
    float worst = warp_worst[0];
#pragma unroll
    for (int i = 1; i < kBlock / 32; ++i) worst = fmaxf(worst, warp_worst[i]);
    const float b = bound[t];
    // uniform over the block: every thread read the same values. An infinite
    // bound is a tile without a valid point (or a block without a valid
    // query); the bounds ascend, so the walk ends at the first one.
    if (!(b < CUDART_INF_F) || __fmul_rn(b, kMargin) > worst) break;

    const int start = ord[t] * kTile;
    for (int j = threadIdx.x; j < kTile; j += kBlock) {
      tile[j] = pts[start + j];
      tile_idx[j] = p_idx[start + j];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < kTile; ++j) {
        const float4 p = tile[j];
        const float dx = qx - p.x;
        const float dy = qy - p.y;
        const float dz = qz - p.z;
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz)) + p.w;
        if (d <= bd[K - 1]) {
          const int idx = tile_idx[j];
          if (d < bd[K - 1] || idx < bi[K - 1]) {
            bd[K - 1] = d;
            bi[K - 1] = idx;
#pragma unroll
            for (int s = K - 1; s > 0; --s) {
              if (bd[s] < bd[s - 1] || (bd[s] == bd[s - 1] && bi[s] < bi[s - 1])) {
                const float td = bd[s];
                bd[s] = bd[s - 1];
                bd[s - 1] = td;
                const int ti = bi[s];
                bi[s] = bi[s - 1];
                bi[s - 1] = ti;
              }
            }
          }
        }
      }
    }
    ++n_visit;
    __syncthreads();
  }

  if (threadIdx.x == 0) visited[blockIdx.x] = n_visit;
  if (in_range) {
    const long long o = q_pos[r];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool found = bd[s] < CUDART_INF_F;
      out_d[o * K + s] = found ? bd[s] : CUDART_INF_F;
      out_i[o * K + s] = found ? (long long)bi[s] : 0LL;
    }
  }
}

template <int K>
void launch(const float* qs, const unsigned char* q_ok, const long long* q_pos,
            const float4* pts, const int* p_idx, const int* order, const float* lb,
            int n_q, int n_tiles, float* out_d, long long* out_i, int* visited,
            cudaStream_t stream) {
  const dim3 grid((n_q + kBlock - 1) / kBlock);
  knn_pruned_kernel<K><<<grid, kBlock, 0, stream>>>(qs, q_ok, q_pos, pts, p_idx, order,
                                                    lb, n_q, n_tiles, out_d, out_i,
                                                    visited);
}

}  // namespace

// Block and tile sizes the wrapper lays its inputs out for.
extern "C" int lili_knn_pruned_block() { return kBlock; }
extern "C" int lili_knn_pruned_tile() { return kTile; }

// qs: (n_q, 3) f32 Morton-sorted queries; q_ok: (n_q,) bool; q_pos: (n_q,)
// int64 original row of each sorted query; pts4: (n_tiles*kTile, 4) f32
// Morton-sorted map, lane 3 = 0 (valid) or +inf (masked or padding); p_idx:
// (n_tiles*kTile,) int32 original map index of each row; order: (n_blocks,
// n_tiles) int32 tiles of each query block in ascending-bound order; lb:
// (n_blocks, n_tiles) f32 the matching bounds, n_blocks = ceil(n_q/kBlock).
// Outputs: out_d (n_q, k) f32 and out_i (n_q, k) int64 in original query
// order; visited (n_blocks,) int32 tiles each block scanned. Returns
// cudaGetLastError() after the launch.
extern "C" int lili_knn_pruned_f32(const void* qs, const void* q_ok, const void* q_pos,
                                   const void* pts4, const void* p_idx, const void* order,
                                   const void* lb, int n_q, int n_tiles, int k,
                                   void* out_d, void* out_i, void* visited, void* stream) {
  if (n_q <= 0) return 0;
  const float* q = static_cast<const float*>(qs);
  const unsigned char* ok = static_cast<const unsigned char*>(q_ok);
  const long long* pos = static_cast<const long long*>(q_pos);
  const float4* p = static_cast<const float4*>(pts4);
  const int* pi = static_cast<const int*>(p_idx);
  const int* o = static_cast<const int*>(order);
  const float* b = static_cast<const float*>(lb);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  int* v = static_cast<int*>(visited);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 2: launch<2>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 3: launch<3>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 4: launch<4>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 5: launch<5>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 6: launch<6>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 7: launch<7>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    case 8: launch<8>(q, ok, pos, p, pi, o, b, n_q, n_tiles, od, oi, v, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
