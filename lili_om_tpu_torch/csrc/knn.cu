// Exact k-nearest-neighbour search over a masked map, for Hopper (sm_90a).
//
// Replaces: lili_om_tpu/ops/knn_pallas.py:_knn_kernel_counted (launched by
// knn_pallas_counted), and _knn_kernel (knn_pallas) through the same entry:
// the dense kernel is this one with the map bound at capacity and every
// query active. Contract of both: for each query, the k nearest valid map
// points, ascending squared distance; slots without a neighbour, and rows of
// invalid queries, hold (+inf, 0).
//
// What is not carried over from the TPU kernel: it packed the tile-local
// lane index into the low 12 mantissa bits of each distance (a VPU trick
// that truncates distances to 2^-12) and used the ||q||^2+||p||^2-2q.p
// matmul expansion, which needed the map re-centred on its centroid. Here
// each thread computes (q-p)^2 directly in f32 and keeps exact distances
// and exact indices, so re-centring changes nothing and is dropped. The sum
// is taken in the plain version's order without FMA contraction, so the
// kernel's distances and indices equal the plain version's bit for bit.
//
// What bounds it on this card: arithmetic. Each (query, point) pair costs
// 8 f32 operations (3 sub, 3 mul, 2 add; the map mask rides as the 4th
// float4 lane, 0 or +inf, added to the sum) and a compare; the inputs are
// under 1 MB at the main-path shapes (4096x32768, 6144x32768, 3072x8192),
// so the kernel is compute-bound (1.07 GFLOP at 4096x32768 full capacity is
// 16 us at 67 TFLOP/s f32).
//
// What the design does about it: work scales with the valid data, not the
// capacity. The map walk stops at the last valid row (n_pts, a device
// scalar computed by the wrapper, so there is no host sync; tables are
// valid-first), and a block whose queries are all invalid skips the walk.
// One thread owns one query and keeps its running top-k in registers by
// insertion; map tiles of kTile points are staged through shared memory as
// float4 and read by all threads of the block at once (a broadcast, no bank
// conflicts). Scanning indices in ascending order with strict compares makes
// the lower index win ties. Known weakness: 4096 queries at kBlock=64 are 64
// blocks for 132 SMs, two warps each; splitting the map across blocks and
// merging, or TMA-fed tiles, is later work.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBlock = 64;    // queries per block, one thread each
constexpr int kTile = 2048;   // map points per shared-memory tile (32 KB)

template <int K>
__global__ void __launch_bounds__(kBlock)
knn_kernel(const float* __restrict__ q, const float4* __restrict__ pts,
           const unsigned char* __restrict__ q_mask,
           const int* __restrict__ n_pts_dev, int n_pts_cap, int n_q,
           float* __restrict__ out_d, long long* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const int qi = blockIdx.x * kBlock + threadIdx.x;
  const bool in_range = qi < n_q;
  const bool active = in_range && (q_mask == nullptr || q_mask[qi] != 0);

  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = CUDART_INF_F;
    bi[s] = 0;
  }

  // a block with no valid query skips the map walk (uniform branch)
  if (__syncthreads_or(active)) {
    float qx = 0.f, qy = 0.f, qz = 0.f;
    if (active) {
      qx = q[3 * qi + 0];
      qy = q[3 * qi + 1];
      qz = q[3 * qi + 2];
    }
    int n = n_pts_cap;
    if (n_pts_dev != nullptr) n = min(*n_pts_dev, n_pts_cap);
    for (int start = 0; start < n; start += kTile) {
      const int len = min(kTile, n - start);
      for (int j = threadIdx.x; j < len; j += kBlock) tile[j] = pts[start + j];
      __syncthreads();
      if (active) {
        for (int j = 0; j < len; ++j) {
          const float4 p = tile[j];
          const float dx = qx - p.x;
          const float dy = qy - p.y;
          const float dz = qz - p.z;
          // explicit round-to-nearest ops: no FMA contraction, so d² is
          // bit-identical to the plain version's ((dx²+dy²)+dz²)
          const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz)) + p.w;
          if (d < bd[K - 1]) {
            bd[K - 1] = d;
            bi[K - 1] = start + j;
#pragma unroll
            for (int s = K - 1; s > 0; --s) {
              if (bd[s] < bd[s - 1]) {
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
      __syncthreads();
    }
  }

  if (in_range) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      const bool found = bd[s] < CUDART_INF_F;
      out_d[(long long)qi * K + s] = found ? bd[s] : CUDART_INF_F;
      out_i[(long long)qi * K + s] = found ? (long long)bi[s] : 0LL;
    }
  }
}

template <int K>
void launch(const float* q, const float4* pts, const unsigned char* q_mask,
            const int* n_pts_dev, int n_pts_cap, int n_q, float* out_d,
            long long* out_i, cudaStream_t stream) {
  const dim3 grid((n_q + kBlock - 1) / kBlock);
  knn_kernel<K><<<grid, kBlock, 0, stream>>>(q, pts, q_mask, n_pts_dev,
                                             n_pts_cap, n_q, out_d, out_i);
}

}  // namespace

// q: (n_q, 3) f32; pts4: (n_pts_cap, 4) f32 with the mask as lane 3 (0 for a
// valid point, +inf for a masked one); q_mask: (n_q,) bool or null (all
// valid); n_pts_dev: device int32 scalar bounding the map walk, or null
// (walk the whole capacity). Outputs: out_d (n_q, k) f32, out_i (n_q, k)
// int64. Returns cudaGetLastError() after the launch.
extern "C" int lili_knn_f32(const void* q, const void* pts4, const void* q_mask,
                            const void* n_pts_dev, int n_pts_cap, int n_q, int k,
                            void* out_d, void* out_i, void* stream) {
  if (n_q <= 0) return 0;
  const float* qq = static_cast<const float*>(q);
  const float4* pp = static_cast<const float4*>(pts4);
  const unsigned char* qm = static_cast<const unsigned char*>(q_mask);
  const int* np = static_cast<const int*>(n_pts_dev);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch<1>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 2: launch<2>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 3: launch<3>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 4: launch<4>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 5: launch<5>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 6: launch<6>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 7: launch<7>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    case 8: launch<8>(qq, pp, qm, np, n_pts_cap, n_q, od, oi, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
