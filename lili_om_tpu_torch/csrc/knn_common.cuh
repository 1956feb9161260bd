// Pieces shared by the exact kNN kernels (knn.cu: B1/B2, knn_pruned.cu: B3):
// the cp.async staging helpers, the (d^2, index) order, the distance summed
// as the plain version sums it, the running top-k insertion and the exact
// merge of the lanes that share a query.
#pragma once
#include <cuda_runtime.h>
#include <math_constants.h>

namespace lili_knn {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// (d, i) < (e, j) in the (d^2, index) order
__device__ __forceinline__ bool before(float d, int i, float e, int j) {
  return d < e || (d == e && i < j);
}

// ((dx^2+dy^2)+dz^2) + p.w with round-to-nearest intrinsics (no FMA
// contraction), the plain version's order; p.w is the mask lane (0 valid,
// +inf masked)
__device__ __forceinline__ float sq_dist(float qx, float qy, float qz, float4 p) {
  const float dx = __fsub_rn(qx, p.x);
  const float dy = __fsub_rn(qy, p.y);
  const float dz = __fsub_rn(qz, p.z);
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz)),
                   p.w);
}

// (d, idx) into the sorted list bd/bi in place of its last element
template <int K>
__device__ __forceinline__ void insert(float (&bd)[K], int (&bi)[K], float d, int idx) {
  bd[K - 1] = d;
  bi[K - 1] = idx;
#pragma unroll
  for (int s = K - 1; s > 0; --s) {
    if (before(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
      const float td = bd[s];
      bd[s] = bd[s - 1];
      bd[s - 1] = td;
      const int ti = bi[s];
      bi[s] = bi[s - 1];
      bi[s - 1] = ti;
    }
  }
}

// The L sorted lists of one query (L consecutive threads of a warp, L a
// power of two up to 32) merged into their top-K, left in every lane. Each
// round takes the smallest head in the (d^2, index) order; every lane whose
// head is that element (the same point, held by several lanes) drops it, so
// each element is taken once. Every thread of the warp must call it.
template <int K, int L>
__device__ __forceinline__ void merge_lanes(float (&bd)[K], int (&bi)[K]) {
  float md[K];
  int mi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    float cd = bd[0];
    int ci = bi[0];
#pragma unroll
    for (int off = L / 2; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(kFull, cd, off);
      const int oi = __shfl_xor_sync(kFull, ci, off);
      if (before(od, oi, cd, ci)) {
        cd = od;
        ci = oi;
      }
    }
    md[s] = cd;
    mi[s] = ci;
    if (bd[0] == cd && bi[0] == ci) {
#pragma unroll
      for (int j = 0; j < K - 1; ++j) {
        bd[j] = bd[j + 1];
        bi[j] = bi[j + 1];
      }
      bd[K - 1] = CUDART_INF_F;
      bi[K - 1] = 0;
    }
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = md[s];
    bi[s] = mi[s];
  }
}

}  // namespace lili_knn
