// Block-tridiagonal factor and resolve of the pose graph's chain, for Hopper
// (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package compiles its block-Thomas
// scans, lili_om_tpu/models/pose_graph.py:block_tridiag_factor (:339) and
// block_tridiag_resolve (:358), with their unrolled 6x6 Cholesky _chol6 and
// solves _tri_lower6 / _tri_upper6 / _cho_solve6 (:293-337), into one
// on-device loop each. Driven from the host as PyTorch ops, the same loops
// cost ~60 launches a node (ops/blocktri.py's plain versions): at the
// 4096-node graph of a long run, hundreds of thousands of launches a
// Gauss-Newton iteration. Here each walk is one launch.
//
// Contract (ops/blocktri.py): factor: D, B (n,6,6) in, Lcs, Cs (n,6,6) out,
// S_i = D_i - B_{i-1}^T C_{i-1}, L_i = chol6(S_i) (zeros above the
// diagonal), C_i = S_i^{-1} B_i (B_{-1} = C_{-1} = 0; B[n-1] only feeds
// C[n-1]). Resolve: Lcs, Cs, B_prev (n,6,6) and rhs (n,6,R) in, X (n,6,R)
// out, z_i = cho_solve6(L_i, r_i - B_prev_i^T z_{i-1}) forward, x_i = z_i -
// C_i x_{i+1} backward (x_n = 0), in place in X. Row-major, contiguous.
//
// Arithmetic: _chol6's and the solves' operations in their order, every
// subtraction in ascending k, each product and difference rounded on its
// own (__fmul_rn / __fsub_rn and their double forms: no FMA contraction),
// the pivot sqrt(max(s, 1e-30)) with a NaN kept a NaN, as jnp.maximum and
// torch.clamp keep it. The 6-term products B^T C, B^T z and C x are FMA
// chains in ascending k, where the plain version's matmul sums in its own
// order: the kernel and the plain version differ by those roundings.
//
// What bounds it on this card: the chain. Step i needs step i-1's C (or z,
// or x): n dependent steps, each a 6x6 Cholesky (6 pivots, each a square
// root and a division after the last update), 12 dependent divisions per
// right-hand column and ~70 dependent multiply-subtracts. The bytes are
// few: the factor moves 4*36*n*s bytes (D, B read; Lcs, Cs written), the
// resolve 3*36*n*s + 2*6*n*R*s (s the element size): 77 MB at the largest
// shape chip_smoke.py checks (n 4096, R 384, float32), 0.023 ms at
// 3.35 TB/s, where the chain takes milliseconds.
//
// What the design does about it: a step waits only on its own arithmetic.
// The factor runs in one warp: 21 lanes hold the 21 lower entries of S_i
// in registers (each computes its entry of D_i - B_{i-1}^T C_{i-1}), the
// Cholesky runs across them with shuffles, then 6 lanes solve for C_i's 6
// columns. The resolve gives each right-hand column a thread (kCols a
// block, ceil(R / kCols) blocks); the columns are independent. Each step's
// 6x6 blocks, shared by all lanes or threads, are staged in shared memory
// by cp.async one step ahead (a ring of buffers), and each column's rhs
// rows (and, walking back, its z rows) are loaded one step ahead into
// registers, so no step waits on device memory; and no division waits on
// the slow path of a zero dividend (div_pivot). optimize_graph_chain
// resolves y0 (R = 1) and U (R = 6L) in two launches, as the JAX package
// does; the kernel would give the same values for them in one.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // resolve: right-hand columns (threads) a block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// a / b for a pivot b (positive, or NaN). A zero dividend is returned as it
// is, which is the quotient's value (0 / b keeps a's sign for b > 0), and 1
// is divided in its place: a zero dividend sends the IEEE division to its
// slow path. The chain feeds zeros at every step of a graph's padding nodes
// (past its last keyframe), of U's columns before their first endpoint and
// of a block's idle threads. A select, not a branch: a branch cost the
// dense factor step ~15 %, the select ~5 % (tools/blocktri_walks.py).
template <typename T>
__device__ __forceinline__ T div_pivot(T a, T b) {
  const bool zero = a == T(0) && b > T(0);
  const T q = div_rn(zero ? T(1) : a, b);
  return zero ? a : q;
}

// sqrt(max(s, 1e-30)); a NaN stays a NaN
template <typename T>
__device__ __forceinline__ T pivot(T s) {
  const T floor_ = static_cast<T>(1e-30);
  return sqrt_rn(s < floor_ ? floor_ : s);
}

// one element global -> shared, asynchronously (4 or 8 bytes)
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// every group but the most recent one has landed
__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// y <- L^{-T} L^{-1} y for one column, L row-major 6x6 in shared memory:
// _tri_lower6 then _tri_upper6, subtractions in ascending k
template <typename T>
__device__ __forceinline__ void cho_solve6(const T* __restrict__ L, T (&y)[6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    T s = y[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = sub_rn(s, mul_rn(L[i * 6 + k], y[k]));
    y[i] = div_pivot(s, L[i * 6 + i]);
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    T s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = sub_rn(s, mul_rn(L[k * 6 + i], y[k]));
    y[i] = div_pivot(s, L[i * 6 + i]);
  }
}

// lane l < 21 of the factor's warp holds lower entry (row, col) of S_i, in
// row-major order of the lower triangle; the other lanes hold (0, 0)
__device__ __forceinline__ int tri_row(int l) {
  return l < 1 ? 0 : l < 3 ? 1 : l < 6 ? 2 : l < 10 ? 3 : l < 15 ? 4 : l < 21 ? 5 : 0;
}
__device__ __forceinline__ int tri_lane(int r, int c) { return r * (r + 1) / 2 + c; }

template <typename T>
__global__ void __launch_bounds__(32)
factor_kernel(const T* __restrict__ D, const T* __restrict__ B, T* __restrict__ Lcs,
              T* __restrict__ Cs, long long n) {
  __shared__ __align__(16) T sD[2][36];  // D_i by i % 2
  __shared__ __align__(16) T sB[3][36];  // B_i by i % 3: B_{i-1} stays while B_{i+1} lands
  __shared__ T sC[36];                   // C_{i-1}, then C_i
  __shared__ T sL[36];                   // L_i, zeros above the diagonal
  const int lane = threadIdx.x;
  const bool holds = lane < 21;
  const int r = tri_row(lane);
  const int c = holds ? lane - tri_lane(r, 0) : 0;
  for (int e = lane; e < 36; e += 32) {
    sC[e] = T(0);
    sL[e] = T(0);
    sB[2][e] = T(0);  // B_{-1}
  }
  for (int e = lane; e < 72; e += 32) {
    if (e < 36) cp_async(&sD[0][e], D + e);
    else cp_async(&sB[0][e - 36], B + (e - 36));
  }
  cp_async_commit();
  for (long long i = 0; i < n; ++i) {
    const int cur3 = static_cast<int>(i % 3);
    const int prev3 = (cur3 + 2) % 3;
    if (i + 1 < n) {
      const T* d = D + (i + 1) * 36;
      const T* b = B + (i + 1) * 36;
      for (int e = lane; e < 72; e += 32) {
        if (e < 36) cp_async(&sD[(i + 1) & 1][e], d + e);
        else cp_async(&sB[(cur3 + 1) % 3][e - 36], b + (e - 36));
      }
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncwarp();
    // S_i[r][c] = D_i[r][c] - sum_k B_{i-1}[k][r] C_{i-1}[k][c]
    const T* Bp = sB[prev3];
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 6; ++k) acc = fma_rn(Bp[k * 6 + r], sC[k * 6 + c], acc);
    T s = sub_rn(sD[i & 1][r * 6 + c], acc);
    // _chol6 across the lanes: column j's pivot, its column, then the
    // trailing entries' update with L[r][j] * L[c][j]
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const T d = pivot(__shfl_sync(kFull, s, tri_lane(j, j)));
      if (holds && c == j) s = r == j ? d : div_pivot(s, d);
      const T a = __shfl_sync(kFull, s, tri_lane(r >= j ? r : j, j));
      const T b = __shfl_sync(kFull, s, tri_lane(c >= j ? c : j, j));
      if (holds && c > j) s = sub_rn(s, mul_rn(a, b));
    }
    if (holds) sL[r * 6 + c] = s;
    __syncwarp();  // L_i in place; every lane is done reading C_{i-1}
    T* Lout = Lcs + i * 36;
    for (int e = lane; e < 36; e += 32) Lout[e] = sL[e];
    if (lane < 6) {
      const T* Bi = sB[cur3];
      T y[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) y[q] = Bi[q * 6 + lane];
      cho_solve6(sL, y);
      T* Cout = Cs + i * 36;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        sC[q * 6 + lane] = y[q];
        Cout[q * 6 + lane] = y[q];
      }
    }
    __syncwarp();  // C_i in place; step i's buffers free for step i + 2's loads
  }
}

template <typename T>
__global__ void __launch_bounds__(kCols)
resolve_kernel(const T* __restrict__ Lcs, const T* __restrict__ Cs,
               const T* __restrict__ Bprev, const T* __restrict__ rhs, T* __restrict__ X,
               long long n, long long R) {
  __shared__ __align__(16) T sL[2][36];
  __shared__ __align__(16) T sM[2][36];  // B_prev_i walking forward, C_i walking back
  const int t = threadIdx.x;
  const long long col = static_cast<long long>(blockIdx.x) * kCols + t;
  const bool mine = col < R;
  const long long stride = 6 * R;  // one node's rows of rhs and X
  // forward: z_i = cho_solve6(L_i, r_i - B_prev_i^T z_{i-1})
  if (t < 72) {
    if (t < 36) cp_async(&sL[0][t], Lcs + t);
    else cp_async(&sM[0][t - 36], Bprev + (t - 36));
  }
  cp_async_commit();
  T z[6], rn[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    z[q] = T(0);
    rn[q] = mine ? rhs[q * R + col] : T(0);
  }
  for (long long i = 0; i < n; ++i) {
    const int cur = static_cast<int>(i & 1);
    if (i + 1 < n && t < 72) {
      if (t < 36) cp_async(&sL[cur ^ 1][t], Lcs + (i + 1) * 36 + t);
      else cp_async(&sM[cur ^ 1][t - 36], Bprev + (i + 1) * 36 + (t - 36));
    }
    cp_async_commit();
    T y[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) y[q] = rn[q];
    if (mine && i + 1 < n) {
      const T* rr = rhs + (i + 1) * stride + col;
#pragma unroll
      for (int q = 0; q < 6; ++q) rn[q] = rr[q * R];
    }
    cp_async_wait_prev();
    __syncthreads();
    const T* Bp = sM[cur];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) acc = fma_rn(Bp[k * 6 + q], z[k], acc);
      y[q] = sub_rn(y[q], acc);
    }
    cho_solve6(sL[cur], y);
    if (mine) {
      T* xo = X + i * stride + col;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        z[q] = y[q];
        xo[q * R] = y[q];
      }
    }
    __syncthreads();  // step i's buffers free for step i + 2's loads
  }
  if (n <= 0) return;
  // backward: x_i = z_i - C_i x_{i+1}, x_n = 0, in place in X
  if (t < 36) cp_async(&sM[0][t], Cs + (n - 1) * 36 + t);
  cp_async_commit();
  T x[6], zn[6];
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    x[q] = T(0);
    zn[q] = mine ? X[(n - 1) * stride + q * R + col] : T(0);
  }
  for (long long i = n - 1, s = 0; i >= 0; --i, ++s) {
    const int cur = static_cast<int>(s & 1);
    if (i > 0 && t < 36) cp_async(&sM[cur ^ 1][t], Cs + (i - 1) * 36 + t);
    cp_async_commit();
    T zi[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) zi[q] = zn[q];
    if (mine && i > 0) {
      const T* zz = X + (i - 1) * stride + col;
#pragma unroll
      for (int q = 0; q < 6; ++q) zn[q] = zz[q * R];
    }
    cp_async_wait_prev();
    __syncthreads();
    const T* C = sM[cur];
    T xi[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < 6; ++k) acc = fma_rn(C[q * 6 + k], x[k], acc);
      xi[q] = sub_rn(zi[q], acc);
    }
    if (mine) {
      T* xo = X + i * stride + col;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        x[q] = xi[q];
        xo[q * R] = xi[q];
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_factor(const void* D, const void* B, void* Lcs, void* Cs, long long n,
                  void* stream) {
  if (n <= 0) return 0;
  factor_kernel<T><<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(D), static_cast<const T*>(B), static_cast<T*>(Lcs),
      static_cast<T*>(Cs), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_resolve(const void* Lcs, const void* Cs, const void* Bprev, const void* rhs,
                   void* X, long long n, long long R, void* stream) {
  if (n <= 0 || R <= 0) return 0;
  const long long blocks = (R + kCols - 1) / kCols;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  resolve_kernel<T><<<static_cast<unsigned>(blocks), kCols, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Lcs), static_cast<const T*>(Cs), static_cast<const T*>(Bprev),
      static_cast<const T*>(rhs), static_cast<T*>(X), n, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Right-hand columns (threads) per block of the resolve, for the wrapper's
// check.
extern "C" int lili_btri_resolve_cols() { return kCols; }

// D, B: (n,6,6); Lcs, Cs: (n,6,6) written in full. Returns cudaGetLastError()
// after the launch (0 when n <= 0: nothing launched).
extern "C" int lili_btri_factor_f32(const void* D, const void* B, void* Lcs, void* Cs,
                                    long long n, void* stream) {
  return launch_factor<float>(D, B, Lcs, Cs, n, stream);
}

extern "C" int lili_btri_factor_f64(const void* D, const void* B, void* Lcs, void* Cs,
                                    long long n, void* stream) {
  return launch_factor<double>(D, B, Lcs, Cs, n, stream);
}

// Lcs, Cs, Bprev: (n,6,6); rhs, X: (n,6,R), X written in full. Returns
// cudaGetLastError() after the launch.
extern "C" int lili_btri_resolve_f32(const void* Lcs, const void* Cs, const void* Bprev,
                                     const void* rhs, void* X, long long n, long long R,
                                     void* stream) {
  return launch_resolve<float>(Lcs, Cs, Bprev, rhs, X, n, R, stream);
}

extern "C" int lili_btri_resolve_f64(const void* Lcs, const void* Cs, const void* Bprev,
                                     const void* rhs, void* X, long long n, long long R,
                                     void* stream) {
  return launch_resolve<double>(Lcs, Cs, Bprev, rhs, X, n, R, stream);
}
