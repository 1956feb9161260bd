// Segment sum over sorted segment ids, for Hopper (sm_90a).
//
// Replaces: lili_om_tpu/ops/segred_pallas.py:_segred_kernel (launched by
// segment_sum_sorted_pallas), the scatter-free form of
// jax.ops.segment_sum(..., indices_are_sorted=True) in the voxel pipeline.
// Contract: out[s, c] = sum of payload[r, c] over the rows r with
// seg_id[r] == s, for 0 <= s < n_out; ids are non-decreasing and rows with
// an id >= n_out are dropped; a segment with no row reads 0.
//
// What is not carried over from the TPU kernel: it reduced each 1024-row
// block with one one-hot matmul on the MXU into a VMEM-resident output, the
// TPU's way around a scatter. A sorted reduction needs neither a matmul nor
// a scatter: segment s owns the contiguous rows [lower_bound(s),
// lower_bound(s + 1)) of the sorted ids.
//
// What bounds it on this card: bytes. It reads each payload element and id
// once and writes each output once (N*C*4 + N*8 + n_out*C*4 bytes in f32,
// under 4 MB at the pipeline's shapes: 0.001 ms at 3.35 TB/s) and does one
// add per payload element.
//
// What the design does about it: one thread per (segment, channel). Each
// finds its segment's row range by two binary searches over the ids (no
// atomics, no host sync, no second pass) and adds its rows in row order,
// starting from 0. That is the order in which the plain version
// (index_add_ on the CPU) adds them, so the result equals it bit for bit and
// two launches give identical bits, which index_add_ on the card, with its
// atomics, does not. Threads of neighbouring segments read neighbouring
// rows, so the loads of a warp fall on a few cache lines. Known weakness: a
// long segment (a voxel near the sensor holds hundreds of rows) is summed
// by one thread serially; a warp per long segment is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// first row in [0, n) whose id is >= s (ids non-decreasing)
__device__ __forceinline__ long long lower_bound(const long long* __restrict__ ids,
                                                 long long n, long long s) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (ids[mid] < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segred_kernel(const T* __restrict__ pay, const long long* __restrict__ ids,
              long long n_rows, int n_ch, long long n_out, T* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_out * n_ch) return;
  const long long s = t / n_ch;
  const int c = static_cast<int>(t - s * n_ch);
  const long long lo = lower_bound(ids, n_rows, s);
  const long long hi = lo + lower_bound(ids + lo, n_rows - lo, s + 1);
  T acc = T(0);
  for (long long r = lo; r < hi; ++r) acc += pay[r * n_ch + c];
  out[t] = acc;
}

template <typename T>
int launch(const void* pay, const void* ids, long long n_rows, int n_ch,
           long long n_out, void* out, void* stream) {
  const long long n_threads = n_out * n_ch;
  if (n_threads <= 0) return 0;
  const long long n_blocks = (n_threads + kThreads - 1) / kThreads;
  if (n_blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  segred_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pay), static_cast<const long long*>(ids), n_rows, n_ch,
      n_out, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pay: (n_rows, n_ch) row-major, f32 or f64; ids: (n_rows,) int64,
// non-decreasing; out: (n_out, n_ch), same type as pay, written in full.
// Returns cudaGetLastError() after the launch.
extern "C" int lili_segred_f32(const void* pay, const void* ids, long long n_rows,
                               int n_ch, long long n_out, void* out, void* stream) {
  return launch<float>(pay, ids, n_rows, n_ch, n_out, out, stream);
}

extern "C" int lili_segred_f64(const void* pay, const void* ids, long long n_rows,
                               int n_ch, long long n_out, void* out, void* stream) {
  return launch<double>(pay, ids, n_rows, n_ch, n_out, out, stream);
}
