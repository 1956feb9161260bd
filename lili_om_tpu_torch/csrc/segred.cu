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
// a scatter: segment s owns a contiguous run of the sorted rows.
//
// What bounds it on this card: bytes. It reads each payload element and id
// once and writes each output once (N*C*4 + N*8 + n_out*C*4 bytes in f32,
// under 4 MB at the pipeline's shapes: 0.00001-0.001 ms at 3.35 TB/s) and
// does one add per payload element. At these sizes what a launch costs is
// latency: the first version gave every (segment, channel) thread two binary
// searches over the ids in device memory, ~34 dependent loads, a ~12 us
// floor whatever the size.
//
// What the design does about it: each block owns kThreads / n_ch
// consecutive segments [s0, s1), one thread per (segment, channel). Two
// warps find the block's rows [lower_bound(s0), lower_bound(s1)) together,
// 32 probes a round chosen by a ballot, so four dependent rounds cover 10^6
// rows. The block then passes over its rows in coalesced chunks of kThreads,
// and a row whose id differs from its left (right) neighbour writes its
// segment's start (end) into a shared table; a segment that spans chunks
// gets its start and end from different chunks, an empty segment keeps
// [0, 0). Then the block stages its payload rows in shared memory, kStage
// elements a round with coalesced loads, and each (segment, channel) thread
// adds the staged rows of its segment in row order, from 0, carrying its sum
// across rounds. That is the order in which the plain version (index_add_
// on the CPU) adds them, so the result equals it bit for bit and two
// launches give identical bits, which index_add_ on the card, with its
// atomics, does not. A long segment (a voxel near the sensor holds up to
// ~500 rows) is still one thread's serial chain of adds, since the order is
// the contract, but it reads shared memory, not device memory.
// ops/segred.py:segment_sum_sorted_schedule mirrors this schedule on the CPU.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStage = 2048;  // payload elements staged a round (16 KB in f64)
constexpr unsigned kFull = 0xffffffffu;

// first row in [0, n) whose id is >= s (ids non-decreasing), by one warp:
// each round splits the range into 32 runs and probes the last row of each
__device__ __forceinline__ long long warp_lower_bound(const long long* __restrict__ ids,
                                                      long long n, long long s) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    long long p = lo + (lane + 1) * step - 1;
    if (p > hi - 1) p = hi - 1;
    const unsigned ball = __ballot_sync(kFull, ids[p] >= s);
    if (ball == 0) return hi;  // every row of the range is below s
    const int f = __ffs(ball) - 1;
    const long long first = lo + f * step;
    const long long last = lo + (f + 1) * step - 1;  // run f, its last row probed true
    if (step == 1) return first;
    lo = first;
    hi = last < hi - 1 ? last : hi - 1;  // ids[hi] >= s: the answer is <= hi
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segred_kernel(const T* __restrict__ pay, const long long* __restrict__ ids,
              long long n_rows, int n_ch, long long n_out, T* __restrict__ out) {
  __shared__ long long s_start[kThreads];
  __shared__ long long s_end[kThreads];
  __shared__ long long s_rows[2];
  __shared__ T s_pay[kStage];
  const int segs = kThreads / n_ch;
  const long long s0 = static_cast<long long>(blockIdx.x) * segs;
  const long long s1 = s0 + segs < n_out ? s0 + segs : n_out;
  for (int i = threadIdx.x; i < segs; i += kThreads) s_start[i] = s_end[i] = 0;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long b = warp_lower_bound(ids, n_rows, warp == 0 ? s0 : s1);
    if ((threadIdx.x & 31) == 0) s_rows[warp] = b;
  }
  __syncthreads();
  const long long lo = s_rows[0], hi = s_rows[1];
  for (long long r = lo + threadIdx.x; r < hi; r += kThreads) {
    const long long id = ids[r];
    if (r == lo || ids[r - 1] != id) s_start[id - s0] = r;
    if (r == hi - 1 || ids[r + 1] != id) s_end[id - s0] = r + 1;
  }
  __syncthreads();
  const int t = threadIdx.x;
  const bool mine = t < static_cast<int>(s1 - s0) * n_ch;
  const int seg = t / n_ch;
  const int c = t - seg * n_ch;
  const long long r_lo = mine ? s_start[seg] : 0, r_hi = mine ? s_end[seg] : 0;
  const int stage_rows = kStage / n_ch;
  T acc = T(0);
  for (long long c0 = lo; c0 < hi; c0 += stage_rows) {
    const long long c1 = c0 + stage_rows < hi ? c0 + stage_rows : hi;
    const int n_el = static_cast<int>(c1 - c0) * n_ch;
    for (int e = t; e < n_el; e += kThreads) s_pay[e] = pay[c0 * n_ch + e];
    __syncthreads();
    const long long a = r_lo > c0 ? r_lo : c0, b = r_hi < c1 ? r_hi : c1;
    for (long long r = a; r < b; ++r) acc += s_pay[(r - c0) * n_ch + c];
    __syncthreads();
  }
  if (mine) out[s0 * n_ch + t] = acc;
}

template <typename T>
int launch(const void* pay, const void* ids, long long n_rows, int n_ch, long long n_out,
           void* out, void* stream) {
  if (n_out <= 0 || n_ch <= 0) return 0;
  if (n_ch > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int segs = kThreads / n_ch;
  const long long n_blocks = (n_out + segs - 1) / segs;
  if (n_blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  segred_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pay), static_cast<const long long*>(ids), n_rows, n_ch, n_out,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Threads per block (a block owns threads / n_ch segments), for the
// schedule's plain mirror.
extern "C" int lili_segred_block_threads() { return kThreads; }

// pay: (n_rows, n_ch) row-major, f32 or f64, 1 <= n_ch <= 256; ids:
// (n_rows,) int64, non-decreasing, >= 0; out: (n_out, n_ch), same type as
// pay, written in full. Returns cudaGetLastError() after the launch.
extern "C" int lili_segred_f32(const void* pay, const void* ids, long long n_rows,
                               int n_ch, long long n_out, void* out, void* stream) {
  return launch<float>(pay, ids, n_rows, n_ch, n_out, out, stream);
}

extern "C" int lili_segred_f64(const void* pay, const void* ids, long long n_rows,
                               int n_ch, long long n_out, void* out, void* stream) {
  return launch<double>(pay, ids, n_rows, n_ch, n_out, out, stream);
}
