// lili_om_tpu_torch native runtime: host-side transport & I/O, the port's
// own copy of native/lili_runtime.cc with the same C interface and the same
// byte formats (a log or PCD written by either library reads in the other).
//
// The in-process equivalents of the reference's ROS runtime shell (four OS
// processes, SURVEY.md §1) and of its PCL cloud I/O, driven from Python
// through ctypes:
//
//  * a lock-free SPSC ring buffer of fixed-size records (the bounded topic
//    queues, e.g. queue_size=100 at Preprocessing.cpp:62-67);
//  * a multi-stream time sequencer (the ±0.1 s input gating of
//    LidarOdometry::run / BackendFusion::run, LidarOdometry.cpp:653-655,
//    BackendFusion.cpp:2727-2733);
//  * binary PCD write (the save_pcd map export, BackendFusion.cpp:2697-2722);
//  * a record-log reader with a background readahead thread: the dataset
//    loader replacing `rosbag play` (README.md:57-76), scans and IMU stored
//    as length-prefixed records, prefetched off the compute thread.
//
// Built at first use by lili_om_tpu_torch/cuda_build.py with the host C++
// compiler ($CXX, else g++) into lili_om_tpu_torch/_build/, and loaded by
// lili_om_tpu_torch/runtime/native.py. Plain C ABI, no Python.h.
//
// One change from the original: log_reader_peek re-reads the head after it
// sees the reader thread done, so a record pushed between its two loads is
// not taken for the end of the log.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer (fixed-size records)
// ---------------------------------------------------------------------------

struct Ring {
  std::vector<uint8_t> buf;
  size_t record_size;
  size_t capacity;  // records
  std::atomic<uint64_t> head{0};  // next write slot
  std::atomic<uint64_t> tail{0};  // next read slot
};

Ring* ring_create(size_t record_size, size_t capacity) {
  Ring* r = new Ring();
  r->record_size = record_size;
  r->capacity = capacity;
  r->buf.resize(record_size * capacity);
  return r;
}

void ring_destroy(Ring* r) { delete r; }

// 0 on success, -1 if full
int ring_push(Ring* r, const void* rec) {
  uint64_t h = r->head.load(std::memory_order_relaxed);
  uint64_t t = r->tail.load(std::memory_order_acquire);
  if (h - t >= r->capacity) return -1;
  std::memcpy(&r->buf[(h % r->capacity) * r->record_size], rec, r->record_size);
  r->head.store(h + 1, std::memory_order_release);
  return 0;
}

// 0 on success, -1 if empty
int ring_pop(Ring* r, void* rec) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t h = r->head.load(std::memory_order_acquire);
  if (t == h) return -1;
  std::memcpy(rec, &r->buf[(t % r->capacity) * r->record_size], r->record_size);
  r->tail.store(t + 1, std::memory_order_release);
  return 0;
}

size_t ring_size(Ring* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

// ---------------------------------------------------------------------------
// Multi-stream time sequencer
// ---------------------------------------------------------------------------
// Streams push (stamp, handle) pairs; try_pop emits one aligned bundle when
// every stream has an entry within `tol` of the slowest stream's front.

struct Seq {
  struct Entry { double stamp; uint64_t handle; };
  std::vector<std::vector<Entry>> q;
  double tol;
};

Seq* seq_create(int n_streams, double tol) {
  Seq* s = new Seq();
  s->q.resize(n_streams);
  s->tol = tol;
  return s;
}

void seq_destroy(Seq* s) { delete s; }

void seq_push(Seq* s, int stream, double stamp, uint64_t handle) {
  s->q[stream].push_back({stamp, handle});
}

// Returns 1 and fills stamps/handles (length n_streams) when an aligned
// bundle exists; drops stale entries older than the pivot − tol. Returns 0
// otherwise.
int seq_try_pop(Seq* s, double* stamps, uint64_t* handles) {
  // pivot: max over streams of the oldest pending stamp
  double pivot = -1e300;
  for (auto& q : s->q) {
    if (q.empty()) return 0;
    if (q.front().stamp > pivot) pivot = q.front().stamp;
  }
  // each stream must contain an entry within tol of the pivot
  for (size_t i = 0; i < s->q.size(); i++) {
    auto& q = s->q[i];
    // drop entries too old to ever match (reference: old_cloud buffers popped
    // until stamps align, LidarOdometry.cpp:653-664)
    size_t k = 0;
    while (k < q.size() && q[k].stamp < pivot - s->tol) k++;
    q.erase(q.begin(), q.begin() + k);
    if (q.empty() || q.front().stamp > pivot + s->tol) return 0;
  }
  for (size_t i = 0; i < s->q.size(); i++) {
    stamps[i] = s->q[i].front().stamp;
    handles[i] = s->q[i].front().handle;
    s->q[i].erase(s->q[i].begin());
  }
  return 1;
}

// ---------------------------------------------------------------------------
// Binary PCD I/O (xyz + optional intensity), PCL-compatible v0.7
// ---------------------------------------------------------------------------

int pcd_write(const char* path, const float* data, uint64_t n, int n_fields) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const char* fields = n_fields == 4 ? "x y z intensity" : "x y z";
  const char* size = n_fields == 4 ? "4 4 4 4" : "4 4 4";
  const char* type = n_fields == 4 ? "F F F F" : "F F F";
  const char* count = n_fields == 4 ? "1 1 1 1" : "1 1 1";
  std::fprintf(f,
               "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
               "FIELDS %s\nSIZE %s\nTYPE %s\nCOUNT %s\nWIDTH %llu\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS %llu\nDATA binary\n",
               fields, size, type, count, (unsigned long long)n,
               (unsigned long long)n);
  size_t wrote = std::fwrite(data, sizeof(float) * n_fields, n, f);
  std::fclose(f);
  return wrote == n ? 0 : -1;
}

// ---------------------------------------------------------------------------
// Record log: the dataset format replacing rosbags.
// File = sequence of [uint32 kind][uint32 nbytes][payload] records.
// ---------------------------------------------------------------------------

struct LogWriter {
  FILE* f;
};

LogWriter* log_writer_open(const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  LogWriter* w = new LogWriter{f};
  return w;
}

int log_writer_append(LogWriter* w, uint32_t kind, const void* data,
                      uint32_t nbytes) {
  if (std::fwrite(&kind, 4, 1, w->f) != 1) return -1;
  if (std::fwrite(&nbytes, 4, 1, w->f) != 1) return -1;
  if (nbytes && std::fwrite(data, 1, nbytes, w->f) != nbytes) return -1;
  return 0;
}

void log_writer_close(LogWriter* w) {
  std::fclose(w->f);
  delete w;
}

// Reader with a background readahead thread: records are prefetched into a
// bounded queue so record parsing overlaps device compute on the consumer
// thread (the rosbag-play + subscriber-queue pattern, in-process).
struct LogReader {
  FILE* f;
  std::thread th;
  std::atomic<bool> done{false};
  std::atomic<bool> stop{false};
  // simple bounded queue guarded by the SPSC discipline: the reader thread
  // is the single producer, the consumer API the single consumer.
  struct Rec { uint32_t kind; std::vector<uint8_t> data; };
  std::vector<Rec> slots;
  std::atomic<uint64_t> head{0}, tail{0};
  size_t cap;
};

static void reader_main(LogReader* r) {
  while (!r->stop.load()) {
    uint64_t h = r->head.load(std::memory_order_relaxed);
    uint64_t t = r->tail.load(std::memory_order_acquire);
    if (h - t >= r->cap) {  // backpressure
      std::this_thread::yield();
      continue;
    }
    uint32_t kind, nbytes;
    if (std::fread(&kind, 4, 1, r->f) != 1 || std::fread(&nbytes, 4, 1, r->f) != 1) {
      r->done.store(true);
      return;
    }
    LogReader::Rec& rec = r->slots[h % r->cap];
    rec.kind = kind;
    rec.data.resize(nbytes);
    if (nbytes && std::fread(rec.data.data(), 1, nbytes, r->f) != nbytes) {
      r->done.store(true);
      return;
    }
    r->head.store(h + 1, std::memory_order_release);
  }
}

LogReader* log_reader_open(const char* path, size_t readahead) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  LogReader* r = new LogReader();
  r->f = f;
  r->cap = readahead ? readahead : 64;
  r->slots.resize(r->cap);
  r->th = std::thread(reader_main, r);
  return r;
}

// Peek next record size; returns nbytes, or -1 when the log is exhausted,
// or -2 when not yet available (try again).
int64_t log_reader_peek(LogReader* r, uint32_t* kind) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t h = r->head.load(std::memory_order_acquire);
  if (t == h) {
    if (!r->done.load()) return -2;
    // done is stored after the last head: read the head again
    h = r->head.load(std::memory_order_acquire);
    if (t == h) return -1;
  }
  LogReader::Rec& rec = r->slots[t % r->cap];
  *kind = rec.kind;
  return (int64_t)rec.data.size();
}

// Pop next record into out (must be sized from peek). 0 ok, -1 empty.
int log_reader_pop(LogReader* r, void* out) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t h = r->head.load(std::memory_order_acquire);
  if (t == h) return -1;
  LogReader::Rec& rec = r->slots[t % r->cap];
  if (!rec.data.empty()) std::memcpy(out, rec.data.data(), rec.data.size());
  r->tail.store(t + 1, std::memory_order_release);
  return 0;
}

void log_reader_close(LogReader* r) {
  r->stop.store(true);
  if (r->th.joinable()) r->th.join();
  std::fclose(r->f);
  delete r;
}

}  // extern "C"
