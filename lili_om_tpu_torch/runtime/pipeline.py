"""Asynchronous pipeline runner: the port's counterpart of
``lili_om_tpu/runtime/pipeline.py:86-350``, the in-process form of the
reference's four ROS processes (SURVEY.md §1):

* sensor feeds arrive from producer threads;
* a sequencer gates each scan until the IMU stream covers its sweep (the
  ±0.1 s stamp gates of ``LidarOdometry::run``, LidarOdometry.cpp:653-655,
  and ``BackendFusion::run``, BackendFusion.cpp:2727-2733);
* a **frontend worker** runs preprocessing and scan-to-map odometry;
* a **backend worker** fuses keyframes from a bounded handoff queue, so the
  frontend takes scan k+1 while the backend fuses keyframe k;
* the loop-closure cadence runs on its own thread (the 1 Hz
  ``loopClosureThread``, BackendFusion.cpp:2410-2421), sharing the backend
  mutex (the reference's ``mutual_exclusion``, :131, 2430, 2620).

Backpressure is the bounded queue (ROS ``queue_size``): by default the
oldest scans drop when the frontend falls behind; ``drop_when_full=False``
blocks the producer instead (offline replay).

Differences from the JAX runner:

* **Exceptions are not swallowed.** The first exception raised on any
  worker (frontend, backend, loop closure) is kept, every worker stops, and
  :meth:`PipelineRunner.stop` re-raises it. (The JAX loop thread ignores its
  exceptions, and a dead worker makes ``stop(drain=True)`` wait out its
  timeout; here a kernel that fails to build or launch on any thread fails
  the run.) ``stop(drain=True)`` also waits until every scan and keyframe
  handed to a worker has been processed, not only until the queues are
  empty, and raises if that does not happen within its timeout.
* **No fallback.** The sequencer is the native ``Sequencer`` and the IMU
  goes through the native SPSC ``Ring`` (``runtime/native.py``, the port's
  copy of ``native/lili_runtime.cc``), as in the JAX runner, but a failed
  build of the library raises instead of falling back to
  :class:`_PySequencer` (kept as the plain version for the tests) and the
  locked push.
* **IMU order is kept when the ring is full.** Producers push one at a
  time (the ring's single producer); a batch that does not fit first
  drains the ring into the system, under the lock the frontend's drain
  takes, then pushes directly, so the system's buffer stays in stamp order.
  (The JAX runner pushes it directly and leaves the older samples in the
  ring.)
* ``warm_graph_solver`` is not started: it warms XLA compiles, which the
  port does not have.

All three workers share PyTorch's current stream on the system's device, so
device work runs in launch order whichever thread enqueued it. The carried
states are replaced, never written in place, so a thread reading a state
while another computes the next one sees a whole state. On the card each
``StageMetrics`` stage ends in a device synchronize, which also waits for
work the other threads enqueued: in overlap mode a stage time includes
that wait.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np

from . import native

SCAN_STREAM = 0
IMU_STREAM = 1
# the IMU ring's records (stamp, acc, gyr: 56 bytes) and capacity, as the
# JAX runner's (the 200 Hz stream, producer thread → frontend worker)
_IMU_REC = np.dtype([("stamp", "<f8"), ("acc", "<f8", 3), ("gyr", "<f8", 3)])
IMU_RING_CAP = 8192


class _PySequencer:
    """Multi-stream stamp aligner in pure Python: a copy of the JAX runner's
    fallback, the plain version of the native :class:`native.Sequencer`
    (the tests hold the two together; no path uses it)."""

    def __init__(self, n_streams: int, tol: float):
        self.q = [[] for _ in range(n_streams)]
        self.tol = tol

    def push(self, stream: int, stamp: float, handle: int):
        self.q[stream].append((stamp, handle))

    def try_pop(self):
        if any(not q for q in self.q):
            return None
        pivot = max(q[0][0] for q in self.q)
        for q in self.q:
            while q and q[0][0] < pivot - self.tol:
                q.pop(0)
            if not q or q[0][0] > pivot + self.tol:
                return None
        out = [q.pop(0) for q in self.q]
        return [s for s, _ in out], [h for _, h in out]


class PipelineRunner:
    """Drives a ``LiliOmSystem`` from asynchronous scan and IMU feeds.

    ``feed_imu`` / ``feed_scan`` / ``feed_scan_livox`` may be called from
    any producer thread; the frontend processes scans in stamp order, and
    with ``overlap`` keyframe fusion runs on the backend worker meanwhile.
    """

    def __init__(self, system, queue_size: int = 100, loop_period_s: float = 1.0,
                 scan_period: float = 0.1, overlap: bool = True,
                 drop_when_full: bool = True):
        """``drop_when_full``: True = real-time semantics (the oldest scans
        drop under backpressure, the reference's bounded topic queues);
        False = lossless offline replay, ``feed_scan*`` blocks the producer
        instead. ``loop_period_s``: seconds between closure attempts of
        the loop thread (wall clock). A system on a mesh is refused: the
        loop thread's wall-clock attempts would fall at different scans on
        different ranks and leave their collectives unmatched."""
        if getattr(system, "mesh", None) is not None:
            raise NotImplementedError(
                "PipelineRunner does not drive a LiliOmSystem(mesh=...) yet: call "
                "process_scan and try_loop_closure at the same scans on every rank")
        self.system = system
        self.drop_when_full = drop_when_full
        self._scan_store: dict[int, tuple] = {}
        self._scan_seq = 0
        self._store_lock = threading.Lock()
        self._seq = native.Sequencer(2, scan_period)
        self._seq_lock = threading.Lock()
        self._imu_ring = native.Ring(_IMU_REC.itemsize, IMU_RING_CAP)
        # producers push one at a time (the ring's single producer); the
        # frontend's drain and a full ring's direct push hold _imu_lock
        self._imu_push_lock = threading.Lock()
        self._imu_lock = threading.Lock()
        self.n_imu_ring = 0  # samples that went through the ring
        self.n_imu_direct = 0  # samples pushed directly (ring full)
        self._scan_period = scan_period
        self._ready: queue.Queue = queue.Queue(maxsize=queue_size)
        self._kf_queue: queue.Queue = queue.Queue(maxsize=8)
        self._stop = threading.Event()
        self._front: Optional[threading.Thread] = None
        self._back: Optional[threading.Thread] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_period = loop_period_s
        self.overlap = overlap
        self.n_processed = 0
        self.n_keyframes = 0
        self.n_dropped = 0
        self.loop_closures = 0
        self.n_recoveries = 0  # elastic recoveries (health_check_and_recover)
        # backend mutex: keyframe fusion + loop closure + pose correction
        self._sys_lock = threading.Lock()
        self._err_lock = threading.Lock()
        self.error: Optional[BaseException] = None

    # ---- producers -----------------------------------------------------
    def feed_imu(self, stamps, accs, gyrs):
        stamps = np.atleast_1d(stamps)
        accs, gyrs = np.atleast_2d(accs), np.atleast_2d(gyrs)
        with self._imu_push_lock:
            # only the consumer frees room, so the producer's check is safe
            if len(self._imu_ring) + len(stamps) < self._imu_ring.capacity:
                recs = np.empty(len(stamps), _IMU_REC)
                recs["stamp"], recs["acc"], recs["gyr"] = stamps, accs, gyrs
                for r in recs.view(np.uint8).reshape(len(stamps), -1):
                    if not self._imu_ring.push(r):
                        raise RuntimeError("IMU ring full after its room check")
                self.n_imu_ring += len(stamps)
            else:
                with self._imu_lock:
                    self._drain_imu_locked()
                    self.system.push_imu(stamps, accs, gyrs)
                self.n_imu_direct += len(stamps)
        with self._seq_lock:
            # an IMU sample at t certifies sweep coverage up to t. The gate
            # accepts entries within ±tol of the scan stamp, so shift by
            # 2·period (tol = period): entry t−2p ≥ s−tol ⇔ t ≥ s+p, i.e. a
            # scan pops only once samples past its sweep end exist
            # (processIMU consumes through the scan end,
            # Preprocessing.cpp:135-171). One entry per sample: each popped
            # bundle consumes one; stale entries are dropped by the gate.
            for s in stamps:
                self._seq.push(IMU_STREAM, float(s) - 2 * self._scan_period, 0)
            self._drain_sequencer()

    def feed_scan(self, img, valid, rel_time, stamp: float):
        """Organized spinning-LiDAR sweep (R,C)."""
        self._feed(("spin", (np.asarray(img), np.asarray(valid), np.asarray(rel_time)),
                    float(stamp)))

    def feed_scan_livox(self, pts, line, ratio, refl, valid, stamp: float):
        """Flat Livox point stream (N,·), routed to ``process_scan_livox``."""
        self._feed(("livox", (np.asarray(pts), np.asarray(line), np.asarray(ratio),
                              np.asarray(refl), np.asarray(valid)), float(stamp)))

    def _feed(self, item):
        with self._store_lock:
            h = self._scan_seq
            self._scan_seq += 1
            self._scan_store[h] = item
        with self._seq_lock:
            self._seq.push(SCAN_STREAM, item[2], h)
            self._drain_sequencer()

    def _drain_sequencer(self):
        """Move every aligned bundle into the frontend queue (bounded drop,
        or producer backpressure when ``drop_when_full`` is off)."""
        while True:
            out = self._seq.try_pop()
            if out is None:
                return
            h = out[1][SCAN_STREAM]
            with self._store_lock:
                item = self._scan_store.pop(h, None)
            if item is None:
                continue
            if not self.drop_when_full:
                self._put_blocking(item)
                continue
            try:
                self._ready.put_nowait(item)
            except queue.Full:
                try:
                    self._ready.get_nowait()
                    self._ready.task_done()
                    self.n_dropped += 1
                    self._ready.put_nowait(item)
                except (queue.Empty, queue.Full):
                    pass

    def _put_blocking(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._ready.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    # ---- lifecycle -----------------------------------------------------
    def start(self):
        self._stop.clear()
        self._front = threading.Thread(target=self._front_work, name="lili-frontend",
                                       daemon=True)
        self._front.start()
        if self.overlap:
            self._back = threading.Thread(target=self._back_work, name="lili-backend",
                                          daemon=True)
            self._back.start()
        self._loop_thread = threading.Thread(target=self._loop_closure_loop,
                                             name="lili-loop-closure", daemon=True)
        self._loop_thread.start()

    def flush(self):
        """End of stream: release every scan still gated in the sequencer, in
        stamp order. Once the producer is done no further IMU coverage can
        arrive, so the gate would strand the tail scans; an offline tool must
        process everything it was fed. Undistortion of a flushed scan uses
        whatever IMU samples exist."""
        with self._seq_lock:
            with self._store_lock:
                items = sorted(self._scan_store.values(), key=lambda it: it[2])
                self._scan_store.clear()
        # later sequencer pops of these handles find the store empty and
        # skip (see _drain_sequencer): no double delivery
        for item in items:
            while not self._stop.is_set():
                try:
                    self._ready.put(item, timeout=0.2)
                    break
                except queue.Full:
                    if self.drop_when_full:
                        self.n_dropped += 1
                        break

    def _pending(self) -> bool:
        """Scans or keyframes handed to a worker and not yet processed."""
        return bool(self._ready.unfinished_tasks or self._kf_queue.unfinished_tasks)

    def stop(self, drain: bool = True, timeout: float = 300.0):
        """Stop the workers. With ``drain``, first flush the sequencer and
        wait until every scan and keyframe handed to a worker is processed;
        then wait for each worker to end (a closure attempt in flight runs
        to its end). Re-raises the first exception of any worker; raises
        ``TimeoutError`` if the drain or a worker did not finish within
        ``timeout`` seconds in all."""
        deadline = time.monotonic() + timeout
        undrained = False
        if drain:
            self.flush()
            while self.error is None and self._pending():
                if time.monotonic() > deadline:
                    undrained = True
                    break
                time.sleep(0.005)
        self._stop.set()
        running = []
        for th in (self._front, self._back, self._loop_thread):
            if th:
                th.join(timeout=max(deadline - time.monotonic(), 0.0))
                if th.is_alive():
                    running.append(th.name)
        if self.error is not None:
            raise self.error
        if undrained:
            raise TimeoutError(f"pipeline did not drain within {timeout} s")
        if running:
            raise TimeoutError(f"pipeline workers still running after {timeout} s: {running}")

    def _fail(self, e: BaseException):
        """Keep the first worker exception and stop every worker."""
        with self._err_lock:
            if self.error is None:
                self.error = e
        self._stop.set()

    def _drain_imu_locked(self):
        """Consumer side of the IMU ring (the caller holds ``_imu_lock``):
        the pending samples into the system buffer, one ``push_imu``."""
        recs = []
        while (r := self._imu_ring.pop()) is not None:
            recs.append(r)
        if recs:
            batch = np.stack(recs).view(_IMU_REC).reshape(-1)
            self.system.push_imu(np.ascontiguousarray(batch["stamp"]),
                                 np.ascontiguousarray(batch["acc"]),
                                 np.ascontiguousarray(batch["gyr"]))

    # ---- threads -------------------------------------------------------
    def _front_work(self):
        while not self._stop.is_set():
            try:
                kind, payload, stamp = self._ready.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                with self._imu_lock:
                    self._drain_imu_locked()
                self._front_step(kind, payload, stamp)
            except BaseException as e:
                self._fail(e)
                return
            finally:
                self._ready.task_done()

    def _front_step(self, kind, payload, stamp):
        step = (self.system.process_scan if kind == "spin"
                else self.system.process_scan_livox)
        if self.overlap:
            _, fc = step(*payload, stamp, defer_backend=True)
            if fc is not None:
                # bounded handoff: keyframes must not drop (they carry the
                # map), so backpressure stalls the frontend instead
                while not self._stop.is_set():
                    try:
                        self._kf_queue.put((fc, stamp), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        else:
            with self._sys_lock:
                step(*payload, stamp)
                if self.system.health_check_and_recover():
                    self.n_recoveries += 1
        self.n_processed += 1

    def _back_work(self):
        while not self._stop.is_set():
            try:
                fc, stamp = self._kf_queue.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                with self._sys_lock:
                    self.system.process_keyframe(fc, stamp)
                    # elastic recovery (absent in the reference, SURVEY.md
                    # §5): a NaN'd fusion state is re-seeded from the last
                    # finite keyframe here on the backend worker
                    if self.system.health_check_and_recover():
                        self.n_recoveries += 1
                self.n_keyframes += 1
            except BaseException as e:
                self._fail(e)
                return
            finally:
                self._kf_queue.task_done()

    def _loop_closure_loop(self):
        # the lock is passed in: try_loop_closure holds it for its snapshot
        # and update phases only; the ICP and the graph solve run unlocked,
        # so keyframe fusion never stalls behind a closure
        while not self._stop.wait(self._loop_period):
            try:
                if self.system.try_loop_closure(lock=self._sys_lock):
                    self.loop_closures += 1
            except BaseException as e:
                self._fail(e)
                return
