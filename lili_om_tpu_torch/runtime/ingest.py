"""Scan-ingest split over decode workers: the port's counterpart of
``lili_om_tpu/runtime/ingest.py:51-228``.

The host-side cost of ingesting a real sensor stream is the per-scan
decode: raw Velodyne packet parsing, or a record's ring/azimuth binning
into the organized image (``io/velodyne.py:decode_packets``,
``io/dataset.py:organize_scan``, ``apps/run_bag.py:decode_scan``). It is
numpy on the host and embarrassingly parallel, while the SLAM filter is
sequential. ``ShardedIngest`` splits the raw stream round-robin over
``n_hosts`` decode workers and re-sequences the decoded scans into strict
arrival order before forwarding them to the
:class:`~lili_om_tpu_torch.runtime.pipeline.PipelineRunner`, so downstream
behaviour equals a single inline decode.

Two worker modes:

* **threads** (default): numpy releases the GIL for much of a decode; the
  forward hop is an in-process queue;
* **processes** (``processes=True``): the decode workers are OS processes
  of a ``spawn`` pool, for decodes that hold the GIL; raw and decoded
  arrays are pickled across the boundary. ``decode_fn`` must be picklable
  (a module-level function, or a ``functools.partial`` of one). Each child
  hides the CUDA devices before its first task: decoding is host work, and
  a child must never initialize CUDA beside the parent's context.

A decode error is kept and raised by the next ``feed_raw`` or by
``close``.
"""
from __future__ import annotations

import heapq
import os
import queue
import threading
from typing import Callable, Optional

__all__ = ["ShardedIngest"]


def _hide_cuda():
    """Decode-worker initializer: no CUDA device is visible to the child."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


class ShardedIngest:
    """Round-robin raw-scan decode over ``n_hosts`` workers with an
    order-restoring merge.

    Args:
      runner: a PipelineRunner (or anything with ``feed_scan`` /
        ``feed_scan_livox``).
      decode_fn: ``raw -> ("spin", (img, valid, rel_time))`` or
        ``("livox", (pts, line, ratio, refl, valid))`` — the per-scan decode
        executed on the worker shard.
      n_hosts: decode parallelism (1 = inline decode, no threads).
      queue_cap: per-worker bounded input queue (backpressure to the
        producer, like the reference's bounded topic queues).
      processes: run the decode workers as OS processes of a ``spawn``
        pool instead of threads (true parallelism for decodes that hold
        the GIL; raw messages and decoded arrays cross the boundary by
        pickle, a few MB a scan). Requires a picklable ``decode_fn``.
        Order restoration is by future submission order (a single
        forwarder thread), so downstream behaviour stays bit-identical to
        inline decode.
    """

    def __init__(self, runner, decode_fn: Callable, n_hosts: int = 1,
                 queue_cap: int = 16, processes: bool = False):
        if n_hosts < 1:
            raise ValueError("n_hosts must be >= 1")
        self.runner = runner
        self.decode_fn = decode_fn
        self.n_hosts = n_hosts
        self.n_decoded = 0
        self.n_forwarded = 0
        self._seq = 0
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self.processes = bool(processes)  # honored even at n_hosts == 1
        if self.processes:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor

            self._pool = ProcessPoolExecutor(
                n_hosts, mp_context=mp.get_context("spawn"), initializer=_hide_cuda)
            self._futs: queue.Queue = queue.Queue(maxsize=queue_cap * n_hosts)
            self._fwd_done = threading.Event()
            self._fwd_thread = threading.Thread(target=self._fwd_loop,
                                                daemon=True)
            self._fwd_thread.start()
        elif n_hosts > 1:
            self._in: list[queue.Queue] = [queue.Queue(maxsize=queue_cap)
                                           for _ in range(n_hosts)]
            # order-restoring merge state: decoded scans may finish out of
            # order across workers; forward strictly by sequence number
            self._merge_lock = threading.Lock()
            self._merge_cv = threading.Condition(self._merge_lock)
            self._heap: list = []  # (seq, kind, payload, stamp)
            self._next_fwd = 0
            self._workers = [
                threading.Thread(target=self._work, args=(i,), daemon=True)
                for i in range(n_hosts)]
            for t in self._workers:
                t.start()

    # ---- producer side --------------------------------------------------
    def feed_raw(self, raw, stamp: float):
        """Submit one raw scan (packets, flat cloud, …). Blocks when the
        owning worker's queue is full (lossless backpressure)."""
        if self._err is not None:
            raise RuntimeError("ingest worker failed") from self._err
        s = self._seq
        self._seq += 1
        if self.processes:
            fut = self._pool.submit(self.decode_fn, raw)
            self._futs.put((s, fut, stamp))  # blocks: lossless backpressure
            return
        if self.n_hosts == 1:
            self._forward(s, *self._decode(raw), stamp)
            return
        self._in[s % self.n_hosts].put((s, raw, stamp))

    def close(self, timeout: float = 60.0):
        """Drain remaining decodes and stop the workers. Raises if the
        forwarder failed OR could not drain within ``timeout`` — an
        undrained close means dropped tail scans, which lossless offline
        replay must not silently accept."""
        if self.processes:
            import time as _time

            deadline = _time.monotonic() + timeout
            try:
                # bounded put: if a hung decode worker has wedged the
                # forwarder (blocked in fut.result) with a full queue, this
                # must FAIL LOUDLY within the timeout, not hang forever
                self._futs.put(None, timeout=timeout)  # sentinel
            except queue.Full:
                self._pool.shutdown(wait=False, cancel_futures=True)
                raise RuntimeError(
                    f"ingest close timed out after {timeout}s: decode "
                    "worker wedged with a full forward queue") from None
            if not self._fwd_done.wait(
                    timeout=max(deadline - _time.monotonic(), 0.001)):
                self._pool.shutdown(wait=False, cancel_futures=True)
                raise RuntimeError(
                    f"ingest close timed out after {timeout}s with "
                    "undelivered scans still queued")
            self._pool.shutdown(wait=True)
        elif self.n_hosts > 1:
            with self._merge_cv:
                self._merge_cv.wait_for(
                    lambda: self._next_fwd == self._seq or self._err,
                    timeout=timeout)
            self._stop.set()
            for t in self._workers:
                t.join(timeout=10)
        if self._err is not None:
            raise RuntimeError("ingest worker failed") from self._err

    def _fwd_loop(self):
        """Process mode: consume decode futures in submission order (strict
        sequence order by construction) and forward. NEVER exits before the
        close() sentinel: after a failure it keeps DRAINING the queue (items
        are discarded) so producers blocked in the bounded ``put`` unblock
        and observe ``self._err`` on their next ``feed_raw``."""
        while True:
            item = self._futs.get()
            if item is None:
                break
            if self._err is not None:
                continue  # draining after failure
            s, fut, stamp = item
            try:
                kind, payload = fut.result()
                if kind not in ("spin", "livox"):
                    raise ValueError(f"unknown kind {kind!r}")
                self.n_decoded += 1
                self._forward(s, kind, payload, stamp)
            except BaseException as e:
                self._err = e
        self._fwd_done.set()

    # ---- internals -------------------------------------------------------
    def _decode(self, raw):
        kind, payload = self.decode_fn(raw)
        if kind not in ("spin", "livox"):
            raise ValueError(f"decode_fn returned unknown kind {kind!r}")
        self.n_decoded += 1
        return kind, payload

    def _forward(self, seq, kind, payload, stamp):
        feed = (self.runner.feed_scan if kind == "spin"
                else self.runner.feed_scan_livox)
        feed(*payload, stamp)
        self.n_forwarded += 1

    def _work(self, i: int):
        q = self._in[i]
        while not self._stop.is_set():
            try:
                seq, raw, stamp = q.get(timeout=0.05)
            except queue.Empty:
                continue
            try:
                kind, payload = self._decode(raw)
            except BaseException as e:  # surface to the producer
                with self._merge_cv:
                    self._err = e
                    self._merge_cv.notify_all()
                return
            with self._merge_cv:
                heapq.heappush(self._heap, (seq, kind, payload, stamp))
                # forward every ready-in-order scan (any worker may do it —
                # the lock serializes, preserving strict order)
                while self._heap and self._heap[0][0] == self._next_fwd:
                    s, k, p, st = heapq.heappop(self._heap)
                    self._forward(s, k, p, st)
                    self._next_fwd += 1
                self._merge_cv.notify_all()
