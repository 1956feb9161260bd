"""runtime/native.py: the port's native host runtime (its copy of
``native/lili_runtime.cc``, built at first use into ``_build/``) on the
CPU, against the JAX package's ``lili_om_tpu.runtime.native`` (the committed
library) and against the port's plain versions.

* Against JAX: the same pushes and pops on ``Ring`` (FIFO, a full ring
  rejects, an empty one returns None); the same ``Sequencer`` pops on feeds
  with stale entries and stamps on and beside the gate's edges; ``.lom``
  files byte-identical from either writer, each package's reader reading
  the other's; ``pcd_write_native`` byte-identical.
* Against the plain versions: ``_PySequencer`` (the same pops),
  ``runtime/log.py`` (the same bytes both ways, a truncated last record
  ends both readers), ``io/pcd.py:write_pcd`` (the same bytes); an SPSC
  stress of the ring across two threads.
* The build: a compiler that fails raises with its output; processes
  building at once leave one library and no temporary file.
* Lifetimes: a reader dropped mid-file returns at once, and a process that
  exits with a reader open ends.
* The runner: the IMU goes through the ring, and a batch that does not fit
  drains the ring first, so the system receives every sample in order;
  under eight producer threads and a draining consumer every sample
  arrives once.
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from lili_om_tpu.runtime import native as JN
from lili_om_tpu_torch import cuda_build
from lili_om_tpu_torch.io.pcd import write_pcd
from lili_om_tpu_torch.runtime import log as plain_log
from lili_om_tpu_torch.runtime import native as TN
from lili_om_tpu_torch.runtime import pipeline
from lili_om_tpu_torch.runtime.pipeline import PipelineRunner, _PySequencer

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.skipif(not JN.available(), reason="the JAX native library is missing")


def _records(seed=0, n=40):
    """(kind, payload) records of every kind and of sizes 0 to 3000 bytes."""
    rng = np.random.default_rng(seed)
    kinds = (TN.KIND_SCAN, TN.KIND_IMU, TN.KIND_META)
    return [(kinds[i % 3], rng.integers(0, 256, int(rng.integers(0, 3000)) * (i != 5),
                                        dtype=np.uint8)) for i in range(n)]


# ---------------------------------------------------------------------------
# against the JAX package's native library
# ---------------------------------------------------------------------------

def _ring_script(ring):
    """A fixed sequence of pushes and pops on a 16-byte ring of capacity 4;
    returns every result (push accepted, popped bytes or None, size)."""
    out = []
    for step in range(30):
        if step % 7 in (0, 1, 2, 4, 5):
            ok = ring.push(np.arange(16, dtype=np.uint8) + step)
            out.append(("push", ok, len(ring)))
        else:
            r = ring.pop()
            out.append(("pop", None if r is None else r.tolist(), len(ring)))
    while (r := ring.pop()) is not None:
        out.append(("drain", r.tolist(), len(ring)))
    out.append(("empty", ring.pop(), len(ring)))
    return out


def test_ring_matches_jax():
    got = _ring_script(TN.Ring(16, 4))
    assert got == _ring_script(JN.Ring(16, 4))
    assert any(e[0] == "push" and e[1] is False for e in got)  # a full ring rejected
    assert got[-1] == ("empty", None, 0)


def _feeds():
    """Sequencer feeds: (name, streams, tol, [(stream, stamp, handle)])."""
    tol = 0.1
    stale = [(0, 0.0, 1), (0, 0.5, 2), (1, 0.52, 3), (0, 0.9, 4), (1, 0.2, 5), (1, 0.95, 6),
             (0, 1.2, 7), (1, 1.2 + tol, 8), (0, 1.4, 9), (1, 1.4 - tol, 10), (1, 1.45, 11)]
    # stamps exactly on the gate's edges and one ulp either side of them
    ties = []
    for i, base in enumerate(np.arange(1.0, 3.0, 0.25)):
        for j, d in enumerate((-tol, tol)):
            edge = base + d
            for k, s in enumerate((np.nextafter(edge, -np.inf), edge, np.nextafter(edge, np.inf))):
                ties.append((1, float(s), 100 * i + 10 * j + k))
        ties.append((0, float(base), 1000 + i))
    rng = np.random.default_rng(3)
    rand = [(int(s), float(t), h) for h, (s, t) in enumerate(zip(
        rng.integers(0, 3, 400), np.sort(rng.uniform(0, 10, 400)) + rng.normal(0, 0.05, 400)))]
    return [("stale", 2, tol, stale), ("near_ties", 2, tol, ties), ("random3", 3, 0.08, rand)]


def _pops(seq, feed):
    """Push the feed, trying a pop after every push; every bundle popped."""
    out = []
    for stream, stamp, handle in feed:
        seq.push(stream, stamp, handle)
        while (b := seq.try_pop()) is not None:
            out.append((list(b[0]), list(b[1])))
    return out


@pytest.mark.parametrize("name,n,tol,feed", _feeds(), ids=[f[0] for f in _feeds()])
def test_sequencer_matches_jax_and_plain(name, n, tol, feed):
    got = _pops(TN.Sequencer(n, tol), feed)
    assert got == _pops(JN.Sequencer(n, tol), feed)
    assert got == _pops(_PySequencer(n, tol), feed)
    assert len(got) >= 3


def _write(writer_cls, path, recs):
    w = writer_cls(str(path))
    for kind, data in recs:
        w.append(kind, data)
    w.close()


def _read(reader_cls, path, readahead=4):
    r = reader_cls(str(path), readahead=readahead)
    try:
        return [(k, d.tolist()) for k, d in r]
    finally:
        r.close()


@pytest.mark.parametrize("other", ["jax_native", "plain"])
def test_log_bytes_and_readers_match(tmp_path, other):
    """The port's native log against JAX's native one and against the
    port's plain ``runtime/log.py``: the same bytes from either writer, and
    every reader reads every file the same."""
    W, Rd = {"jax_native": (JN.LogWriter, JN.LogReader),
             "plain": (plain_log.LogWriter, plain_log.LogReader)}[other]
    recs = _records()
    _write(TN.LogWriter, tmp_path / "port.lom", recs)
    _write(W, tmp_path / "other.lom", recs)
    assert (tmp_path / "port.lom").read_bytes() == (tmp_path / "other.lom").read_bytes()
    want = [(k, d.tolist()) for k, d in recs]
    for path in ("port.lom", "other.lom"):
        assert _read(TN.LogReader, tmp_path / path) == want
        assert _read(Rd, tmp_path / path) == want


def test_truncated_last_record_ends_both_readers(tmp_path):
    p = tmp_path / "t.lom"
    recs = _records(seed=1, n=6)
    _write(TN.LogWriter, p, recs)
    with open(p, "ab") as f:
        f.write(np.array([TN.KIND_SCAN, 100], "<u4").tobytes() + b"\x01" * 7)
    want = [(k, d.tolist()) for k, d in recs]
    assert _read(TN.LogReader, p, 2) == want == _read(plain_log.LogReader, p, 2)


@pytest.mark.parametrize("intensity", [False, True])
def test_pcd_bytes_match_jax_and_plain(tmp_path, intensity):
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(301, 3)) * 30
    inten = rng.uniform(0, 255, 301) if intensity else None
    paths = [tmp_path / f"{w}.pcd" for w in ("port", "jax", "plain")]
    assert TN.pcd_write_native(str(paths[0]), pts, inten)
    assert JN.pcd_write_native(str(paths[1]), pts, inten)
    write_pcd(str(paths[2]), pts, inten)
    blobs = [p.read_bytes() for p in paths]
    assert blobs[0] == blobs[1] == blobs[2]
    assert not TN.pcd_write_native(str(tmp_path / "missing" / "x.pcd"), pts, inten)


# ---------------------------------------------------------------------------
# the ring under two threads
# ---------------------------------------------------------------------------

def test_ring_spsc_threaded_stress():
    """One producer and one consumer thread: every accepted record comes out
    once, in order (tests/test_native_runtime.py:84)."""
    ring, n, got = TN.Ring(8, 64), 20000, []

    def producer():
        i = 0
        while i < n:
            if ring.push(np.frombuffer(np.uint64(i).tobytes(), np.uint8)):
                i += 1

    def consumer():
        while len(got) < n:
            rec = ring.pop()
            if rec is not None:
                got.append(int(rec.view(np.uint64)[0]))

    threads = [threading.Thread(target=f) for f in (producer, consumer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert got == list(range(n)) and len(ring) == 0


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "bad-cxx"
    fake.write_text('#!/bin/sh\necho "lili_runtime.cc:1: error: the stand-in compiler" >&2\n'
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(TN, "_lib", None)
    with pytest.raises(RuntimeError, match="the stand-in compiler"):
        TN.Ring(8, 2)
    assert not TN.available()
    assert not cuda_build.library_path("lili_runtime").exists()


def test_processes_building_at_once_leave_one_library(tmp_path):
    """Four processes build the library into one empty directory at the
    same time (as the test workers may): each loads it, and one file is
    left, with no temporary."""
    code = ("import ctypes, sys\nfrom pathlib import Path\n"
            "from lili_om_tpu_torch import cuda_build as B\n"
            "B.BUILD_DIR = Path(sys.argv[1])\nB.build(['lili_runtime'])\n"
            "ctypes.CDLL(str(B.library_path('lili_runtime')))\nprint('ok')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert all(p.returncode == 0 and o.strip().endswith("ok") for p, o in zip(procs, outs)), outs
    assert [p.name for p in tmp_path.iterdir()] == [
        cuda_build.library_path("lili_runtime").name]


# ---------------------------------------------------------------------------
# the reader's thread
# ---------------------------------------------------------------------------

def _big_log(path, n=200):
    w = TN.LogWriter(str(path))
    for i in range(n):
        w.append(TN.KIND_META, np.full(1 << 16, i % 251, np.uint8))
    w.close()


def test_reader_closed_mid_file_returns_at_once(tmp_path):
    p = tmp_path / "big.lom"
    _big_log(p)
    r = TN.LogReader(str(p), readahead=2)
    kind, data = next(r)
    assert kind == TN.KIND_META and len(data) == 1 << 16
    t0 = time.monotonic()
    r.close()
    del r
    assert time.monotonic() - t0 < 2.0


def test_process_exiting_with_a_reader_open_ends(tmp_path):
    p = tmp_path / "big.lom"
    _big_log(p)
    code = ("import sys\nfrom lili_om_tpu_torch.runtime import native\n"
            "r = native.LogReader(sys.argv[1], readahead=2)\nnext(r)\nprint('read one')\n")
    res = subprocess.run([sys.executable, "-c", code, str(p)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "read one", res.stderr


# ---------------------------------------------------------------------------
# the runner's IMU ring
# ---------------------------------------------------------------------------

class _ImuSink:
    """A stand-in system that keeps the IMU stamps in the order received."""

    def __init__(self):
        self.stamps = []

    def push_imu(self, stamps, accs, gyrs):
        assert accs.shape == gyrs.shape == (len(stamps), 3)
        self.stamps.extend(np.asarray(stamps).tolist())


def test_runner_imu_ring_full_keeps_order(monkeypatch):
    """Batches go through the native ring until one does not fit; that one
    first drains the ring into the system, then is pushed directly: the
    system receives every sample once, in stamp order."""
    monkeypatch.setattr(pipeline, "IMU_RING_CAP", 64)
    sink = _ImuSink()
    runner = PipelineRunner(sink)
    assert isinstance(runner._seq, TN.Sequencer) and isinstance(runner._imu_ring, TN.Ring)
    stamps = np.arange(200) * 0.005
    for lo in range(0, 200, 25):
        s = stamps[lo:lo + 25]
        runner.feed_imu(s, np.ones((len(s), 3)) * s[:, None], np.zeros((len(s), 3)))
    assert runner.n_imu_ring > 0 and runner.n_imu_direct > 0
    assert runner.n_imu_ring + runner.n_imu_direct == 200
    runner._drain_imu_locked()
    assert sink.stamps == stamps.tolist()


def test_runner_imu_under_many_producers():
    """Eight producer threads feed the runner's IMU while a consumer drains
    it, the ring small enough that both the ring and the direct path run,
    thread switches every microsecond: every sample reaches the system
    once, and each producer's samples in its order."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        sink = _ImuSink()
        runner = PipelineRunner(sink)
        runner._imu_ring = TN.Ring(pipeline._IMU_REC.itemsize, 16)
        done = threading.Event()

        def produce(p):
            for i in range(0, 300, 3):
                s = p * 1000.0 + np.arange(i, i + 3)
                runner.feed_imu(s, np.zeros((3, 3)), np.zeros((3, 3)))

        def consume():
            while not done.is_set():
                with runner._imu_lock:
                    runner._drain_imu_locked()

        producers = [threading.Thread(target=produce, args=(p,)) for p in range(8)]
        consumer = threading.Thread(target=consume)
        consumer.start()
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=60)
        done.set()
        consumer.join(timeout=60)
        assert not any(t.is_alive() for t in producers + [consumer])
    finally:
        sys.setswitchinterval(prev)
    runner._drain_imu_locked()
    got = np.asarray(sink.stamps)
    assert len(got) == 8 * 300 and runner.n_imu_direct > 0 and runner.n_imu_ring > 0
    for p in range(8):
        mine = got[(got >= p * 1000.0) & (got < p * 1000.0 + 1000.0)]
        np.testing.assert_array_equal(mine, p * 1000.0 + np.arange(300))
