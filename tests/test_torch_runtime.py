"""The port's runtime entry points (``lili_om_tpu_torch/{io,runtime,apps}``)
against the JAX package's, on the CPU.

* File formats: a ``.lom`` record log, a PCD, raw Velodyne packets and ROS1
  bags written by one package read equal in the other (bytes and arrays
  exactly: the formats are byte layouts). ``record_synthetic`` from the
  port's simulator equals the JAX one's record for record at the
  simulator's float32 tolerance (tests/test_torch_sim.py: 2e-4 m).
* The runner and the ingest split, the port's side only (the JAX runner's
  tests hold its semantics): serial and overlapped runs equal direct
  ``process_scan`` calls exactly, spin and Livox, at tests/test_pipeline.py's
  ``tiny_system`` size; the sequencer gate, bounded drops and ``flush``;
  a fault on any of the three workers is re-raised by ``stop()``; the
  health check; the order-restoring merge in thread and process mode.
* The kernel loader and the launch counters under threads.
* The entry points ``apps.run_dataset`` and ``apps.run_bag`` end to end on
  small logs and bags written here, on the CPU.
"""
import functools
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lili_om_tpu.io import dataset as JD
from lili_om_tpu.io import pcd as JP
from lili_om_tpu.io import rosbag as JB
from lili_om_tpu.io import velodyne as JV
from lili_om_tpu.runtime import native
from lili_om_tpu_torch import cuda_build
from lili_om_tpu_torch.io import dataset as TD
from lili_om_tpu_torch.io import pcd as TP
from lili_om_tpu_torch.io import rosbag as TB
from lili_om_tpu_torch.io import velodyne as TV
from lili_om_tpu_torch.ops import knn as K
from lili_om_tpu_torch.ops import segred as SG
from lili_om_tpu_torch.runtime.ingest import ShardedIngest
from lili_om_tpu_torch.runtime.pipeline import PipelineRunner
from lili_om_tpu_torch.sim.lidar import livox_pattern, simulate_scan, spinning_pattern
from lili_om_tpu_torch.sim.trajectory import circle_trajectory, simulate_imu
from lili_om_tpu_torch.sim.world import make_room_world
from test_rosbag import _imu_msg, _livox_msg, _pc2_msg, _write_bag
from test_torch_common import CPU, npy, tiny_system, tree_dict
from test_velodyne import _grid_points, _velodyne_scan_msg

# tests/test_pipeline.py's sizes
R, C, PERIOD, N_SCANS = 16, 360, 0.1, 7
LIVOX_PTS = 400  # tiny_system's livox n_cols

needs_native = pytest.mark.skipif(not native.available(), reason="JAX native lib unavailable")


# ---------------------------------------------------------------------------
# record log, dataset, PCD
# ---------------------------------------------------------------------------

def _records(seed=0):
    """IMU and scan records from a seed: 5 IMU samples, 3 scans."""
    rng = np.random.default_rng(seed)
    imus = [(0.005 * i, rng.normal(size=3).astype(np.float32),
             rng.normal(size=3).astype(np.float32)) for i in range(5)]
    scans = []
    for i in range(3):
        n = int(rng.integers(100, 500))
        scans.append((0.1 * i, rng.normal(size=(n, 3)).astype(np.float32),
                      rng.uniform(size=n).astype(np.float32),
                      rng.uniform(1, 200, size=n).astype(np.float32),
                      rng.integers(0, 16, size=n).astype(np.int32)))
    return imus, scans


def _write_log(mod, path, imus, scans):
    w = mod.DatasetWriter(path)
    for r in imus:
        w.write_imu(mod.ImuRecord(*r))
    for r in scans:
        w.write_scan(mod.ScanRecord(*r))
    w.close()


def _assert_same_records(got, want):
    assert [type(r).__name__ for r in got] == [type(r).__name__ for r in want]
    for a, b in zip(got, want):
        assert a.stamp == b.stamp
        for x, y in zip(a[1:], b[1:]):
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)


@needs_native
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lom_reads_in_the_other_package(tmp_path, writer):
    """A log written by one package has the other's bytes and reads record
    for record, with equal arrays, in the other package."""
    imus, scans = _records()
    paths = {name: str(tmp_path / f"{name}.lom") for name in ("jax", "port")}
    _write_log(JD, paths["jax"], imus, scans)
    _write_log(TD, paths["port"], imus, scans)
    with open(paths["jax"], "rb") as f, open(paths["port"], "rb") as g:
        assert f.read() == g.read()
    reader = TD.read_dataset if writer == "jax" else JD.read_dataset
    got = list(reader(paths[writer]))
    want = list((JD if writer == "jax" else TD).read_dataset(paths[writer]))
    assert len(got) == 8
    _assert_same_records(got, want)


def test_log_reader_readahead_and_truncation(tmp_path):
    """The readahead queue holds at most ``readahead`` records, and a
    truncated last record ends the log, as in the native reader."""
    from lili_om_tpu_torch.runtime import log

    p = str(tmp_path / "t.lom")
    w = log.LogWriter(p)
    for i in range(10):
        w.append(log.KIND_META, np.full(i + 1, i, np.uint8))
    w.close()
    with open(p, "ab") as f:
        f.write(np.array([log.KIND_SCAN, 100], "<u4").tobytes() + b"\x01" * 7)
    r = log.LogReader(p, readahead=2)
    time.sleep(0.05)
    assert r._q.qsize() <= 2
    got = list(r)
    r.close()
    assert [(k, len(v), int(v[0])) for k, v in got] == [(3, i + 1, i) for i in range(10)]
    assert list(r) == []


def test_organize_scan_matches_jax():
    _, scans = _records(seed=1)
    for s in scans:
        for a, b in zip(TD.organize_scan(TD.ScanRecord(*s), R, C),
                        JD.organize_scan(JD.ScanRecord(*s), R, C)):
            np.testing.assert_array_equal(a, b)


@needs_native
def test_record_synthetic_matches_jax(tmp_path):
    """The spinning variant, one sweep and its IMU (the JAX simulator's
    compiles cost ~13 s a call, so one). IMU records agree to the float32
    cast of the simulators' 1e-12 agreement; the returns, lines and times
    are the same; points agree to the float32 simulator's 2e-4 m
    (tests/test_torch_sim.py) but for the rays whose 1-ulp float32 azimuth
    difference (the two grids round differently, tests/test_torch_sim.py)
    meets a surface at grazing incidence: at most 0.1 % of the points, all
    within 1e-3 m."""
    pj, pt = str(tmp_path / "j.lom"), str(tmp_path / "t.lom")
    JD.record_synthetic(pj, n_frames=1)
    TD.record_synthetic(pt, n_frames=1, device="cpu")
    got, want = list(TD.read_dataset(pt)), list(JD.read_dataset(pj))
    assert [type(r).__name__ for r in got] == [type(r).__name__ for r in want]
    assert len(got) == 42  # 41 IMU samples over 0.2 s, one sweep
    for a, b in zip(got, want):
        assert a.stamp == b.stamp
        if isinstance(a, TD.ImuRecord):
            np.testing.assert_allclose(a.acc, b.acc, atol=1e-5)
            np.testing.assert_allclose(a.gyr, b.gyr, atol=1e-6)
            continue
        assert len(a.pts) == len(b.pts) > 0.9 * R * 720
        err = np.abs(a.pts - b.pts).max(axis=1)
        assert err.max() < 1e-3 and (err > 2e-4).mean() < 1e-3
        np.testing.assert_allclose(a.rel_time, b.rel_time, atol=2e-7)
        np.testing.assert_array_equal(a.line, b.line)
        np.testing.assert_allclose(a.refl, b.refl, atol=2e-4)


@needs_native
@pytest.mark.parametrize("writer", ["jax_native", "jax", "port"])
def test_pcd_reads_in_the_other_package(tmp_path, writer):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(257, 3)) * 20
    inten = rng.uniform(0, 255, 257)
    p = str(tmp_path / "m.pcd")
    if writer == "jax_native":
        assert native.pcd_write_native(p, pts, inten)
    else:
        (JP if writer == "jax" else TP).write_pcd(p, pts, inten)
    got = (TP if writer.startswith("jax") else JP).read_pcd(p)
    np.testing.assert_array_equal(got, np.concatenate(
        [pts.astype(np.float32), inten.astype(np.float32)[:, None]], axis=1))
    np.testing.assert_array_equal(TP.read_pcd(p), JP.read_pcd(p))


# ---------------------------------------------------------------------------
# Velodyne packets and ROS bags
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["HDL32E", "VLP16"])
def test_velodyne_codec_matches_jax(model):
    pts, ring = _grid_points(model, n=300, seed=4)
    inten = np.random.default_rng(5).uniform(0, 255, len(pts))
    pkts = TV.encode_packets(pts, ring, inten, model=model)
    np.testing.assert_array_equal(pkts, JV.encode_packets(pts, ring, inten, model=model))
    for a, b in zip(TV.decode_packets(pkts, model), JV.decode_packets(pkts, model)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _same_msg(a, b):
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("compression,topics", [("none", None), ("bz2", None),
                                                ("none", {"/livox/lidar", "/imu/data"})])
def test_read_bag_matches_jax(tmp_path, compression, topics):
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(40, 3)).astype(np.float32) * 10
    vpts, vring = _grid_points(n=60, seed=7)
    msgs = [(0, "/imu/data", "sensor_msgs/Imu",
             _imu_msg(0.05, [0.9, 0.1, 0.3, 0.3], [0.1, 0.2, 0.3], [0.0, 0.1, 9.8])),
            (1, "/points", "sensor_msgs/PointCloud2",
             _pc2_msg(0.1, pts, rng.uniform(0, 100, 40))),
            (2, "/livox/lidar", "livox_ros_driver/CustomMsg",
             _livox_msg(0.2, pts[:12], rng.integers(0, 10 ** 8, 12),
                        rng.integers(0, 255, 12), rng.integers(0, 6, 12))),
            (3, "/velodyne_packets", "velodyne_msgs/VelodyneScan",
             _velodyne_scan_msg(0.3, JV.encode_packets(vpts, vring))),
            (0, "/imu/data", "sensor_msgs/Imu",
             _imu_msg(0.055, [1.0, 0, 0, 0], [0, 0, 0], [0, 0, 9.81])),
            (4, "/unknown", "std_msgs/String", b"\x00" * 8)]
    p = str(tmp_path / "b.bag")
    _write_bag(p, msgs, compression=compression)
    got, want = list(TB.read_bag(p, topics)), list(JB.read_bag(p, topics))
    assert len(got) == len(want) == (5 if topics is None else 3)
    for (ta, ma), (tb, mb) in zip(got, want):
        assert ta == tb
        _same_msg(ma, mb)
    pc2 = [m for _, m in got if isinstance(m, TB.PointCloud2Msg)]
    if pc2:
        np.testing.assert_array_equal(pc2[0].xyz(), pts)


# ---------------------------------------------------------------------------
# the runner and the ingest split (port only)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sim_inputs():
    """7 spinning sweeps (16×360), 7 Horizon sweeps (6 × 400) and the IMU,
    from the port's simulator in float64 (tests/test_pipeline.py's run)."""
    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    imu = simulate_imu(traj, 0.0, (N_SCANS + 2) * PERIOD, rate=200.0, device=CPU)
    spin_pat = spinning_pattern(n_rings=R, n_cols=C, dtype=torch.float64, device=CPU)
    livox_pat = livox_pattern(pts_per_line=LIVOX_PTS, dtype=torch.float64, device=CPU)
    spin, livox = [], []
    for k in range(N_SCANS):
        sc = simulate_scan(world, traj, k * PERIOD, spin_pat, period=PERIOD)
        spin.append((npy(sc.pts).reshape(R, C, 3), npy(sc.valid).reshape(R, C),
                     npy(sc.rel_time).reshape(R, C)))
        sc = simulate_scan(world, traj, k * PERIOD, livox_pat, period=PERIOD)
        livox.append((npy(sc.pts), npy(sc.line).astype(np.int32),
                      np.clip(npy(sc.rel_time), 0, 0.999), npy(sc.reflectivity),
                      npy(sc.valid)))
    return {"imu": (npy(imu.stamps), npy(imu.accs), npy(imu.gyrs)),
            "spin": spin, "livox": livox}


def _outcome(s):
    return {"trajectory": np.asarray(s.trajectory), "kf_stamps": list(s.kf_stamps),
            "fusion": tree_dict(s.fusion_state), "graph": tree_dict(s.graph),
            "dense": [(t, npy(p), npy(q)) for t, p, q in s.dense_trajectory]}


def _assert_equal_outcomes(a, b):
    np.testing.assert_array_equal(a["trajectory"], b["trajectory"])
    assert a["kf_stamps"] == b["kf_stamps"]
    for part in ("fusion", "graph"):
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")
    assert len(a["dense"]) == len(b["dense"])
    for (sa, ta, qa), (sb, tb, qb) in zip(a["dense"], b["dense"]):
        assert sa == sb
        np.testing.assert_array_equal(ta, tb)
        np.testing.assert_array_equal(qa, qb)


@pytest.fixture(scope="module")
def direct_runs(sim_inputs):
    """Direct ``process_scan`` / ``process_scan_livox`` calls, per variant,
    with a map callback every 0.2 s of scan time."""
    out = {}
    for variant in ("spin", "livox"):
        s = tiny_system()
        s.push_imu(*sim_inputs["imu"])
        maps = []
        s.map_callback = lambda m, s=s, maps=maps: maps.append((s.n_frames, m))
        s.map_publish_period = 0.2
        step = s.process_scan if variant == "spin" else s.process_scan_livox
        for k, scan in enumerate(sim_inputs[variant]):
            step(*scan, k * PERIOD)
        out[variant] = (_outcome(s), maps, s)
    return out


@pytest.mark.parametrize("variant", ["spin", "livox"])
@pytest.mark.parametrize("overlap", [False, True])
def test_runner_equals_direct_calls(sim_inputs, direct_runs, variant, overlap):
    """Serial and overlapped runs equal direct calls bit for bit: the
    frontend reads no state the backend writes, and every carried state is
    replaced, not written in place."""
    s = tiny_system()
    runner = PipelineRunner(s, queue_size=16, overlap=overlap, loop_period_s=1e9)
    runner.feed_imu(*sim_inputs["imu"])
    runner.start()
    feed = runner.feed_scan if variant == "spin" else runner.feed_scan_livox
    for k, scan in enumerate(sim_inputs[variant]):
        feed(*scan, k * PERIOD)
    runner.stop(drain=True)
    assert runner.n_processed == N_SCANS and runner.n_dropped == 0
    want = direct_runs[variant][0]
    assert len(want["kf_stamps"]) >= 2
    if overlap:
        assert runner.n_keyframes == len(want["kf_stamps"])
    _assert_equal_outcomes(_outcome(s), want)


def test_map_callback_cadence(direct_runs):
    """``map_callback`` fires every ``map_publish_period`` seconds of scan
    time (the first stamp starts the clock) with the map at the system's
    ``mapping_interval``."""
    _, maps, s = direct_runs["spin"]
    stamps, last, want = [k * PERIOD for k in range(N_SCANS)], None, []
    for k, t in enumerate(stamps):
        if last is None:
            last = t
        elif t - last >= 0.2:
            last = t
            want.append(k + 1)
    assert [n for n, _ in maps] == want and len(want) >= 2
    np.testing.assert_array_equal(maps[-1][1], s.build_global_map(interval=s.mapping_interval))
    assert maps[-1][1].shape[1] == 3 and len(maps[-1][1]) > 100


class _Stub:
    """A stand-in system: counts IMU pushes, and its ``process_scan``,
    ``process_keyframe`` and ``try_loop_closure`` raise where asked."""

    def __init__(self, fail=None, loop_s=0.0):
        self.fail, self.n_imu, self.kf = fail, 0, []
        self.loop_s, self.in_loop, self.loops_done = loop_s, threading.Event(), 0

    def push_imu(self, stamps, accs, gyrs):
        self.n_imu += len(stamps)

    def _maybe_fail(self, where):
        if self.fail == where:
            raise ValueError(f"fault on the {where} worker")

    def process_scan(self, img, valid, rel, stamp, defer_backend=False):
        self._maybe_fail("frontend")
        return (None, "kf") if defer_backend else None

    def process_keyframe(self, fc, stamp):
        self._maybe_fail("backend")
        self.kf.append(stamp)

    def health_check_and_recover(self):
        return False

    def try_loop_closure(self, lock=None):
        self._maybe_fail("loop")
        self.in_loop.set()
        time.sleep(self.loop_s)
        self.loops_done += 1
        return False


def _blank():
    return np.zeros((R, C, 3)), np.zeros((R, C), bool), np.zeros((R, C))


def test_sequencer_gates_on_imu_coverage():
    """A scan reaches the frontend only once IMU samples past its sweep end
    exist (LidarOdometry.cpp:653-655)."""
    runner = PipelineRunner(_Stub(), queue_size=8)
    runner.feed_scan(*_blank(), 1.0)
    assert runner._ready.qsize() == 0  # no IMU yet
    t1 = np.arange(0.9, 1.05, 0.005)  # covers only up to 1.05 < 1.0 + period
    runner.feed_imu(t1, np.zeros((len(t1), 3)), np.zeros((len(t1), 3)))
    assert runner._ready.qsize() == 0
    t2 = np.arange(1.05, 1.25, 0.005)  # past the sweep end
    runner.feed_imu(t2, np.zeros((len(t2), 3)), np.zeros((len(t2), 3)))
    assert runner._ready.qsize() == 1
    # the samples wait in the IMU ring until the frontend drains it
    assert len(runner._imu_ring) == runner.n_imu_ring == len(t1) + len(t2)
    runner._drain_imu_locked()
    assert runner.system.n_imu == len(t1) + len(t2) and len(runner._imu_ring) == 0


def test_bounded_queue_drops_oldest():
    runner = PipelineRunner(_Stub(), queue_size=2)
    stamps = np.arange(0.0, 1.0, 0.005)
    runner.feed_imu(stamps, np.zeros((len(stamps), 3)), np.zeros((len(stamps), 3)))
    for k in range(5):
        runner.feed_scan(*_blank(), 0.1 * k)
    assert runner.n_dropped == 3 and runner._ready.qsize() == 2
    assert [runner._ready.get_nowait()[2] for _ in range(2)] == [0.1 * 3, 0.1 * 4]


def test_flush_releases_gated_scans_in_stamp_order():
    """At the end of a stream, ``flush`` hands on the scans the IMU never
    covered, in stamp order, each once."""
    stub = _Stub()
    runner = PipelineRunner(stub, queue_size=8, loop_period_s=1e9)
    t = np.arange(0.0, 0.25, 0.005)
    runner.feed_imu(t, np.zeros((len(t), 3)), np.zeros((len(t), 3)))
    for stamp in (0.0, 0.1, 0.3, 0.2):
        runner.feed_scan(*_blank(), stamp)
    assert runner._ready.qsize() == 2  # the sweeps up to 0.2 s are covered
    runner.start()
    runner.stop(drain=True)
    assert runner.n_processed == 4 and stub.kf == [0.0, 0.1, 0.2, 0.3]
    runner.feed_imu(np.array([0.9]), np.zeros((1, 3)), np.zeros((1, 3)))
    assert runner._ready.qsize() == 0  # no double delivery


@pytest.mark.parametrize("where", ["frontend", "backend", "loop"])
def test_worker_fault_is_reraised_by_stop(where):
    """The first exception of any worker stops the run and ``stop()``
    raises it, promptly (the JAX loop thread swallows its exceptions)."""
    runner = PipelineRunner(_Stub(fail=where), queue_size=8, loop_period_s=0.01,
                            drop_when_full=False)
    runner.start()
    t = np.arange(0.0, 1.0, 0.005)
    runner.feed_imu(t, np.zeros((len(t), 3)), np.zeros((len(t), 3)))
    for k in range(3):
        runner.feed_scan(*_blank(), 0.1 * k)
    t0 = time.monotonic()
    while runner.error is None and time.monotonic() - t0 < 10:
        time.sleep(0.01)
    t0 = time.monotonic()
    with pytest.raises(ValueError, match=f"fault on the {where} worker"):
        runner.stop(drain=True, timeout=30)
    assert time.monotonic() - t0 < 5
    assert not any(th.is_alive() for th in (runner._front, runner._back, runner._loop_thread))


@pytest.mark.parametrize("timeout", [5.0, 0.1])
def test_stop_waits_for_a_closure_in_flight(timeout):
    """``stop()`` returns once a closure attempt in flight has ended, or,
    past its timeout, raises naming the worker still running."""
    stub = _Stub(loop_s=0.5)
    runner = PipelineRunner(stub, loop_period_s=0.01)
    runner.start()
    assert stub.in_loop.wait(10)
    if timeout > 1.0:
        runner.stop(drain=True, timeout=timeout)
        assert stub.loops_done >= 1 and not runner._loop_thread.is_alive()
    else:
        with pytest.raises(TimeoutError, match="lili-loop-closure"):
            runner.stop(drain=True, timeout=timeout)
        runner._loop_thread.join(10)
        assert stub.loops_done >= 1


def test_backend_health_check_recovers(sim_inputs):
    """A NaN'd fusion state mid-run is re-seeded by the backend worker and
    the run goes on with finite estimates."""
    s = tiny_system()
    runner = PipelineRunner(s, queue_size=16, loop_period_s=1e9)
    runner.feed_imu(*sim_inputs["imu"])
    runner.start()
    scans = sim_inputs["spin"]
    for k in range(4):
        runner.feed_scan(*scans[k], k * PERIOD)
    t0 = time.monotonic()
    while runner.n_keyframes < 2 and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    with runner._sys_lock:
        s.fusion_state = s.fusion_state._replace(t=s.fusion_state.t * float("nan"))
    for k in range(4, N_SCANS):
        runner.feed_scan(*scans[k], k * PERIOD)
    runner.stop(drain=True)
    assert runner.n_recoveries >= 1
    assert bool(torch.isfinite(s.fusion_state.t).all() and torch.isfinite(s.fusion_state.q).all())


class _StubRunner:
    def __init__(self):
        self.calls, self._lock = [], threading.Lock()

    def feed_scan(self, *args):
        with self._lock:
            self.calls.append(("spin",) + args)

    def feed_scan_livox(self, *args):
        with self._lock:
            self.calls.append(("livox",) + args)


@pytest.mark.parametrize("n_hosts,processes", [(1, False), (3, False), (2, True)])
def test_ingest_restores_order(n_hosts, processes):
    """Records decoded by ``io/dataset.py:decode_spin`` on ``n_hosts``
    workers (threads, or spawned processes) reach the runner in feed order,
    equal to an inline decode."""
    _, scans = _records(seed=8)
    recs = [TD.ScanRecord(0.1 * i, *s[1:]) for i, s in enumerate(scans * 3)]
    stub = _StubRunner()
    ing = ShardedIngest(stub, functools.partial(TD.decode_spin, n_rings=R, n_cols=C),
                        n_hosts=n_hosts, processes=processes)
    for r in recs:
        ing.feed_raw(r, r.stamp)
    ing.close()
    assert ing.n_decoded == ing.n_forwarded == len(stub.calls) == len(recs)
    for call, r in zip(stub.calls, recs):
        assert call[0] == "spin" and call[-1] == r.stamp
        for a, b in zip(call[1:4], TD.organize_scan(r, R, C)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("processes", [False, True])
def test_ingest_decode_error_propagates(processes):
    ing = ShardedIngest(_StubRunner(), functools.partial(TD.decode_spin, n_rings=R, n_cols=C),
                        n_hosts=2, processes=processes)
    ing.feed_raw("not a scan record", 0.0)
    with pytest.raises(RuntimeError, match="ingest worker failed") as e:
        ing.close(timeout=60)
    assert isinstance(e.value.__cause__, AttributeError)


# ---------------------------------------------------------------------------
# kernel loading and launch counters under threads
# ---------------------------------------------------------------------------

def test_kernel_load_builds_and_loads_once(monkeypatch, tmp_path):
    """Threads that reach a kernel first together build it once and load it
    once (``build`` is patched: there is no ``nvcc`` here)."""
    calls = {"build": 0, "load": 0}
    lib_path = tmp_path / "libknn.so"

    def fake_build(names, verbose=False):
        calls["build"] += 1
        time.sleep(0.05)  # long enough for every thread to arrive
        lib_path.write_bytes(b"")
        return {}

    def fake_cdll(path):
        calls["load"] += 1
        return ("lib", path)

    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "library_path", lambda name: lib_path)
    monkeypatch.setattr(cuda_build, "build", fake_build)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", fake_cdll)
    barrier, got = threading.Barrier(8), []

    def worker():
        barrier.wait()
        got.append(cuda_build.load("knn"))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == {"build": 1, "load": 1}
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_build_output_is_named_by_process_and_thread(monkeypatch, tmp_path):
    """``build`` compiles into a temporary file named by process and thread,
    then moves it into place (a stand-in ``nvcc`` records its arguments)."""
    import os

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "$@" > "$(dirname "$0")/args"\n'
                    'while [ "$1" != "-o" ]; do shift; done; : > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    idents = []

    def worker():
        idents.append(threading.get_ident())
        cuda_build.build(["segred"])

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    args = (tmp_path / "args").read_text().split()
    tmp = args[args.index("-o") + 1]
    assert tmp.endswith(f".{os.getpid()}-{idents[0]}.tmp")
    out = cuda_build.library_path("segred")
    assert out.parent == tmp_path / "build" and out.exists() and not os.path.exists(tmp)


@pytest.fixture
def fast_switching():
    """Thread switches every microsecond, so a lost update shows."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(prev)


def _run_threads(n, fn):
    barrier = threading.Barrier(n)

    def go():
        barrier.wait()
        fn()

    threads = [threading.Thread(target=go) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)


@pytest.mark.parametrize("mod", [K, SG], ids=["knn", "segred"])
def test_launch_counts_exact_under_threads(mod, fast_switching):
    mod.reset_launch_counts()
    n = 2 * (os.cpu_count() or 4)

    def count():
        for _ in range(2000):
            mod.count_launch("site", 1, 2, 3)

    _run_threads(n, count)
    assert dict(mod.LAUNCHES) == {("site", 1, 2, 3): 2000 * n}
    mod.reset_launch_counts()


def test_imu_buffer_push_and_trim_under_threads(fast_switching):
    """Producers push while the backend trims: no sample is lost and the
    three arrays always change together."""
    s = tiny_system()
    s.push_imu(np.arange(1000) / 1000.0, np.zeros((1000, 3)), np.zeros((1000, 3)))
    n, per, torn = 8, 200, []

    def push():
        for i in range(per):
            s.push_imu(np.array([1e9 + i]), np.ones((1, 3)), np.ones((1, 3)))

    def trim():
        for i in range(1, 1001):
            s._trim_imu(i / 1000.0 - 1e-9)

    def watch():
        for _ in range(2000):
            st, a, g = s.imu_buffer()
            if not len(st) == len(a) == len(g):
                torn.append((len(st), len(a), len(g)))

    workers = [push] * n + [trim, watch]
    _run_threads(len(workers), lambda: workers.pop()())
    st, a, g = s.imu_buffer()
    assert not torn
    assert len(st) == len(a) == len(g) == n * per and st.min() >= 1e9


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

@pytest.fixture
def small_presets(monkeypatch):
    """``load_config`` as the apps call it, every preset at tiny_system's
    caps (the apps run whole presets; the presets' full caps cost seconds a
    scan on one CPU thread)."""
    from lili_om_tpu_torch.utils import config

    real, s = config.load_config, tiny_system()
    caps = {"odometry": s.odo_cfg._asdict(), "fusion": {
        k: v for k, v in s.fusion_cfg._asdict().items()
        if k in ("window", "local_map_width", "kf_surf_cap", "kf_edge_cap", "map_surf_cap",
                 "map_edge_cap", "max_num_iter", "imu_cap")},
        "spin_features": {"surf_cap": s.feat_cfg.surf_cap}}
    monkeypatch.setattr(config, "load_config", lambda preset: real(preset, caps))


def test_run_dataset_records_and_plays(tmp_path, capsys, small_presets):
    from lili_om_tpu_torch.apps import run_dataset

    log, pcd = str(tmp_path / "d.lom"), str(tmp_path / "d.pcd")
    assert run_dataset.main(["record", log, "6", "--cpu"]) == 0
    assert run_dataset.main(["play", log, "--preset", "synthetic", "--cpu", "--map", pcd]) == 0
    out = capsys.readouterr().out
    assert "processed 6 scans" in out
    m = TP.read_pcd(pcd)
    assert m.shape[1] == 3 and len(m) > 1000 and np.isfinite(m).all()


def _sim_bag(path, sim_inputs):
    """Six PointCloud2 sweeps without a ring field and the IMU at 200 Hz,
    written as a ROS1 bag."""
    stamps, accs, gyrs = sim_inputs["imu"]
    msgs = [(0, "/imu/data", "sensor_msgs/Imu", _imu_msg(s, [1.0, 0, 0, 0], g, a))
            for s, a, g in zip(stamps, accs, gyrs) if s < 0.15]
    for k, (img, valid, _) in enumerate(sim_inputs["spin"][:6]):
        pts = img[valid]
        msgs.append((1, "/velodyne_points", "sensor_msgs/PointCloud2",
                     _pc2_msg(k * PERIOD, pts, np.ones(len(pts)))))
        msgs += [(0, "/imu/data", "sensor_msgs/Imu", _imu_msg(s, [1.0, 0, 0, 0], g, a))
                 for s, a, g in zip(stamps, accs, gyrs)
                 if 0.15 + k * PERIOD <= s < 0.25 + k * PERIOD]
    _write_bag(path, msgs)
    return path


def test_run_bag_plays_a_pointcloud2_bag(tmp_path, capsys, sim_inputs, small_presets):
    """Six PointCloud2 sweeps without a ring field (rings from the
    16-line vertical-angle formula), the IMU at 200 Hz, through the
    ingest split and the overlapped runner."""
    from lili_om_tpu_torch.apps import run_bag

    bag, pcd = _sim_bag(str(tmp_path / "s.bag"), sim_inputs), str(tmp_path / "s.pcd")
    assert run_bag.main([bag, "--preset", "synthetic", "--cols", str(C), "--cpu",
                         "--ingest-hosts", "2", "--map", pcd]) == 0
    out = capsys.readouterr().out
    assert out.lstrip().startswith("6 scans,")
    m = TP.read_pcd(pcd)
    assert m.shape[1] == 3 and len(m) > 100 and np.isfinite(m).all()


def test_run_bag_live_viz_and_export(tmp_path, capsys, monkeypatch, sim_inputs, small_presets):
    """``--live-viz`` serves its directory on a free port for the run and
    ``--export-dir`` writes the TUM trajectory, PCD and PLY map and the
    overview PNG after it."""
    import urllib.request

    from lili_om_tpu_torch.apps import run_bag
    from lili_om_tpu_torch.utils import live_viz

    bag = _sim_bag(str(tmp_path / "s.bag"), sim_inputs)
    live, out_dir = tmp_path / "live", tmp_path / "export"
    served = {}
    real_close = live_viz.LiveViewer.close

    def close(self):  # fetch the page while the server still runs
        port = self._httpd.server_address[1]
        served["index"] = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10).read()
        real_close(self)

    monkeypatch.setattr(live_viz.LiveViewer, "close", close)
    assert run_bag.main([bag, "--preset", "synthetic", "--cols", str(C), "--cpu", "--serial",
                         "--live-viz", str(live), "--export-dir", str(out_dir)]) == 0
    out = capsys.readouterr().out
    assert "live viewer: http://localhost:" in out and b"lili_om_tpu_torch" in served["index"]
    assert (live / "index.html").exists() and out.count("exported ") == 4
    for name in ("trajectory_kf.tum", "global_map.pcd", "global_map.ply", "overview.png"):
        assert (out_dir / name).stat().st_size > 0, name


class _RunnerMode(Exception):
    pass


@pytest.mark.parametrize("device,flags,overlap", [
    ("cuda", [], False), ("cuda", ["--serial"], False), ("cpu", [], True),
    ("cpu", ["--serial"], False)])
def test_run_bag_runner_mode(monkeypatch, device, flags, overlap):
    """``run_bag`` runs the runner serially on the card, and overlapped on
    the CPU unless ``--serial`` is given (a stand-in system on the given
    device and a stand-in runner that records its mode)."""
    from lili_om_tpu_torch.apps import run_bag
    from lili_om_tpu_torch.models import system
    from lili_om_tpu_torch.runtime import pipeline

    class System:
        def __init__(self, *args, **kwargs):
            self.device = torch.device(device)

    class Runner:
        def __init__(self, system, overlap, **kwargs):
            raise _RunnerMode(overlap)

    monkeypatch.setattr(system, "LiliOmSystem", System)
    monkeypatch.setattr(pipeline, "PipelineRunner", Runner)
    with pytest.raises(_RunnerMode) as e:
        run_bag.main(["missing.bag", "--preset", "synthetic"] + flags)
    assert e.value.args == (overlap,)
