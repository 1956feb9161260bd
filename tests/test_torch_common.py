"""Shared helpers of the PyTorch-port parity tests (this module holds no
tests). Inputs are made with numpy or by the port's simulator (held against
the JAX one by test_torch_sim.py); the same arrays go through a JAX
function and its port on the CPU."""
import numpy as np
import torch

# six xdist workers share the machine with the JAX tests, some of which
# time phases of their own: one intra-op thread per worker
torch.set_num_threads(1)

CPU = "cpu"

# the small caps of tests/test_split.py
R, C, IMU_CAP = 16, 720, 64


def tt(a, dtype=torch.float64):
    """numpy/JAX array → CPU tensor (floats cast to ``dtype``)."""
    a = np.asarray(a)
    if a.dtype == np.bool_ or np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a)
    return torch.as_tensor(a).to(dtype)


def npy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def tree_dict(nt, prefix=""):
    """NamedTuple (JAX or torch, possibly nested) → {dotted field: numpy}."""
    out = {}
    for name, val in nt._asdict().items():
        if hasattr(val, "_fields"):
            out.update(tree_dict(val, prefix=f"{prefix}{name}."))
        elif val is not None:
            out[prefix + name] = npy(val)
    return out


def state_dict(state):
    """A carried state as {dotted field: numpy}, with the marginal prior's
    square-root pair (J, r0) replaced by JᵀJ and Jᵀr0: the eigenvectors of
    the Schur complement are defined up to sign (and up to rotation inside
    a repeated eigenvalue), so only these products are unique."""
    d = tree_dict(state)
    if "prior.J" in d:
        J, r0 = d.pop("prior.J"), d.pop("prior.r0")
        d["prior.JtJ"] = J.T @ J
        d["prior.Jtr0"] = J.T @ r0
    return d


def assert_close_dicts(da, db, rtol, atol, what=""):
    """Field-by-field: integers and booleans exactly, floats to tolerance."""
    assert set(da) == set(db), set(da) ^ set(db)
    for k in sorted(da):
        x, y = da[k], db[k]
        assert x.shape == y.shape, (what, k, x.shape, y.shape)
        if x.dtype == np.bool_ or np.issubdtype(x.dtype, np.integer):
            np.testing.assert_array_equal(y, x, err_msg=f"{what} {k}")
        else:
            np.testing.assert_allclose(np.asarray(y, np.float64), np.asarray(x, np.float64),
                                       rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def port_sim_frames(n, rings=R, cols=C, imu_cap=IMU_CAP):
    """``n`` scans + padded IMU intervals from the port's simulator, as numpy
    float64 arrays keyed by input name: what ``bench.py`` feeds its frame
    loop, at test size (the port's simulator runs without compiles)."""
    from lili_om_tpu_torch.frame import sim_scans

    scans, traj = sim_scans(n, rings=rings, cols=cols, imu_cap=imu_cap,
                            dtype=torch.float64, device=CPU)
    return [dict(img=npy(s.img), valid=npy(s.valid), rel=npy(s.rel_time), dts=npy(s.imu_dts),
                 accs=npy(s.imu_accs), gyrs=npy(s.imu_gyrs), vm=npy(s.imu_valid))
            for s in scans], traj


def small_configs():
    """(JAX configs, port configs) of the frame loop at the caps of
    tests/test_split.py, wired like the fr_iosb_rot preset."""
    from lili_om_tpu.models.fusion import FusionConfig as JF
    from lili_om_tpu.models.odometry import OdometryConfig as JO
    from lili_om_tpu.ops.features_spin import SpinFeatureConfig as JS
    from lili_om_tpu.utils.config import load_config
    from lili_om_tpu_torch.models.fusion import FusionConfig as TF
    from lili_om_tpu_torch.models.odometry import OdometryConfig as TO
    from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig as TS
    from lili_om_tpu_torch.ops.preintegration import ImuNoise as TN

    rot = load_config("fr_iosb_rot")
    js = JS(surf_cap=2048)
    jo = rot.odometry._replace(scan_cap=2048, query_cap=1024, map_cap=8192,
                               frame_cap=1024, n_recent_frames=6)
    jf = rot.fusion._replace(local_map_width=6, kf_surf_cap=2048, kf_edge_cap=1024,
                             map_surf_cap=8192, map_edge_cap=2048, max_num_iter=4,
                             imu_cap=IMU_CAP)
    jn = rot.imu_noise
    port = (TS(**js._asdict()), TO(**jo._asdict()), TF(**jf._asdict()), TN(**jn._asdict()))
    assert isinstance(jo, JO) and isinstance(jf, JF)
    return (js, jo, jf, jn), port


def tiny_system():
    """tests/test_pipeline.py's ``tiny_system`` (16×360 sweeps, caps ≤ 2048,
    float64), the port's side, on the CPU; its loop closure runs detection
    but never fires (``time_thres`` 1e9)."""
    from lili_om_tpu_torch.models.fusion import FusionConfig
    from lili_om_tpu_torch.models.odometry import OdometryConfig
    from lili_om_tpu_torch.models.system import LiliOmSystem
    from lili_om_tpu_torch.ops.features_livox import LivoxFeatureConfig
    from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig
    from lili_om_tpu_torch.utils.config import LoopClosureConfig

    return LiliOmSystem(
        odo_cfg=OdometryConfig(n_recent_frames=4, scan_cap=1024, query_cap=256, map_cap=2048),
        fusion_cfg=FusionConfig(window=3, local_map_width=4, kf_surf_cap=1024,
                                kf_edge_cap=256, map_surf_cap=2048, map_edge_cap=512,
                                use_reflectivity=False, max_num_iter=2, imu_cap=32),
        feat_cfg=SpinFeatureConfig(surf_cap=1024), livox_cfg=LivoxFeatureConfig(n_cols=400),
        lc_cfg=LoopClosureConfig(enabled=True, time_thres=1e9), graph_capacity=32,
        dtype=torch.float64, device=CPU)


# tiny_system's configuration, on the JAX side
J_ODO = dict(n_recent_frames=4, scan_cap=1024, query_cap=256, map_cap=2048)
J_FUS = dict(window=3, local_map_width=4, kf_surf_cap=1024, kf_edge_cap=256, map_surf_cap=2048,
             map_edge_cap=512, use_reflectivity=False, max_num_iter=2, imu_cap=32)


def jax_tiny_system():
    """tests/test_pipeline.py's ``tiny_system``, its loop closure never
    firing (constructing it compiles nothing)."""
    import jax.numpy as jnp

    from lili_om_tpu.models import fusion as jfus
    from lili_om_tpu.models import odometry as jodo
    from lili_om_tpu.models.system import LiliOmSystem as JSystem
    from lili_om_tpu.models.system import LoopClosureConfig as JLC
    from lili_om_tpu.ops.features_livox import LivoxFeatureConfig as JLivox
    from lili_om_tpu.ops.features_spin import SpinFeatureConfig as JS

    return JSystem(
        odo_cfg=jodo.OdometryConfig(**J_ODO), fusion_cfg=jfus.FusionConfig(**J_FUS),
        feat_cfg=JS(surf_cap=1024), livox_cfg=JLivox(n_cols=400),
        lc_cfg=JLC(enabled=True, time_thres=1e9), graph_capacity=32, dtype=jnp.float64)


def tiny_run(n_scans, rings=16, cols=360, period=0.1):
    """``tiny_system`` after ``n_scans`` sweeps of the port's simulator
    (float64, a circle in the room world, the IMU pushed up front)."""
    from lili_om_tpu_torch.sim.lidar import simulate_scan, spinning_pattern
    from lili_om_tpu_torch.sim.trajectory import circle_trajectory, simulate_imu
    from lili_om_tpu_torch.sim.world import make_room_world

    world = make_room_world(dtype=torch.float64, device=CPU)
    traj = circle_trajectory(radius=8.0, period=40.0)
    pattern = spinning_pattern(n_rings=rings, n_cols=cols, dtype=torch.float64, device=CPU)
    imu = simulate_imu(traj, 0.0, (n_scans + 1) * period, rate=200.0, device=CPU)
    s = tiny_system()
    s.push_imu(npy(imu.stamps), npy(imu.accs), npy(imu.gyrs))
    for k in range(n_scans):
        sc = simulate_scan(world, traj, k * period, pattern, period=period)
        s.process_scan(npy(sc.pts).reshape(rings, cols, 3), npy(sc.valid).reshape(rings, cols),
                       npy(sc.rel_time).reshape(rings, cols), k * period)
    return s


def port_sim_for_jax(monkeypatch, modules):
    """Serve JAX simulator calls with the port's simulator, numpy out, so
    both packages see bit-identical scans and IMU samples (the JAX one
    evaluates its trajectory op by op, ~0.3 s a pose on the CPU).
    ``modules``: where the JAX caller finds each name (the world, the
    trajectory and the lidar modules of ``lili_om_tpu.sim``, or a module
    that imported the names itself)."""
    import lili_om_tpu_torch.sim.lidar as TL
    import lili_om_tpu_torch.sim.trajectory as TT
    import lili_om_tpu_torch.sim.world as TW

    def host_tuple(nt):
        return type(nt)(*[npy(x) for x in nt])

    serve = {"make_room_world": lambda: TW.make_room_world(device=CPU),
             "circle_trajectory": lambda *a, **k: TT.circle_trajectory(*a, **k),
             "pose_at": lambda traj, t: tuple(npy(x) for x in TT.pose_at(traj, t)),
             "simulate_imu": lambda *a, **k: host_tuple(TT.simulate_imu(*a, **k)),
             "spinning_pattern": lambda **k: TL.spinning_pattern(**k, device=CPU),
             "simulate_scan": lambda *a, **k: host_tuple(TL.simulate_scan(*a, **k))}
    for mod in modules:
        for name, fn in serve.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, fn)

