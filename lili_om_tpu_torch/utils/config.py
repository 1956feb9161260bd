"""Dataset presets of the port: a copy of ``lili_om_tpu/utils/config.py``,
every preset field for field (the tests hold the copy against the JAX
package's presets). Each preset bundles the stage configs of one dataset's
YAML of the reference; ``load_config`` takes per-section overrides, and
unknown keys fall back to the defaults with a warning, as the reference's
``getParameter`` does.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from typing import Any, Optional

from ..models.fusion import FusionConfig
from ..models.odometry import OdometryConfig
from ..ops.features_livox import LivoxFeatureConfig
from ..ops.features_spin import SpinFeatureConfig
from ..ops.preintegration import ImuNoise


@dataclasses.dataclass
class LoopClosureConfig:
    """Loop-closure knobs, field for field as the JAX package's
    ``LoopClosureConfig`` (``lili_om_tpu/models/system.py``)."""

    enabled: bool = True
    search_radius: float = 10.0  # lc_search_radius
    time_thres: float = 25.0  # global_lc_time_thres (ROT: lc_time_thres)
    # Livox fallback tier: with no candidate older than ``time_thres``, the
    # max-|Δt| candidate with local_time_thres < Δt < time_thres; None
    # disables it (the ROT variant has the global gate only)
    local_time_thres: float | None = None
    map_width: int = 20  # ± keyframes in the history submap
    latest_width: int = 1  # keyframes in the latest submap (6 for ROT)
    icp_thres: float = 0.1  # fitness gate
    icp_iters: int = 20
    # fitness over the best ``icp_trim`` share of the 1-NN matches; 1.0 is
    # PCL's untrimmed getFitnessScore, the reference's form
    icp_trim: float = 0.7
    submap_cap: int = 16384
    submap_leaf: float = 0.4
    # re-fire gate: skip while |stamp of the last closure's mature keyframe
    # − newest keyframe stamp| < debounce
    debounce: float = 0.2
    # a closure whose endpoints both lie within ``merge_width`` keyframes
    # of an existing loop factor replaces it; 0 disables merging
    merge_width: int = 10
    # largest ICP-implied correction of the mature pose accepted: None =
    # 2·search_radius, 0.0 disables the gate
    max_correction: float | None = None
    # global solve budget: GN iterations, step-norm early exit, and the
    # affected-suffix restriction (False: the whole graph)
    graph_iters: int = 10
    graph_tol: float = 1e-3
    graph_suffix: bool = True


@dataclasses.dataclass
class SystemConfig:
    variant: str = "livox"  # "livox" | "rot"
    odometry: OdometryConfig = OdometryConfig()
    fusion: FusionConfig = FusionConfig()
    spin_features: SpinFeatureConfig = SpinFeatureConfig()
    livox_features: LivoxFeatureConfig = LivoxFeatureConfig()
    loop_closure: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    imu_noise: ImuNoise = ImuNoise()
    imu_rate: float = 200.0
    scan_period: float = 0.1
    if_to_deskew: bool = False
    mapping_interval: int = 2


def _merge_namedtuple(base, overrides: dict, ctx: str):
    bad = set(overrides) - set(base._fields)
    if bad:
        warnings.warn(f"{ctx}: unknown keys {sorted(bad)} ignored (defaulting, "
                      "as the reference's getParameter does)")
    return base._replace(**{k: v for k, v in overrides.items() if k in base._fields})


def load_config(preset: str = "fr_iosb", overrides: Optional[dict] = None) -> SystemConfig:
    """Preset ``preset`` with ``overrides`` ({section: {field: value}} for
    the config sections, {field: value} for a plain field) applied."""
    cfg = PRESETS[preset]()
    if overrides:
        for section, vals in overrides.items():
            cur = getattr(cfg, section)
            if hasattr(cur, "_fields"):
                setattr(cfg, section, _merge_namedtuple(cur, vals, section))
            elif dataclasses.is_dataclass(cur):
                for k, v in vals.items():
                    if hasattr(cur, k):
                        setattr(cur, k, v)
                    else:
                        warnings.warn(f"{section}: unknown key {k} ignored")
            else:
                setattr(cfg, section, vals)
    return cfg


def config_fr_iosb() -> SystemConfig:
    """Livox FR_IOSB (LiLi-OM/config/config_fr_iosb.yaml)."""
    return SystemConfig(
        variant="livox",
        odometry=OdometryConfig(scan_match_cnt=1, gn_iters=15),  # yaml:9-10
        fusion=FusionConfig(
            window=3, local_map_width=40, lidar_const=20.0, reflect_thres=15.0,
            max_num_iter=15,  # yaml:15
            surf_dist_thres=0.12, kd_max_radius=1.0, surf_leaf=0.4, edge_leaf=0.2,
            use_reflectivity=True, weight_gate=0.2,
            q_lb=(0.0, 0.0, 0.0, 1.0), t_lb=(-0.0265, 0.0202, 0.05309),  # yaml:34-41
        ),
        livox_features=LivoxFeatureConfig(surf_thres=0.28, edge_thres=4.0),  # yaml:5-6
        loop_closure=LoopClosureConfig(
            enabled=True, time_thres=25.0, local_time_thres=25.0,  # yaml:25-26
            search_radius=10.0, map_width=20, latest_width=1, icp_thres=0.1,
            icp_iters=100, icp_trim=1.0),
        imu_noise=ImuNoise(),  # the Livox densities hardcoded in the reference
        mapping_interval=7,  # yaml:30
    )


def config_fr_iosb_rot() -> SystemConfig:
    """Spinning 64-line FR_IOSB (LiLi-OM-ROT/config/config_fr_iosb.yaml)."""
    return SystemConfig(
        variant="rot",
        odometry=OdometryConfig(scan_match_cnt=1, gn_iters=12),  # yaml:17
        fusion=FusionConfig(
            window=3, local_map_width=50, lidar_const=7.5,
            max_num_iter=15,  # yaml:22
            surf_dist_thres=0.12, kd_max_radius=1.0,
            surf_leaf=0.4, edge_leaf=0.2,
            use_reflectivity=False, weight_gate=0.3,
            q_lb=(0.7071, 0.0, 0.0, 0.7071), t_lb=(-0.18, 0.0, -0.095),
            sb_weights=(8.0, 8.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0),
        ),
        spin_features=SpinFeatureConfig(ds_rate=4),  # yaml:13
        loop_closure=LoopClosureConfig(
            enabled=True, time_thres=60.0, search_radius=15.0,  # yaml:32
            map_width=25, latest_width=6, icp_thres=0.2, debounce=0.2,
            icp_iters=100, icp_trim=1.0),  # ROT: single time gate
        imu_noise=ImuNoise(acc_n=2000.0, gyr_n=0.0173, acc_w=2.0,
                           gyr_w=0.00025, init_cov=1e-3),  # yaml:5-9
        mapping_interval=2,  # yaml:31
    )


def config_synthetic() -> SystemConfig:
    """Simulation-friendly preset (smaller capacities, ROT wiring)."""
    return SystemConfig(
        variant="rot",
        odometry=OdometryConfig(n_recent_frames=10, scan_cap=4096, query_cap=1024,
                                map_cap=16384),
        fusion=FusionConfig(
            window=3, local_map_width=10, kf_surf_cap=4096, kf_edge_cap=1024,
            map_surf_cap=16384, map_edge_cap=2048, use_reflectivity=False,
            weight_gate=0.3, lidar_const=7.5, max_num_iter=6),
        spin_features=SpinFeatureConfig(surf_cap=4096),
        loop_closure=LoopClosureConfig(enabled=True, time_thres=10.0),
    )


def _livox_variant(base: SystemConfig, **fusion_over) -> SystemConfig:
    base.fusion = base.fusion._replace(**fusion_over)
    return base


def config_fr_iosb_internal_imu() -> SystemConfig:
    """Livox internal-IMU mode (config_fr_iosb_internal_imu.yaml): identity
    rotation extrinsic, shifted lever arm; pair with
    ``io.livox.convert_internal_imu``."""
    return _livox_variant(config_fr_iosb(), q_lb=(1.0, 0.0, 0.0, 0.0),
                          t_lb=(-0.05512, -0.02226, 0.02970))


def config_fr_iosb_tree() -> SystemConfig:
    c = _livox_variant(config_fr_iosb(), local_map_width=30, lidar_const=15.0)
    c.loop_closure.time_thres = 40.0
    c.loop_closure.local_time_thres = 40.0  # config_fr_iosb_tree.yaml:26
    c.loop_closure.icp_thres = 0.15
    c.mapping_interval = 3  # yaml:30
    return c


def config_ka_urban_campus() -> SystemConfig:
    c = _livox_variant(config_fr_iosb(), lidar_const=15.0, surf_dist_thres=0.08,
                       max_num_iter=20,  # yaml:15
                       q_lb=(0.0, 0.0, 1.0, 0.0), t_lb=(-0.05, -0.0202, -0.13))
    c.livox_features = c.livox_features._replace(surf_thres=0.17)
    c.odometry = c.odometry._replace(scan_match_cnt=2)
    c.loop_closure.time_thres = 60.0
    c.loop_closure.local_time_thres = 60.0  # config_ka_urban_campus.yaml:29
    c.mapping_interval = 5  # yaml:30
    return c


def config_ka_urban_east() -> SystemConfig:
    c = _livox_variant(config_fr_iosb(), lidar_const=15.0, surf_dist_thres=0.08,
                       max_num_iter=20)  # yaml:15
    c.livox_features = c.livox_features._replace(surf_thres=0.16)
    c.loop_closure.time_thres = 60.0
    c.loop_closure.local_time_thres = 60.0  # config_ka_urban_east.yaml:29
    c.loop_closure.search_radius = 20.0
    c.loop_closure.icp_thres = 0.15
    c.mapping_interval = 25  # yaml:30
    return c


def config_ka_urban_schloss_1() -> SystemConfig:
    c = _livox_variant(config_fr_iosb(), local_map_width=30, lidar_const=15.0,
                       surf_dist_thres=0.03)
    c.livox_features = c.livox_features._replace(surf_thres=0.15)
    c.odometry = c.odometry._replace(scan_match_cnt=2)
    c.loop_closure.time_thres = 60.0
    c.loop_closure.local_time_thres = 60.0  # config_ka_urban_schloss_1.yaml:29
    c.loop_closure.search_radius = 7.0
    c.loop_closure.icp_thres = 0.15
    c.mapping_interval = 3  # yaml:30
    return c


def config_ka_urban_schloss_2() -> SystemConfig:
    c = _livox_variant(config_fr_iosb(), lidar_const=25.0, surf_dist_thres=0.08)
    c.livox_features = c.livox_features._replace(surf_thres=0.25, edge_thres=3.0)
    c.loop_closure.time_thres = 60.0
    c.loop_closure.local_time_thres = 60.0  # config_ka_urban_schloss_2.yaml:29
    c.loop_closure.search_radius = 7.0
    c.loop_closure.icp_thres = 0.15
    c.mapping_interval = 10  # yaml:30
    return c


def config_urban_hk_rot() -> SystemConfig:
    """ROT 32-line UrbanLoco HK (LiLi-OM-ROT config_urban_hk.yaml)."""
    c = config_fr_iosb_rot()
    c.spin_features = c.spin_features._replace(ds_rate=2)
    c.loop_closure.search_radius = 25.0
    c.loop_closure.time_thres = 120.0
    c.mapping_interval = 3  # ROT yaml:31
    return c


def config_utbm_rot() -> SystemConfig:
    """ROT 32-line UTBM (LiLi-OM-ROT config_utbm.yaml)."""
    c = config_fr_iosb_rot()
    c.spin_features = c.spin_features._replace(ds_rate=2)
    c.fusion = c.fusion._replace(kd_max_radius=1.5)
    c.imu_noise = ImuNoise(acc_n=18.0, gyr_n=0.0173, acc_w=0.5, gyr_w=0.00025,
                           init_cov=1e-3)
    c.loop_closure.search_radius = 25.0
    c.loop_closure.time_thres = 120.0
    c.mapping_interval = 4  # ROT yaml:31
    return c


PRESETS = {
    "fr_iosb": config_fr_iosb,
    "fr_iosb_internal_imu": config_fr_iosb_internal_imu,
    "fr_iosb_tree": config_fr_iosb_tree,
    "ka_urban_campus": config_ka_urban_campus,
    "ka_urban_east": config_ka_urban_east,
    "ka_urban_schloss_1": config_ka_urban_schloss_1,
    "ka_urban_schloss_2": config_ka_urban_schloss_2,
    "fr_iosb_rot": config_fr_iosb_rot,
    "urban_hk_rot": config_urban_hk_rot,
    "utbm_rot": config_utbm_rot,
    "synthetic": config_synthetic,
}


def dump_config(cfg: SystemConfig) -> str:
    """JSON dump (diagnostics, reproducibility): the same text as the JAX
    package's ``dump_config`` for the same preset."""

    def enc(o: Any):
        if hasattr(o, "_asdict"):
            return o._asdict()
        if dataclasses.is_dataclass(o):
            return dataclasses.asdict(o)
        return str(o)

    return json.dumps(dataclasses.asdict(cfg), default=enc, indent=2)
