"""Dataset presets of the port (a copy of the sections of
``lili_om_tpu/utils/config.py`` that the per-scan loop needs; the tests hold
the copy against the JAX package's presets).

Only ``fr_iosb_rot`` — the spinning 64-line FR_IOSB configuration
(LiLi-OM-ROT/config/config_fr_iosb.yaml) that ``bench.py`` runs — is ported
so far, with its loop-closure section.
"""
from __future__ import annotations

import dataclasses

from ..models.fusion import FusionConfig
from ..models.odometry import OdometryConfig
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
    loop_closure: LoopClosureConfig = dataclasses.field(default_factory=LoopClosureConfig)
    imu_noise: ImuNoise = ImuNoise()
    imu_rate: float = 200.0
    scan_period: float = 0.1
    if_to_deskew: bool = False
    mapping_interval: int = 2


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


PRESETS = {"fr_iosb_rot": config_fr_iosb_rot}


def load_config(preset: str = "fr_iosb_rot") -> SystemConfig:
    try:
        return PRESETS[preset]()
    except KeyError:
        raise NotImplementedError(
            f"preset {preset!r} is not ported yet (ported: {sorted(PRESETS)})") from None
