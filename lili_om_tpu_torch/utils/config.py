"""Dataset presets of the port (a copy of the sections of
``lili_om_tpu/utils/config.py`` that the per-scan loop needs; the tests hold
the copy against the JAX package's presets).

Only ``fr_iosb_rot`` — the spinning 64-line FR_IOSB configuration
(LiLi-OM-ROT/config/config_fr_iosb.yaml) that ``bench.py`` runs — is ported
so far; the loop-closure section waits for its slice.
"""
from __future__ import annotations

import dataclasses

from ..models.fusion import FusionConfig
from ..models.odometry import OdometryConfig
from ..ops.features_spin import SpinFeatureConfig
from ..ops.preintegration import ImuNoise


@dataclasses.dataclass
class SystemConfig:
    variant: str = "livox"  # "livox" | "rot"
    odometry: OdometryConfig = OdometryConfig()
    fusion: FusionConfig = FusionConfig()
    spin_features: SpinFeatureConfig = SpinFeatureConfig()
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
