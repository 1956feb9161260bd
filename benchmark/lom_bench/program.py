"""The system under test: ``lili_om_tpu_torch``'s ``LiliOmSystem``, built
from a configuration file and driven the way a log is replayed through it
(``apps/run_dataset.py``, ``apps/evaluate_presets.py``). The only module
of the benchmark that imports the program."""
from __future__ import annotations

import dataclasses

import torch


def _tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def build_system(cfg: dict, traffic: dict, device):
    """A fresh ``LiliOmSystem`` of configuration ``cfg`` (its stage configs
    field for field), with the traffic's loop time gate where it sets one."""
    from lili_om_tpu_torch.models.fusion import FusionConfig
    from lili_om_tpu_torch.models.odometry import OdometryConfig
    from lili_om_tpu_torch.models.system import LiliOmSystem
    from lili_om_tpu_torch.ops.features_livox import LivoxFeatureConfig
    from lili_om_tpu_torch.ops.features_spin import SpinFeatureConfig
    from lili_om_tpu_torch.ops.preintegration import ImuNoise
    from lili_om_tpu_torch.utils.config import LoopClosureConfig

    lc = LoopClosureConfig(**cfg["loop_closure"])
    if traffic.get("time_thres_s") is not None:
        lc = dataclasses.replace(lc, time_thres=traffic["time_thres_s"])
    sys_ = LiliOmSystem(OdometryConfig(**_tuples(cfg["odometry"])),
                        FusionConfig(**_tuples(cfg["fusion"])),
                        SpinFeatureConfig(**_tuples(cfg["spin_features"])),
                        LivoxFeatureConfig(**_tuples(cfg["livox_features"])),
                        lc, ImuNoise(**_tuples(cfg["imu_noise"])), dtype=torch.float32,
                        device=device)
    sys_.scan_period = cfg["scan_period"]
    sys_.deskew_translation = cfg["deskew_translation"]
    sys_.if_to_deskew = cfg["if_to_deskew"]
    return sys_


def process(sys_, cfg: dict, scan, stamp: float):
    """One sweep through the entry of the configuration's sensor."""
    if cfg["sensor"]["kind"] == "livox":
        return sys_.process_scan_livox(*scan, stamp)
    return sys_.process_scan(*scan, stamp)


def system_module():
    """The module whose stage functions :class:`lom_bench.capture.Capture`
    wraps."""
    import lili_om_tpu_torch.models.system as m

    return m


def prepare_kernels():
    """Build every kernel library of the program now, in parallel, where the
    program offers it (the window's first calls would build them one by
    one)."""
    from lili_om_tpu_torch import cuda_build

    cuda_build.build()


def graph_module():
    """The pose-graph module whose Gauss-Newton step the check reads."""
    import lili_om_tpu_torch.models.pose_graph as m

    return m
