"""The port's copies of the config NamedTuples and of every preset against
the JAX package's: same fields, same defaults, same values."""
import dataclasses

import pytest

from lili_om_tpu.models import fusion as JFu
from lili_om_tpu.models import odometry as JO
from lili_om_tpu.models import system as JSy
from lili_om_tpu.ops import features_livox as JL
from lili_om_tpu.ops import features_spin as JS
from lili_om_tpu.ops import preintegration as JP
from lili_om_tpu.utils import config as JC
from lili_om_tpu_torch.frame import bench_configs
from lili_om_tpu_torch.models import fusion as TFu
from lili_om_tpu_torch.models import odometry as TO
from lili_om_tpu_torch.ops import features_livox as TL
from lili_om_tpu_torch.ops import features_spin as TS
from lili_om_tpu_torch.ops import preintegration as TP
from lili_om_tpu_torch.utils import config as TC

PAIRS = {
    "OdometryConfig": (JO.OdometryConfig, TO.OdometryConfig),
    "FusionConfig": (JFu.FusionConfig, TFu.FusionConfig),
    "SpinFeatureConfig": (JS.SpinFeatureConfig, TS.SpinFeatureConfig),
    "LivoxFeatureConfig": (JL.LivoxFeatureConfig, TL.LivoxFeatureConfig),
    "ImuNoise": (JP.ImuNoise, TP.ImuNoise),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_fields_and_defaults(name):
    j, t = PAIRS[name]
    assert j._fields == t._fields
    assert j()._asdict() == t()._asdict()


@pytest.mark.parametrize("section", ["odometry", "fusion", "spin_features", "imu_noise"])
def test_fr_iosb_rot_sections(section):
    j = getattr(JC.load_config("fr_iosb_rot"), section)
    t = getattr(TC.load_config("fr_iosb_rot"), section)
    assert j._asdict() == t._asdict()


def test_fr_iosb_rot_scalars():
    """Every plain field the port's SystemConfig keeps equals the JAX one."""
    j, t = JC.load_config("fr_iosb_rot"), TC.load_config("fr_iosb_rot")
    for f in dataclasses.fields(t):
        v = getattr(t, f.name)
        if not hasattr(v, "_fields") and not dataclasses.is_dataclass(v):
            assert v == getattr(j, f.name), f.name


def test_loop_closure_config_fields_and_defaults():
    j, t = JSy.LoopClosureConfig, TC.LoopClosureConfig
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_fr_iosb_rot_loop_closure_section():
    j = JC.load_config("fr_iosb_rot").loop_closure
    t = TC.load_config("fr_iosb_rot").loop_closure
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (t.submap_cap, t.submap_leaf, t.map_width, t.latest_width, t.icp_iters) == \
        (16384, 0.4, 25, 6, 100)


def test_bench_configs_match_bench_py():
    """``Frame``'s default configs are the ones bench.py runs: the preset
    with fusion capped at 15 iterations and 32 IMU samples."""
    rot = JC.load_config("fr_iosb_rot")
    feats, odo, fus, noise = bench_configs()
    assert feats._asdict() == rot.spin_features._asdict()
    assert odo._asdict() == rot.odometry._asdict()
    assert fus._asdict() == rot.fusion._replace(max_num_iter=15, imu_cap=32)._asdict()
    assert noise._asdict() == rot.imu_noise._asdict()
    assert (odo.query_cap, odo.map_cap, odo.scan_match_cnt, odo.gn_iters) == (4096, 32768, 1, 12)
    assert (fus.window, fus.local_map_width) == (3, 50)


def test_unported_preset_raises():
    """A name that is no preset raises, as in the JAX package."""
    for load in (JC.load_config, TC.load_config):
        with pytest.raises(KeyError):
            load("no_such_preset")


def _as_dict(cfg):
    """A SystemConfig as {field: plain value}, its sections as dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (v._asdict() if hasattr(v, "_fields")
                       else dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v)
    return out


@pytest.mark.parametrize("preset", sorted(JC.PRESETS))
def test_every_preset_field_for_field(preset):
    assert sorted(TC.PRESETS) == sorted(JC.PRESETS)
    assert _as_dict(TC.load_config(preset)) == _as_dict(JC.load_config(preset))


def test_default_preset_and_overrides():
    """``load_config()`` is the Livox ``fr_iosb`` preset, as in the JAX
    package; overrides replace section fields and plain fields, and an
    unknown key warns and is ignored on both sides."""
    assert TC.load_config().variant == JC.load_config().variant == "livox"
    over = {"fusion": {"local_map_width": 12, "bogus": 1},
            "loop_closure": {"enabled": False, "bogus": 2},
            "livox_features": {"n_cols": 680}, "mapping_interval": 3}
    with pytest.warns(UserWarning):
        j = JC.load_config("fr_iosb", {k: dict(v) if isinstance(v, dict) else v
                                       for k, v in over.items()})
    with pytest.warns(UserWarning):
        t = TC.load_config("fr_iosb", over)
    assert _as_dict(t) == _as_dict(j)
    assert (t.fusion.local_map_width, t.livox_features.n_cols, t.loop_closure.enabled,
            t.mapping_interval) == (12, 680, False, 3)
