"""The port stands alone: no module of ``lili_om_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package, the package imports
with ``jax`` made unimportable (also in a ``spawn``ed child, as the ingest
workers start, which must not initialize CUDA), its native runtime loads
the port's own library and nothing under ``native/``, and its entry points
refuse to drop to the CPU on their own."""
import ast
import multiprocessing as mp
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "lili_om_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "lili_om_tpu")


def _imports(path: Path):
    """Absolute module names a file imports (relative imports stay inside
    the package and are resolved against it)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_forbidden_matches_the_package_not_the_port():
    assert _forbidden("lili_om_tpu") and _forbidden("lili_om_tpu.ops.knn")
    assert _forbidden("jax.numpy")
    assert not _forbidden("lili_om_tpu_torch") and not _forbidden("lili_om_tpu_torch.ops")


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_imports_without_jax():
    """``import`` every module of the port with ``jax`` and the JAX package
    made unimportable."""
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                   for p in PORT.rglob("*.py")})
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'lili_om_tpu'): sys.modules[m] = None\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


# the modules a spawned ingest worker or a user of the runtime imports
RUNTIME_MODULES = ["lili_om_tpu_torch.apps.run_bag", "lili_om_tpu_torch.apps.run_dataset",
                   "lili_om_tpu_torch.io.checkpoint", "lili_om_tpu_torch.io.dataset",
                   "lili_om_tpu_torch.io.pcd", "lili_om_tpu_torch.io.rosbag",
                   "lili_om_tpu_torch.io.velodyne", "lili_om_tpu_torch.runtime.ingest",
                   "lili_om_tpu_torch.runtime.log", "lili_om_tpu_torch.runtime.native",
                   "lili_om_tpu_torch.runtime.pipeline"]


def _import_without_jax(mods):
    """Run in a spawned child: import ``mods`` with the JAX package made
    unimportable; report what got imported and whether CUDA was touched."""
    import importlib
    import sys

    for m in ("jax", "jaxlib", "lili_om_tpu"):
        sys.modules[m] = None
    for m in mods:
        importlib.import_module(m)
    import torch

    return (sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lili_om_tpu")
                   and sys.modules[m] is not None), torch.cuda.is_initialized())


def test_runtime_modules_import_in_a_spawned_child():
    assert {p.stem for p in (PORT / "runtime").glob("*.py")} - {"__init__"} == \
        {m.rsplit(".", 1)[1] for m in RUNTIME_MODULES if ".runtime." in m}
    with mp.get_context("spawn").Pool(1) as pool:
        leaked, cuda = pool.apply(_import_without_jax, (RUNTIME_MODULES,))
    assert leaked == [] and cuda is False


def test_native_runtime_loads_no_library_of_the_jax_package(tmp_path):
    """A process that drives every native path of the port (the runner's
    sequencer and IMU ring, the dataset log both ways, the map export's PCD
    writer) maps the port's own library from ``lili_om_tpu_torch/_build/``,
    no file under ``native/``, and imports nothing of the JAX package."""
    code = f"""
import sys
import numpy as np
from lili_om_tpu_torch.io import dataset
from lili_om_tpu_torch.runtime import native
from lili_om_tpu_torch.runtime.pipeline import PipelineRunner

class Sink:
    def push_imu(self, *a):
        pass

r = PipelineRunner(Sink())
r.feed_imu(np.arange(4) * 0.005, np.zeros((4, 3)), np.zeros((4, 3)))
w = dataset.DatasetWriter({str(tmp_path / "d.lom")!r})
w.write_imu(dataset.ImuRecord(0.0, np.zeros(3, np.float32), np.ones(3, np.float32)))
w.close()
assert len(list(dataset.read_dataset({str(tmp_path / "d.lom")!r}))) == 1
assert native.pcd_write_native({str(tmp_path / "m.pcd")!r}, np.zeros((3, 3)))
maps = open("/proc/self/maps").read()
print([line.split()[-1] for line in maps.splitlines() if "lili_runtime" in line][:1])
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lili_om_tpu")))
print(maps.count({str(ROOT / "native")!r}))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    lib, leaked, under_native = r.stdout.strip().splitlines()
    assert lib.startswith(f"['{PORT / '_build' / 'liblili_runtime-'}") and lib.endswith(".so']")
    assert leaked == "[]" and under_native == "0"


def _entry_points():
    from lili_om_tpu_torch.apps import (diag_backend, evaluate_presets, run_bag, run_dataset,
                                        run_loop_closure, run_pipeline, run_synthetic,
                                        soak_long_run)
    from lili_om_tpu_torch.frame import Frame, bench_configs, sim_scans
    from lili_om_tpu_torch.models.fusion import fusion_step, init_fusion_state
    from lili_om_tpu_torch.models.odometry import init_state, odometry_step
    from lili_om_tpu_torch.models.pose_graph import init_graph
    from lili_om_tpu_torch.models.system import LiliOmSystem
    from lili_om_tpu_torch.ops.features_livox import LivoxFeatureConfig, extract_features_livox
    from lili_om_tpu_torch.ops.features_spin import extract_features_spin

    feats, odo, fus, noise = bench_configs()
    z = torch.zeros
    return {
        "init_state": lambda: init_state(odo),
        "init_fusion_state": lambda: init_fusion_state(fus, noise),
        "odometry_step": lambda: odometry_step(init_state(odo, device="cpu"),
                                               z((8, 3)), z(8, dtype=torch.bool), odo),
        "fusion_step": lambda: fusion_step(
            init_fusion_state(fus, noise, device="cpu"), z((8, 3)), z(8, dtype=torch.bool),
            z(8), z((8, 3)), z(8, dtype=torch.bool), z(4), z((4, 3)), z((4, 3)),
            z(4, dtype=torch.bool), fus, noise),
        "extract_features_spin": lambda: extract_features_spin(
            z((4, 60, 3)), z((4, 60), dtype=torch.bool), z((4, 60)), feats),
        "extract_features_livox": lambda: extract_features_livox(
            z((6, 40, 3)), z((6, 40)), z((6, 40), dtype=torch.bool),
            LivoxFeatureConfig(n_cols=40)),
        "Frame": lambda: Frame(),
        "sim_scans": lambda: sim_scans(1, rings=4, cols=60),
        "LiliOmSystem": lambda: LiliOmSystem(),
        "init_graph": lambda: init_graph(8),
        "run_dataset record": lambda: run_dataset.main(["record", "missing.lom", "1"]),
        "run_dataset play": lambda: run_dataset.main(["play", "missing.lom"]),
        "run_bag": lambda: run_bag.main(["missing.bag", "--preset", "synthetic"]),
        "evaluate_presets": lambda: evaluate_presets.main(["--presets", "synthetic",
                                                           "--frames", "2"]),
        "run_synthetic": lambda: run_synthetic.main(["2"]),
        "run_loop_closure": lambda: run_loop_closure.main(["--frames", "2"]),
        "run_pipeline": lambda: run_pipeline.main(["--frames", "3"]),
        "soak_long_run": lambda: soak_long_run.main(["2", "--spill"]),
        "diag_backend": lambda: diag_backend.main(["--frames", "2"]),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_device_none_without_cuda_raises(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
