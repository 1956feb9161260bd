"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``lili_om_tpu`` (a whole-name test: ``lili_om_tpu_torch``
begins with ``lili_om_tpu``), and the reference loads nothing of the
program."""
import subprocess
import sys
from pathlib import Path

from lom_bench import isolation

BENCH = Path(__file__).resolve().parents[1]


def test_whole_top_level_names():
    mods = ["lili_om_tpu_torch", "lili_om_tpu_torch.ops.knn", "jaxtyping", "numpy"]
    assert isolation.forbidden_loaded(mods) == []
    bad = mods + ["lili_om_tpu", "lili_om_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]
    assert isolation.forbidden_loaded(bad) == ["flax.linen", "jax.numpy", "jaxlib",
                                               "lili_om_tpu", "lili_om_tpu.ops"]


def test_sources_import_nothing_forbidden():
    ref = isolation.imported_tops(BENCH / "lom_ref")
    assert ref <= {"__future__", "math", "typing", "numpy", "torch"}, ref
    harness = isolation.imported_tops(BENCH / "lom_bench") | isolation.imported_tops(
        BENCH / "metrics") | isolation.imported_tops(BENCH / "run.py")
    assert not harness & isolation.FORBIDDEN, harness


def _loaded_after(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH, check=True)
    return out.stdout.split()


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys, pkgutil, importlib, lom_ref\n"
            "for m in pkgutil.walk_packages(lom_ref.__path__, 'lom_ref.'):\n"
            "    importlib.import_module(m.name)\n"
            "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    tops = _loaded_after(code)
    assert "lom_ref" in tops
    assert not set(tops) & (isolation.FORBIDDEN | {isolation.PROGRAM})


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '..')\n"
            "import lom_bench.cli, lom_bench.check, lom_bench.trace, lom_bench.roofline\n"
            "import lom_bench.program as p; p.system_module()\n"
            "import lili_om_tpu_torch.ops.knn, lili_om_tpu_torch.ops.icp\n"
            "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))")
    tops = _loaded_after(code)
    assert isolation.PROGRAM in tops
    assert not set(tops) & isolation.FORBIDDEN
