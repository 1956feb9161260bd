"""The control comes out not correct: at each cell's own size on the card,
the reference computed with TF32 matrix products, put in the program's
place, fails at least one of the cell's limits on three seeds."""
import pytest

import calibrate
from lom_bench import check
from lom_bench.registry import Registry


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [c["name"] for c in Registry().spec["workloads"]])
def test_control_fails_the_limits(workload, cuda):
    reg = Registry()
    cell = reg.workload(workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    for seed, prog, ctl in calibrate.calibrate(workload, [31, 32, 33], control=True):
        correct, numbers = check.judge(ctl, cfg["limits"], traffic)
        assert not correct, (seed, numbers)
        ok_prog, numbers = check.judge(prog, cfg["limits"], traffic)
        assert ok_prog, (seed, numbers)
