"""``odometry_gn_steps``: the mean number of Gauss-Newton steps of a scan's
odometry, summed over its matching rounds, one sample a scan (the
program's ``odometry.gn_steps`` counter, ``LiliOmSystem.metrics``), over
the window's sessions. Nothing to read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    return mean(ctx.stages.get("odometry.gn_steps", []))
