"""``odometry_ms``: the mean of the program's ``odometry`` stage over
the window's sessions, from ``LiliOmSystem.metrics`` (host clock, each
sample ending in a synchronize), in ms. Nothing to read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    m = mean(ctx.stages.get("odometry", []))
    return None if m is None else 1e3 * m
