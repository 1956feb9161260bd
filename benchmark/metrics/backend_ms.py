"""``backend_ms``: the mean of the program's ``backend`` stage (one sample a keyframe) over
the window's sessions, from ``LiliOmSystem.metrics`` (host clock, each
sample ending in a synchronize), in ms. Nothing to read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    m = mean(ctx.stages.get("backend", []))
    return None if m is None else 1e3 * m
