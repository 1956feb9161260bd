"""``fusion_match_ms``: the mean of the program's ``fusion.match`` span
over the window's sessions, from ``LiliOmSystem.metrics``: the
correspondence phase of ``fusion_step`` (the window's kNN searches, the
fits and the map gate), one sample a keyframe past the warm-up. Host clock
inside the ``backend`` stage, no synchronize of its own, in ms. Nothing to
read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    m = mean(ctx.stages.get("fusion.match", []))
    return None if m is None else 1e3 * m
