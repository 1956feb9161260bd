"""``fusion_solve_ms``: the mean of the program's ``fusion.solve`` span
over the window's sessions, from ``LiliOmSystem.metrics``: the LM loop of
``models/fusion.py:_finish``, one sample a solved keyframe (warm-up
keyframes have none). Host clock inside the ``backend`` stage, no
synchronize of its own, in ms. Nothing to read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    m = mean(ctx.stages.get("fusion.solve", []))
    return None if m is None else 1e3 * m
