"""``fusion_lm_iters``: the mean number of iterations the fusion's LM loop
ran, one sample a solved keyframe (the program's ``fusion.lm_iters``
counter, ``LiliOmSystem.metrics``), over the window's sessions. Nothing to
read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    return mean(ctx.stages.get("fusion.lm_iters", []))
