"""``fusion_lm_replay_share``: the share of the fusion's LM iterations that
ran as replays of a captured CUDA graph: the sum of the program's
``fusion.lm_replays`` counter (``LiliOmSystem.metrics``, one sample a
solved keyframe) over the sum of its ``fusion.lm_iters``, over the
window's sessions. 1.0: every iteration in the window was a replay.
Nothing to read: no replay counter (a program that runs the loop
eagerly), or no iteration."""


def read(ctx):
    replays = ctx.stages.get("fusion.lm_replays", [])
    iters = sum(ctx.stages.get("fusion.lm_iters", []))
    if not replays or iters == 0:
        return None
    return sum(replays) / iters
