"""``fusion_ingest_ms``: the mean of the program's ``fusion.ingest`` span
over the window's sessions, from ``LiliOmSystem.metrics``: the body of
``models/fusion.py:_ingest`` (IMU propagation and preintegration, the
window shift, the ring insert and the map tables), one sample a keyframe.
Host clock inside the ``backend`` stage, no synchronize of its own, in ms.
Nothing to read: no sample."""
from lom_bench.stats import mean


def read(ctx):
    m = mean(ctx.stages.get("fusion.ingest", []))
    return None if m is None else 1e3 * m
