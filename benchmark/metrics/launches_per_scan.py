"""``launches_per_scan``: the CUDA kernels of the traced slice over the
scans in it (the slice's closure attempts included)."""


def read(ctx):
    if ctx.trace is None or ctx.trace_scans == 0:
        return None
    return ctx.trace.n_kernels / ctx.trace_scans
