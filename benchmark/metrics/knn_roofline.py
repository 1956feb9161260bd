"""``knn_roofline``: the kNN searches' share of their roofline in the
traced slice: the least time the H100 could take for the searches' work
(operations and bytes counted from each call's arguments,
``lom_bench/roofline.py``) over the device time of the kernels those calls
launched (``lom_bench/trace.py``), in %. Nothing to read: no search, or no
kernel time attributed to one."""
from lom_bench.roofline import bound_seconds


def read(ctx):
    if ctx.trace is None or not ctx.knn_work:
        return None
    spent = sum(ctx.trace.knn_times) + ctx.trace.knn_prep_s
    if spent <= 0:
        return None
    bound = sum(bound_seconds(ops, nbytes) for ops, nbytes in ctx.knn_work)
    return 100.0 * bound / spent
