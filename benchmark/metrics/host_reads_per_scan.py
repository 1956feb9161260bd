"""``host_reads_per_scan``: the program's explicit device-to-host reads
(every ``host_read.<site>`` sample of ``LiliOmSystem.metrics``, a
synchronize each) over the scans (``odometry`` samples) of the window's
sessions; the closure attempts' reads are counted with the scans', as
``launches_per_scan`` counts their kernels. Nothing to read: no scan, or no
host read recorded."""


def read(ctx):
    scans = len(ctx.stages.get("odometry", []))
    reads = [xs for name, xs in ctx.stages.items() if name.startswith("host_read.")]
    if scans == 0 or not reads:
        return None
    return sum(len(xs) for xs in reads) / scans
