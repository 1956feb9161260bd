"""``host_read_ms``: the seconds the host was blocked in the program's
explicit device-to-host reads (every ``host_read.<site>`` sample of
``LiliOmSystem.metrics``: the wait for the card's queue plus the copy) over
the scans (``odometry`` samples) of the window's sessions, closure attempts
included, in ms a scan. Nothing to read: no scan, or no host read
recorded."""


def read(ctx):
    scans = len(ctx.stages.get("odometry", []))
    reads = [xs for name, xs in ctx.stages.items() if name.startswith("host_read.")]
    if scans == 0 or not reads:
        return None
    return 1e3 * sum(sum(xs) for xs in reads) / scans
