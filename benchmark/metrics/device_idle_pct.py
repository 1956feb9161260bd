"""``device_idle_pct``: the share of the traced slice (first to last
``bench`` span) in which no kernel, copy or set runs on the card, from the
union of the device operations' intervals, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
