"""The device's idle share of the traced round, in %: one minus the time
at least one device operation ran (the union of their records over every
stream) over the round's length on the profiler's clock."""


def read(ctx):
    if ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
