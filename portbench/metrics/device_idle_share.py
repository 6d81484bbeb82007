"""The share of the profiled window in which no device activity ran:
1 − the union of the device activities' intervals over the window."""


def read(ctx):
    w = ctx.profile_window
    if w is None or not ctx.busy_s:
        return None
    return 100.0 * (1.0 - ctx.busy_s / w.seconds)
