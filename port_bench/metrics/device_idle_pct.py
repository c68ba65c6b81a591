"""device_idle_pct: 1 - (the union of the device operations' intervals) /
(the traced window), in %; None where no device operation was traced."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s) if ctx.busy_s > 0 else None
