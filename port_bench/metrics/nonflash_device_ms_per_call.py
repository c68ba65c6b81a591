"""nonflash_device_ms_per_call: device time per call of the operations that
are not flash-score kernels (the bbELS border regions, patch extraction,
norms, weights, the DDIM update, copies), ms; None where none was traced."""


def read(ctx):
    other = ctx.family_seconds.get("other", 0.0)
    return 1e3 * other / ctx.calls if other > 0 else None
