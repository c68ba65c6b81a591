"""The share of the roofline that one kernel family reached in the window:
the least time of its sweeps over the device time of its kernels, in %;
None where the window ran none of them."""


def share(ctx, family: str):
    least = sum(s.seconds for s in ctx.sweeps if s.family == family)
    device = ctx.family_seconds.get(family, 0.0)
    return 100.0 * least / device if least > 0 and device > 0 else None
