"""k1_roofline: K1's 1-D walk (`rows::rows_kernel<C, EPI, false>` with
its merge passes) as a share of its roofline: the least time of its sweeps
over their device time from the profiler's kernel events, in %."""

from ._roofline import share


def read(ctx):
    return share(ctx, "k1")
