"""k2_roofline: the split-dot loop at 'high', K2
(`cdt_split_rows::rows_kernel` with its pre-split and merge passes), as a
share of its roofline: the least time of its sweeps, the three bf16
products at the bf16 peak, over their device time from the profiler's
kernel events, in %."""

from ._roofline import share


def read(ctx):
    return share(ctx, "split") if ctx.precision == "high" else None
