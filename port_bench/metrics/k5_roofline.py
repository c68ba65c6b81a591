"""k5_roofline: K1's per-seed list walk, K5 (`rows::rows_kernel<C, EPI,
true>` with its live-tile flag passes and merge passes), as a share of its
roofline: the least time of the admitted (seed, bank row) pairs over the
device time from the profiler's kernel events, in %."""

from ._roofline import share


def read(ctx):
    return share(ctx, "k1_list")
