"""mfu_pct: the least time of the window's counted work on the card
(`roofline.bound` over every sweep of every call, the border regions
included, admitted pairs only) over the window's wall, in %."""


def read(ctx):
    least = sum(s.seconds for s in ctx.sweeps)
    return 100.0 * least / ctx.window_s if least > 0 else None
