"""border_host_ms_per_call: the bbELS border regions' host time per call:
the program's `bbels.borders` ranges (one a step), each its duration less
the waits inside it, ms; None where the program traced no such range."""

from port_bench import program_spans as ps

BORDERS = "bbels.borders"


def read(ctx):
    got = ps.ranges_and_host(ctx)
    borders = ps.named(got[0], BORDERS) if got else []
    if not borders:
        return None
    return 1e-6 * sum(ps.self_ns(borders, ps.waits(got[1]))) / ctx.calls
