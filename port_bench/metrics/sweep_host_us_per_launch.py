"""sweep_host_us_per_launch: the sweep wrapper's host path per sweep: the
mean, over the window's `flash_score.update` ranges (one per sweep), of
the range's duration less the waits inside it, us; None where the program
traced no such range."""

from port_bench import program_spans as ps


def read(ctx):
    got = ps.ranges_and_host(ctx)
    updates = ps.named(got[0], ps.UPDATE) if got else []
    if not updates:
        return None
    return 1e-3 * sum(ps.self_ns(updates, ps.waits(got[1]))) / len(updates)
