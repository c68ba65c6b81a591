"""module_host_ms_per_call: the score modules' and the machine glue's host
time per call: the `machine_step_k*` ranges' self time, each range's
duration less the part of it covered by `flash_score.update` ranges and by
waits, ms; None where the program traced no machine step."""

from port_bench import program_spans as ps


def read(ctx):
    got = ps.ranges_and_host(ctx)
    steps = ps.named(got[0], prefix=ps.STEP_PREFIX) if got else []
    if not steps:
        return None
    inner = ps.named(got[0], ps.UPDATE) + ps.waits(got[1])
    return 1e-6 * sum(ps.self_ns(steps, inner)) / ctx.calls
