"""host_waits_per_call: the host's waits on the card per call: the
synchronising CUDA runtime calls (`program_spans.WAITS`) whose innermost
enclosing named range is the program's; those whose innermost range is a
`port_bench.*` span of the benchmark's (its synchronise after each machine
call) or that no range encloses are left out. None where none is left."""

from port_bench import program_spans as ps


def read(ctx):
    got = ps.ranges_and_host(ctx)
    if not got:
        return None
    n = sum(r is not None and not r.name.startswith(ps.BENCH_PREFIX)
            for r in ps.innermost(got[0], ps.waits(got[1])))
    return n / ctx.calls if n > 0 else None
