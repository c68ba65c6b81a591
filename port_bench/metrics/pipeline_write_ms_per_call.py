"""pipeline_write_ms_per_call: the pipeline's writes per call: the summed
duration of the `pipeline.write` ranges (a batch's `.npy` writes each),
ms; None where the program traced none."""

from port_bench import program_spans as ps


def read(ctx):
    got = ps.ranges_and_host(ctx)
    writes = ps.named(got[0], ps.WRITE) if got else []
    if not writes:
        return None
    return 1e-6 * sum(r.dur_ns for r in writes) / ctx.calls
