"""pipeline_host_ms_per_call: time per call of `generate_els_samples`
outside the machine call (seed draws, resume scan, copies back, writes),
from the benchmark's spans 'pipeline' and 'machine', ms."""


def read(ctx):
    pipeline = ctx.spans.seconds("pipeline")
    return 1e3 * (pipeline - ctx.spans.seconds("machine")) / ctx.calls if pipeline > 0 else None
