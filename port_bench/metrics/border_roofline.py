"""border_roofline: the bbELS border regions (`scores/bbels.py`
`_border_states`: fp32 dots and the online softmax in plain tensor code)
as a share of their roofline: the least time of the window's `border`
sweeps (`work/bbels.py`) over the device time of the operations launched
inside the program's `bbels.borders` ranges, each matched to its launch by
correlation id (`launch_ranges`), in %; None where the window ran no such
range."""

from port_bench import launch_ranges as lr

BORDERS = "bbels.borders"


def read(ctx):
    least = sum(s.seconds for s in ctx.sweeps if s.family == "border")
    ev = lr.find(ctx) if least > 0 else None
    ns = lr.device_ns_within(ev, BORDERS)[1] if ev else 0
    return 100.0 * least / (ns * 1e-9) if ns > 0 else None
