"""peak_mem_gb: `torch.cuda.max_memory_allocated()` over set-up and window
(the bank cache holds most of it), GB; None off the card."""


def read(ctx):
    return ctx.peak_bytes / 1e9 if ctx.peak_bytes > 0 else None
