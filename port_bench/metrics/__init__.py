"""One reader per per-layer metric, `read(ctx)`, found by the metric's name."""
