"""flash_launches_per_call: flash-score kernel launches per call, by the
program's counter `flash_score_update.launches` summed over its keys."""


def read(ctx):
    n = sum(ctx.launches.values())
    return n / ctx.calls if n > 0 else None
