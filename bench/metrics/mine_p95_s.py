"""mine_p95_s: the 95th percentile of the window's job times (host
clock, each job ended by a device synchronise)."""

import statistics


def read(ctx):
    walls = [j.wall_s for j in ctx.jobs]
    if len(walls) < 2:
        return walls[0] if walls else None
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
