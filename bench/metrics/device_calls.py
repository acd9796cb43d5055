"""device_calls: fused screen-and-intersect (or difference) launches a
job makes (``DeviceMiningStats.device_calls``), mean over the window."""


def read(ctx):
    if not ctx.jobs:
        return None
    return sum(j.stats["device_calls"] for j in ctx.jobs) / len(ctx.jobs)
