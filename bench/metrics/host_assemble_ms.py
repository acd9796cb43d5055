"""host_assemble_ms: the scheduler's host time a job spends assembling
and dispatching drain groups (``DeviceMiningStats.assemble_s``), mean
over the window's jobs, in ms."""


def read(ctx):
    if not ctx.jobs:
        return None
    return 1e3 * sum(j.stats["assemble_s"] for j in ctx.jobs) / len(ctx.jobs)
