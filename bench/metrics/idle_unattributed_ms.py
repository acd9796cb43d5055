"""idle_unattributed_ms: the traced window's device-idle time (no
kernel, copy or set running) during which no program span
(``repro_torch.``) is open on the host, mean a job, in ms: the job's
host work that no layer's span names (the scheduler's loop glue,
``drain_group``) and the harness between jobs.  It falls only when such
work goes away or gets a span.  Left out for a program without spans."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    idle = sum(e - s for s, e in ctx.trace.gaps)
    named = spans.covered(ctx.trace.gaps, sp.union)
    return (idle - named) / 1e3 / len(ctx.jobs)
