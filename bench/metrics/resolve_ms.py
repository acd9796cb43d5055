"""resolve_ms: the scheduler's blocking readbacks a job, the program's
``repro_torch.sched.resolve`` spans (each chunk's readback and the
stats and dead-slot frees that follow it), mean over the window's
jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.total_us.get("sched.resolve", 0.0) / 1e3 / len(ctx.jobs)
