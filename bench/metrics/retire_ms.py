"""retire_ms: the scheduler's retirement of drain groups a job less its
readbacks and frees: the self time of the program's
``repro_torch.sched.retire`` spans (their ``sched.resolve`` and
``store.free`` children excluded), which is emitting the itemsets into
the result dict and building the child classes, mean over the window's
jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.self_us.get("sched.retire", 0.0) / 1e3 / len(ctx.jobs)
