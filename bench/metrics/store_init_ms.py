"""store_init_ms: the row store's set-up a job, the program's
``repro_torch.store.init`` spans (slab and suffix allocation, the
level-1 rows' host suffix table and upload), mean over the window's
jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.total_us.get("store.init", 0.0) / 1e3 / len(ctx.jobs)
