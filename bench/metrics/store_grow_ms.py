"""store_grow_ms: the row store's slab growth a job, the program's
``repro_torch.store.grow`` spans (both ``torch.cat``s and the caching
allocator's work), mean over the window's jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.total_us.get("store.grow", 0.0) / 1e3 / len(ctx.jobs)
