"""store_init_ms: the row store's set-up a job, the program's
``repro_torch.store.init`` spans (the level-1 rows' host slice, the
zero-filled row and suffix slabs, the rows' upload in
``store.upload`` and their suffix table in ``store.suffix``, one
launch of the table's kernel on the uploaded rows), mean over the
window's jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.total_us.get("store.init", 0.0) / 1e3 / len(ctx.jobs)
