"""store_upload_ms: the row store's upload of the level-1 rows and
their suffix table a job, the program's ``repro_torch.store.upload``
spans (the two copies from pageable host memory, inside
``store.init``), mean over the window's jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.total_us.get("store.upload", 0.0) / 1e3 / len(ctx.jobs)
