"""store_upload_ms: the row store's upload of the level-1 rows a job,
the program's ``repro_torch.store.upload`` spans (the rows' one copy
from pageable host memory, inside ``store.init``; the suffix table is
computed on the card after it, in ``store.suffix``), mean over the
window's jobs, in ms."""

from bench import spans


def read(ctx):
    sp = spans.read(ctx.trace)
    if sp is None or not ctx.jobs:
        return None
    return sp.total_us.get("store.upload", 0.0) / 1e3 / len(ctx.jobs)
