"""store_peak_gb: the row store's high-water slab
(``DeviceMiningStats.peak_device_words`` x 4 bytes), the largest over
the window's jobs, in GB."""


def read(ctx):
    words = [j.stats["peak_device_words"] for j in ctx.jobs]
    return 4 * max(words) / 1e9 if words and max(words) > 0 else None
