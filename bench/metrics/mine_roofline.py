"""mine_roofline: the jobs' least time over the card's busy time in the
window, in %.  The least time is the bytes the configuration's scheme
needs (``bench/reference/eclat.py``: each class head's operand once,
each partner up to its candidate's early stop, and one child row a
frequent candidate) over
the card's HBM bandwidth (``bench/peaks.json``)."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.needed_bytes or t.busy_s <= 0:
        return None
    least_s = sum(ctx.needed_bytes) / ctx.peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / t.busy_s
