"""setup_s: seconds from the start of the process to the start of the
window: imports, drawing and packing the database, loading (or building)
the kernel library, and one warm-up job at each minsup of the mix."""


def read(ctx):
    return ctx.setup_s
