"""mine_s: the mean seconds of a mining job, the window's length over the
jobs run in it (the window ends when its last job's result is in)."""


def read(ctx):
    return ctx.window_s / len(ctx.jobs) if ctx.jobs else None
