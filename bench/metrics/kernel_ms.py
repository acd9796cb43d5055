"""kernel_ms: device time of the program's own kernels a job, from the
profiler's trace of the window, in ms.  PyTorch's kernels (``at::``,
``cub::``, copies and sets) are not the program's."""

LIBRARY = ("at::", "at_cuda_detail", "cub::", "thrust::", "Memcpy",
           "Memset")


def read(ctx):
    if ctx.trace is None or not ctx.jobs:
        return None
    own = [s for name, s in ctx.trace.kernels
           if not any(tag in name for tag in LIBRARY)]
    if not own:
        return None
    return 1e3 * sum(own) / len(ctx.jobs)
