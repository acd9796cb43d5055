"""Program spans on the profiler's clock.

``span(name)`` marks one layer boundary of the mining path as a
``torch.profiler.record_function`` range named ``"repro_torch." + name``.
Under a recording profiler the range lands in its trace as a
``user_annotation`` event, on the same clock as the device's kernel and
copy events.  With no profiler recording, ``span`` returns one shared
null context: a span site then costs one C call, and nothing is
allocated, formatted or entered.  A span never synchronises with the
device, so it is safe inside ``device_purity_guard``.

A span carries its name and nothing else.  A drain group's
``sched.dispatch``, ``sched.resolve`` and ``sched.retire`` spans pair by
order, since the ring retires groups in the order it dispatched them.
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

__all__ = ["PREFIX", "span"]

PREFIX = "repro_torch."

_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range while a profiler records, else a
    shared no-op context manager."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return record_function(PREFIX + name)
