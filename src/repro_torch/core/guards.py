"""Runtime device-purity enforcement (port of ``repro.core.guards``).

:func:`device_purity_guard` wraps the mining loop
(``FrontierScheduler.run``) in ``torch.cuda.set_sync_debug_mode("error")``:
any operation that makes the host wait for the card (a device->host
copy, ``.item()``, ``nonzero``, boolean-mask indexing, an upload from
pageable memory) raises instead of silently stalling the dispatch
pipeline.  :func:`host_sync` is the narrow escape for the deliberate
readbacks.  Uploads on the hot path therefore come from pinned host
buffers with ``non_blocking=True``.

On a host without CUDA both context managers only keep the depth
counter, so :func:`purity_guard_active` is testable on the CPU.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["device_purity_guard", "host_sync", "purity_guard_active"]

# Nesting depth of active guarded regions (0 inside a host_sync escape).
_DEPTH = 0


def purity_guard_active() -> bool:
    """True while inside a :func:`device_purity_guard` region and not
    inside a :func:`host_sync` escape."""
    return _DEPTH > 0


@contextlib.contextmanager
def _sync_debug_mode(mode: str):
    """Set CUDA's sync debug mode for the region and restore the previous
    mode on exit, exceptions included.  Does nothing without CUDA."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def device_purity_guard():
    """Make unannotated host syncs raise in this region."""
    global _DEPTH
    _DEPTH += 1
    try:
        with _sync_debug_mode("error"):
            yield
    finally:
        _DEPTH -= 1


@contextlib.contextmanager
def host_sync(why: str):
    """Sanctioned host-sync escape; ``why`` says what the sync is for."""
    if not why:
        raise ValueError("host_sync requires a non-empty justification")
    global _DEPTH
    saved, _DEPTH = _DEPTH, 0
    try:
        with _sync_debug_mode("default"):
            yield
    finally:
        _DEPTH = saved
