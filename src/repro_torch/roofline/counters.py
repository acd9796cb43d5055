"""The dry-run's per-rank counters of one traced step (the port's
counterpart of ``compiled.cost_analysis()`` and the HLO collective
parse).

:class:`StepCounter` is a ``TorchDispatchMode``.  Over every op that
reaches dispatch it counts:

* ``flops``: ``FlopCounterMode``'s formula for the op (the same
  registry, custom ops' formulas included), scaled to this rank's share
  when the op runs on ``DTensor``\\ s: by the local fraction of the
  output's elements, and divided by the mesh size of every dimension on
  which the output is a partial sum (the contraction is split there).
  Without DTensors the count equals ``FlopCounterMode``'s total.
* ``bytes``: the bytes of the op's inputs and outputs (a ``DTensor``'s
  local shard), views and pure allocations excluded.  Every aten op and
  custom op is counted on its own, so this is an **unfused upper bound**
  on the HBM traffic: XLA's ``bytes accessed`` counts fused kernels,
  which keep their intermediates on chip.
* ``collectives``: one ``(kind, operand bytes)`` event per collective
  op, functional or in-place ``c10d`` (``roofline.comms``), those that
  DTensor sends inside its own dispatch of an op (the redistributions its
  sharding rules ask for) included: a second mode, under this one, lets
  DTensor run first and logs what reaches it (as torch's
  ``CommDebugMode`` does).
* ``peak``: the most bytes held at once by the storages the step
  allocated (a ``DTensor``'s local shard; a storage counts from the op
  that first returns it until it is freed), over those of the
  arguments, which :meth:`StepCounter.hold` names first.  This is
  ``MemTracker``'s accounting, kept here because ``MemTracker`` counts a
  ``DTensor`` view at its global size (8 GiB per layer of qwen1.5-0.5b's
  ``decode_32k`` on 256 ranks, where the rank's shard is 32 MiB); on
  plain tensors the two agree.

Ops that DTensor runs on local shards inside its own dispatch are not
counted twice: FLOPs and bytes count the ``DTensor`` op once, and only
the collectives are read from inside its dispatch.  The local copies of
those redistributions are not in ``bytes`` or ``peak``.
"""

from __future__ import annotations

import weakref
from typing import Dict, Iterable, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.comms import (COLLECTIVE_NAMESPACES,
                                        collective_kind)

aten = torch.ops.aten

# Ops that move no bytes: aliases, metadata and pure allocations.
_NO_BYTES = {
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten.empty.memory_format, aten.empty_strided.default,
    aten.empty_like.default, aten.new_empty.default,
    aten.new_empty_strided.default, aten._local_scalar_dense.default,
    torch.ops._c10d_functional.wait_tensor.default,
}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the rank's shard; 0 on the meta device (shapes only)."""
    if isinstance(t, DTensor):
        t = t._local_tensor
    if t.device.type == "meta":
        return 0
    return t.numel() * t.element_size()


def _rank_share(out) -> float:
    """This rank's share of an op whose first output is ``out``."""
    if not isinstance(out, DTensor):
        return 1.0
    total = out.numel()
    share = out._local_tensor.numel() / total if total else 0.0
    for dim, p in enumerate(out.placements):
        if p.is_partial():
            share /= out.device_mesh.size(dim)
    return share


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


class _Collectives(TorchDispatchMode):
    """Logs every collective op into ``log``.  It returns
    ``NotImplemented`` for ``DTensor`` ops, so DTensor dispatches them
    with this mode still active and the collectives of its
    redistributions reach it as local ops."""

    def __init__(self, log: List[Tuple[str, float]]):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in COLLECTIVE_NAMESPACES:
            kind, arg = collective_kind(func.namespace, func._opname)
            if kind is not None:
                operands = [t for t in tree_leaves(
                    (args, kwargs) if arg is None else args[arg])
                    if isinstance(t, torch.Tensor)]
                self.log.append(
                    (kind, float(sum(_nbytes(t) for t in operands))))
        return out


class StepCounter(TorchDispatchMode):
    """Per-rank flops, bytes, collectives and peak memory of everything
    run under it."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops = 0
        self.collectives: List[Tuple[str, float]] = []
        self.current = 0
        self.peak = 0
        self._live: Dict[int, int] = {}
        self._log = _Collectives(self.collectives)

    def __enter__(self):
        self._log.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._log.__exit__(*exc)

    def hold(self, tensors: Iterable[torch.Tensor]) -> None:
        """Storages that exist before the step (its arguments): never
        counted as the step's allocations."""
        for t in tensors:
            st = _local(t).untyped_storage()
            self._live.setdefault(st._cdata, 0)

    def _free(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self.current -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        if _local(t).device.type == "meta":
            return
        st = _local(t).untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        nbytes = st.nbytes()
        self._live[key] = nbytes
        self.current += nbytes
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key, nbytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        if ns == "prim":
            return out
        self.ops += 1
        tensors_in = [a for a in tree_leaves((args, kwargs))
                      if isinstance(a, torch.Tensor)]
        packet = func._overloadpacket
        if packet in flop_registry:
            first = next((o for o in tree_leaves(out)
                          if isinstance(o, torch.Tensor)), None)
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += int(round(f * _rank_share(first)))
        tensors_out = [o for o in tree_leaves(out)
                       if isinstance(o, torch.Tensor)]
        for t in tensors_out:
            self._track(t)
        if not func.is_view and func not in _NO_BYTES:
            self.bytes += sum(_nbytes(t) for t in tensors_in) + \
                sum(_nbytes(t) for t in tensors_out)
        return out
