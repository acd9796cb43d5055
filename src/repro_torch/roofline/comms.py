"""Per-rank collective traffic of a traced step (the port's counterpart
of ``repro.roofline.hlo``).

The JAX package parses the partitioned HLO text for its collectives.
The port makes no HLO: the collectives of a traced step are the
``c10d_functional`` ops that DTensor redistributions and the port's own
code sends, and :class:`~repro_torch.roofline.counters.StepCounter` logs
each one with the bytes of its local operands.  :func:`parse_collectives`
turns that log into the record the JAX function returns: ``{kind:
{"count", "operand_bytes", "link_bytes"}, "total": {...}}``, with the
same kinds and the same ring factors.  Operand bytes are those of the
rank's local tensors, as the partitioned module's shapes are per device.

Two things of ``hlo.py`` have no counterpart: the HLO text parser, and
``estimate_bf16_shadow_bytes`` (an XLA-CPU float-normalisation artifact:
the port's fake tensors keep bf16 as bf16).  Records keep
``cpu_bf16_shadow_bytes: 0`` so the schema matches.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional, Tuple

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ring-algorithm per-link byte multiplier (relative to operand bytes)
RING_FACTOR = {
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d_functional op name -> HLO collective kind.  A broadcast has no HLO
# kind of its own: it is logged under "collective-permute" (one send of
# the operand per link).
_KIND_OF_OP = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}

COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")

# The in-place ``c10d`` ops (``torch.distributed.all_reduce`` and kin, as
# ``distributed.collectives`` calls them): kind, and which argument holds
# the operands (the others are outputs).
_C10D = {
    "allreduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "broadcast_": ("collective-permute", 0),
}


def collective_kind(namespace: str, op_name: str
                    ) -> Tuple[Optional[str], Optional[int]]:
    """``(HLO kind, operand argument)`` of a collective op (``None``
    argument: every tensor argument is an operand); ``(None, None)`` for
    the others (``wait_tensor`` and the like move no bytes)."""
    if namespace == "c10d":
        return _C10D.get(op_name, (None, None))
    return _KIND_OF_OP.get(op_name), None


def parse_collectives(events: Iterable[Tuple[str, float]]
                      ) -> Dict[str, Dict[str, float]]:
    """Returns {kind: {"count": n, "operand_bytes": b, "link_bytes": b*f}}
    from ``(kind, operand_bytes)`` events (``StepCounter.collectives``).

    Also aggregates "total" with summed link bytes."""
    out: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0.0, "link_bytes": 0.0})
    for kind, b in events:
        out[kind]["count"] += 1
        out[kind]["operand_bytes"] += b
        out[kind]["link_bytes"] += b * RING_FACTOR[kind]
    total = {"count": sum(v["count"] for v in out.values()),
             "operand_bytes": sum(v["operand_bytes"] for v in out.values()),
             "link_bytes": sum(v["link_bytes"] for v in out.values())}
    result = dict(out)
    result["total"] = total
    return result
