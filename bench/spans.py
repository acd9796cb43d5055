"""The program's own spans in a traced window: the ``repro_torch.``
ranges (``repro_torch.core.spans``) among the host events that
``devtrace.summarize`` keeps, as totals, counts and self times by name,
and their union, for the per-layer readers in ``metrics/``.  Times are
the trace's microseconds."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from bench.devtrace import _union as union

PREFIX = "repro_torch."

Interval = Tuple[float, float]


@dataclass
class Spans:
    total_us: Dict[str, float]       # summed durations by name
    count: Dict[str, int]            # spans by name
    self_us: Dict[str, float]        # durations less what child spans cover
    union: List[Interval]            # the merged intervals of every span


def covered(intervals: Iterable[Interval], cover: List[Interval]) -> float:
    """How much of ``intervals`` the merged, sorted ``cover`` overlaps."""
    total, i = 0.0, 0
    for s, e in sorted(intervals):
        while i < len(cover) and cover[i][1] <= s:
            i += 1
        j = i
        while j < len(cover) and cover[j][0] < e:
            total += min(e, cover[j][1]) - max(s, cover[j][0])
            j += 1
    return total


def read(trace) -> Optional[Spans]:
    """The program spans of ``trace`` (a ``devtrace.TraceSummary``), or
    ``None`` when it holds none (no trace, or a program without spans)."""
    if trace is None:
        return None
    # By start, and the outer of two spans that start together first.
    spans = sorted(((s, e, name[len(PREFIX):]) for s, e, name in trace.host
                    if name.startswith(PREFIX)),
                   key=lambda sp: (sp[0], -sp[1]))
    if not spans:
        return None
    total: Dict[str, float] = {}
    count: Dict[str, int] = {}
    own: Dict[str, float] = {}
    for i, (s, e, name) in enumerate(spans):
        # The child spans: those that start inside this one and end by
        # its end.
        kids = []
        for j in range(i + 1, len(spans)):
            cs, ce, _ = spans[j]
            if cs >= e:
                break
            if ce <= e:
                kids.append((cs, ce))
        total[name] = total.get(name, 0.0) + (e - s)
        count[name] = count.get(name, 0) + 1
        own[name] = (own.get(name, 0.0) + (e - s)
                     - covered([(s, e)], union(kids)))
    return Spans(total_us=total, count=count, self_us=own,
                 union=union((s, e) for s, e, _ in spans))
