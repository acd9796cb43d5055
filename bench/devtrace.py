"""Reduce a ``torch.profiler`` Chrome trace of the measured window to what
the per-layer readers need: device busy time (the union of kernel, copy
and set intervals), time by device operation, and the idle gaps with
what the host was doing in each."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# Host operations that name what the host was doing (runtime calls such
# as the allocator's capture checks say nothing of it).
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"
JOB = "bench.job"


@dataclass
class TraceSummary:
    window_s: float                      # the traced window's length
    busy_s: float                        # union of device activity in it
    device_ops: Dict[str, float]         # seconds by device operation
    kernels: List[Tuple[str, float]]     # (name, seconds) of each kernel
    gaps: List[Tuple[float, float]] = field(default_factory=list)
    host: List[Tuple[float, float, str]] = field(default_factory=list)

    def top_ops(self, n: int = 10) -> List[List]:
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in ops[:n]]

    def top_gaps(self, n: int = 10) -> List[List]:
        """The ``n`` longest idle gaps, each named by the host's work."""
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:n]
        return [[_label(self.host, s, e), (e - s) * 1e-6] for s, e in gaps]


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i].rstrip() or name
    return name


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _label(host: List[Tuple[float, float, str]], s: float, e: float) -> str:
    """What the host did between ``s`` and ``e``: the longest operation
    covering most of the gap, else the one it follows."""
    best, best_overlap, prev = None, 0.0, "window start"
    for hs, he, name in host:
        if he <= s:
            prev = name
        overlap = min(he, e) - max(hs, s)
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    if best is not None and best_overlap > 0.5 * (e - s):
        return f"host in {best}"
    return f"host python after {prev}"


def summarize(path: str) -> TraceSummary:
    """Read an exported Chrome trace (times in microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [ev for ev in events
              if ev.get("ph") == "X" and ev.get("name") == WINDOW]
    if not window:
        raise ValueError(f"the trace holds no {WINDOW!r} span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device, host = [], []
    ops: Dict[str, float] = {}
    kernels: List[Tuple[str, float]] = []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        if cat in DEVICE_CATS:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            device.append((s, e))
            short = short_name(name) if cat == "kernel" else name
            ops[short] = ops.get(short, 0.0) + (e - s) * 1e-6
            if cat == "kernel":
                kernels.append((name, (e - s) * 1e-6))
        elif cat in HOST_CATS and name not in (WINDOW, JOB):
            host.append((s, e, name))
    busy = _union(device)
    host.sort()
    gaps = []
    t = w0
    for s, e in busy + [(w1, w1)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return TraceSummary(window_s=(w1 - w0) * 1e-6,
                        busy_s=sum(e - s for s, e in busy) * 1e-6,
                        device_ops=ops, kernels=kernels, gaps=gaps,
                        host=host)
