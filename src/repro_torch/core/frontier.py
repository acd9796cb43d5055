"""Engine-agnostic DFS frontier scheduler (port of ``repro.core.frontier``).

Host-side numpy, ported as it is: the work stack, cross-class drain
groups, pair-triangle assembly, chunk slicing, operand free-listing,
compaction scheduling and the in-flight ring of dispatched-but-unretired
drain groups.  While group N's fused launches run on the card (CUDA
launches return immediately), the host drains, assembles and launches
group N+1; blocking readbacks are deferred into the lazy handle
``evaluate_pairs`` returns and happen when the group retires.  With
``inflight=1`` every handle is resolved right after its dispatch and the
scheduler reproduces the serial engine's accounting bit for bit.

Client protocol (duck-typed; ``core.eclat.BitmapMiner`` implements it):

``pair_columns(klass, ia, ib) -> Dict[str, np.ndarray]``
    Per-pair operand columns for one class's sibling-pair triangle.
``evaluate_pairs(cols) -> handle``
    ONE fused device dispatch for a <= pair_chunk column slice.  Returns
    a lazy handle with ``.resolve() -> Iterable[(ki, row, support,
    extra)]`` (called once at group retirement) and ``.remap(mapping)``
    (rewrite slot handles when a compaction lands while the group is in
    flight).  A plain iterable of tuples counts as already resolved.
``make_class(parent, children) -> ClassNode``
``emit(itemset, support)``          record one frequent itemset.
``release(klass)``                  free a class's operand rows.
``maybe_compact(reserve) -> Optional[np.ndarray]``
    Compact the allocator if occupancy warrants it; return an old->new
    row-id mapping when handles moved.  ``reserve`` covers the whole
    drain group about to run plus every group still in flight.
``chunk_sort_key(cols)`` / ``chunk_widths(cols)`` (optional)
    Per-pair sort key and per-pair chunk-width cap (see ``_assemble``
    and ``_chunk_slices``).

Work accounting flows through :class:`EngineAccounting`, whose counters
mean the same as the JAX engine's.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from time import perf_counter
from typing import (Any, Deque, Dict, Hashable, List, NamedTuple,
                    Optional, Tuple)

import numpy as np

from repro_torch.core.guards import device_purity_guard
from repro_torch.core.spans import span


@dataclass
class EngineAccounting:
    """Shared device-engine accounting (one struct for all three engines).

    ``peak_live`` is the allocator's peak live mass — bitmap rows for the
    row-store engines, PPC-code triples for the N-list engine.
    ``compaction_occupancy`` is ``live / capacity`` right after the most
    recent compaction epoch (0.0 when compaction never fired).

    Pipeline counters: ``inflight_groups`` is the ring depth the run
    was configured with.  ``device_occupancy`` is ring state at
    dispatch, not a reading of the device: the fraction of drain groups
    dispatched while an earlier group was still in the ring, so it is
    exactly 0.0 for a serial ``inflight=1`` run whatever the device did
    (how busy the device was is read from a profiler trace).
    ``assemble_s`` / ``resolve_s`` split host time between group
    assembly+dispatch and blocking retire-time readbacks."""

    candidates: int = 0
    nodes: int = 0
    device_calls: int = 0
    grows: int = 0               # allocator slab reallocations
    compactions: int = 0         # allocator compaction epochs
    peak_live: int = 0           # peak live allocator mass
    peak_device_words: int = 0   # high-water slab words, all shards
    compaction_occupancy: float = 0.0
    runtime_s: float = 0.0
    # Survivor-only materialization telemetry: every fused
    # dispatch scatters ONLY the children whose support cleared minsup,
    # so ``child_scatters`` equals the number of frequent children (not
    # candidates) and ``scatter_words`` is the device words they cost —
    # bitmap rows (n_blocks * block_words each) or PPC-code words
    # (3 * child_len each).
    child_scatters: int = 0
    scatter_words: int = 0
    # Dispatch-pipeline telemetry.
    inflight_groups: int = 1
    device_occupancy: float = 0.0
    assemble_s: float = 0.0
    resolve_s: float = 0.0

    @property
    def deaths(self) -> int:
        """Candidates certified infrequent by ES (engine-specific split
        lives in the subclasses)."""
        return 0

    def note_allocator(self, alloc) -> None:
        """Pull the shared allocator counters (rowstore / nlist pool)."""
        self.grows = alloc.grows
        self.compactions = alloc.compactions
        self.peak_live = alloc.peak_live
        # Row-store slabs report their high-water device footprint; the
        # N-list pool has no single-slab equivalent (0 there).
        self.peak_device_words = int(
            getattr(alloc, "peak_device_words", 0))
        self.compaction_occupancy = alloc.last_compaction_occupancy

    def note_scheduler(self, sched: "FrontierScheduler") -> None:
        """Pull the pipeline counters from the scheduler that ran."""
        self.inflight_groups = sched.inflight
        self.device_occupancy = sched.device_occupancy
        self.assemble_s = sched.assemble_s
        self.resolve_s = sched.resolve_s

    def accounting_dict(self) -> Dict[str, float]:
        return {
            "device_calls": self.device_calls,
            "deaths": self.deaths,
            "compactions": self.compactions,
            "compaction_occupancy": round(self.compaction_occupancy, 4),
            "child_scatters": self.child_scatters,
            "scatter_words": self.scatter_words,
            "inflight_groups": self.inflight_groups,
            "device_occupancy": round(self.device_occupancy, 4),
            "assemble_s": round(self.assemble_s, 6),
            "resolve_s": round(self.resolve_s, 6),
        }


@dataclass
class ClassNode:
    """One equivalence class on the frontier.

    ``rows`` are allocator handles (row-store slots or N-list pool row
    ids) — contents never leave the device.  ``representation`` tags
    what those handles *hold*: ``"tidset"`` (TID bitmap
    rows), ``"diffset"`` (dEclat difference rows) or ``"nlist"``
    (PPC-code extents).  The tag rides the class, not the allocator —
    both bitmap representations share one ``DeviceRowStore`` slab, and
    compaction remaps ``rows`` only, so the tag survives remapping by
    construction.  ``payload`` carries the engine-specific extras
    (bitmap miners: the representation the class's *children* will be
    materialised in, decided once at ``make_class`` time; N-list: the
    per-member exact lengths)."""

    itemsets: List[Tuple[Hashable, ...]]
    rows: np.ndarray          # int32 (m,)
    supports: np.ndarray      # int32 (m,)
    payload: Any = None
    representation: str = "tidset"


class Child(NamedTuple):
    """One surviving candidate, as returned through ``evaluate_pairs``."""

    itemset: Tuple[Hashable, ...]
    row: int
    support: int
    extra: Any


class _InflightGroup:
    """One dispatched-but-unretired drain group in the pipeline ring.

    ``meta`` is the group's int32 ``(3, total)`` pair metadata: drained
    class index, member ``a``, member ``b`` per column, in dispatch
    order.  ``parts`` holds ``(chunk_lo, handle_or_results)`` per chunk
    slice: a lazy handle while readbacks are deferred, or an
    already-resolved result list (``inflight=1``, or clients returning
    plain iterables).
    """

    __slots__ = ("drained", "meta", "parts", "total")

    def __init__(self, drained: List[ClassNode], meta: np.ndarray,
                 parts: List[Tuple[int, Any]], total: int):
        self.drained = drained
        self.meta = meta
        self.parts = parts
        self.total = total


class FrontierScheduler:
    """Shared DFS work-stack with cross-class drain-group batching and a
    double-buffered dispatch pipeline.

    Classes are drained from the stack until one ``drain_target`` worth
    of sibling pairs is collected, their pair triangles are concatenated
    into global operand columns, and each chunk slice goes to the client
    as exactly one fused device dispatch.  Result sets are
    order-independent, so draining order never affects correctness.

    Pipelining: up to ``inflight`` groups sit in a FIFO ring between
    dispatch and retirement.  Assembly of the next group overlaps device
    execution of the previous ones; a group's blocking readbacks, child
    pushes and operand releases all happen when it is popped from the
    ring.  Group composition is taken from the stack *as of dispatch
    time* — a pipelined run may therefore batch classes differently
    than a serial one (``device_calls``/``grows`` may differ) while the
    emitted itemsets, child order and all order-invariant work counters
    (candidates, word_ops, comparisons, es_checks, ...) are identical.

    Row lifetime: a class's member rows are operands only for its own
    pair triangle, so they are released as soon as the drain group that
    consumed them retires; child rows live until the child class is
    drained in turn.  Compaction runs at drain-group boundaries, where
    the stack plus the drained group plus the in-flight ring is exactly
    the live row set — the scheduler remaps every frontier handle,
    including the pending handles of in-flight groups, through the
    mapping the allocator returns (safe because every launch is ordered
    on one CUDA stream: in-flight dispatches read the old slab before the
    compaction gather runs, and only host-side slot ids move).
    """

    def __init__(self, client, pair_chunk: int, *, inflight: int = 1,
                 drain_target: Optional[int] = None):
        self.client = client
        self.pair_chunk = int(pair_chunk)
        self.inflight = max(1, int(inflight))
        # Autotuned widths can exceed pair_chunk; drain enough pairs to
        # fill the widest chunk the client may request.
        self.drain_target = (int(drain_target) if drain_target
                             else self.pair_chunk)
        # Dispatch alignment: a client whose dispatch
        # splits each chunk over a cls mesh axis advertises the shard
        # count; chunk boundaries are rounded down to a multiple of it
        # so every cls-shard's slice is an equal contiguous run of the
        # sorted pair columns (bucket-sorted by construction — a
        # contiguous slice of a sorted chunk is sorted).
        self.chunk_quantum = max(1, int(getattr(client, "chunk_quantum", 1)))
        self._stack: List[ClassNode] = []
        self._ring: Deque[_InflightGroup] = deque()
        # Sibling-pair triangles by class size (read-only), made once a
        # run: deep levels drain many small classes of repeating sizes.
        self._triangles: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # Pipeline telemetry: a group counts as "overlapped" iff an
        # earlier group was still in flight at its dispatch.  Pure ring
        # bookkeeping (no timing), so the metric is deterministic.
        self.groups_dispatched = 0
        self.groups_overlapped = 0
        self.assemble_s = 0.0
        self.resolve_s = 0.0

    @property
    def device_occupancy(self) -> float:
        """Fraction of drain groups dispatched while the ring was
        non-empty (exactly 0.0 for a serial ``inflight=1`` run)."""
        return self.groups_overlapped / max(self.groups_dispatched, 1)

    # -- frontier bookkeeping ------------------------------------------------

    def push(self, klass: ClassNode) -> None:
        self._stack.append(klass)

    def drain_group(self) -> Tuple[List[ClassNode], int]:
        """Pop classes until one drain_target of pairs is filled.  Leaf
        classes (< 2 members) release their rows and contribute none."""
        drained: List[ClassNode] = []
        total = 0
        while self._stack and total < self.drain_target:
            klass = self._stack.pop()
            m = len(klass.itemsets)
            if m < 2:
                self.client.release(klass)
                continue
            drained.append(klass)
            total += m * (m - 1) // 2
        return drained, total

    def remap(self, mapping: np.ndarray,
              drained: Optional[List[ClassNode]] = None) -> None:
        """Apply an allocator old->new row-id mapping to every live
        frontier handle: stack, the drain group being assembled, and
        every in-flight group (class handles AND pending result
        handles — a retired handle is never remapped because retirement
        pops the group from the ring before the next compaction point).
        """
        for klass in self._stack:
            klass.rows = mapping[klass.rows]
        for klass in drained or ():
            klass.rows = mapping[klass.rows]
        for group in self._ring:
            for klass in group.drained:
                klass.rows = mapping[klass.rows]
            for _lo, part in group.parts:
                remap_fn = getattr(part, "remap", None)
                if remap_fn is not None:
                    remap_fn(mapping)

    # -- main loop -----------------------------------------------------------

    def run(self, root: ClassNode) -> None:
        # The whole mining loop runs under the sync guard, so any host
        # sync not routed through a host_sync() escape raises on CUDA
        # (inert on the CPU).
        with device_purity_guard():
            self._run(root)

    def _run(self, root: ClassNode) -> None:
        self.push(root)
        ring = self._ring
        while self._stack or ring:
            # Fill the pipeline: dispatch groups until the ring is full
            # or the stack is dry.  Children only appear at retirement,
            # so every group in one fill round batches pre-existing
            # frontier classes.
            while self._stack and len(ring) < self.inflight:
                drained, total = self.drain_group()
                if not drained:
                    continue
                # Compaction reserve must cover the WHOLE drain group
                # plus every in-flight group, not one pair_chunk: a
                # group's chunks allocate children cumulatively (earlier
                # chunks' survivors stay live while later chunks
                # allocate), and in-flight groups allocate at
                # retirement, so a smaller reserve let a compaction
                # shrink to a size the pipeline immediately regrew
                # (compact -> grow thrash).
                pending = sum(g.total for g in ring)
                mapping = self.client.maybe_compact(total + pending)
                if mapping is not None:
                    self.remap(mapping, drained)

                t0 = perf_counter()
                r0 = self.resolve_s
                with span("sched.assemble"):
                    cols, meta = self._assemble(drained)
                    widths = None
                    widths_fn = getattr(self.client, "chunk_widths", None)
                    if widths_fn is not None:
                        widths = widths_fn(cols)
                    slices = self._chunk_slices(total, widths)
                parts: List[Tuple[int, Any]] = []
                for lo, sl in slices:
                    with span("sched.dispatch"):
                        chunk = {k: v[sl] for k, v in cols.items()}
                        handle = self.client.evaluate_pairs(chunk)
                    if self.inflight == 1:
                        # Serial mode resolves chunk-by-chunk so dead
                        # slots are freed before the next chunk
                        # allocates — bit-for-bit the pre-pipeline
                        # accounting (slot reuse order included).
                        handle = self._resolve(handle)
                    parts.append((lo, handle))
                # Assembly time excludes any resolve time accrued inside
                # the loop (inflight=1 resolves inline).
                self.assemble_s += ((perf_counter() - t0)
                                    - (self.resolve_s - r0))
                if ring:
                    self.groups_overlapped += 1
                self.groups_dispatched += 1
                ring.append(_InflightGroup(drained, meta, parts, total))
            if ring:
                self._retire(ring.popleft())

    def _resolve(self, handle) -> List[Tuple[int, int, int, Any]]:
        """Materialise one chunk's deferred result (blocking readbacks
        + stats attribution happen inside the client handle)."""
        t0 = perf_counter()
        with span("sched.resolve"):
            if hasattr(handle, "resolve"):
                out = list(handle.resolve())
            else:
                out = list(handle)
        self.resolve_s += perf_counter() - t0
        return out

    def _retire(self, group: _InflightGroup) -> None:
        """Pop one group from the ring: resolve its deferred handles,
        emit survivors, push child classes in canonical order, release
        the consumed operand rows."""
        with span("sched.retire"):
            drained, meta = group.drained, group.meta
            groups: Dict[Tuple[int, int], List[Tuple[int, Child]]] = {}
            for lo, part in group.parts:
                results = (part if isinstance(part, list)
                           else self._resolve(part))
                # Only the survivors' metadata becomes Python ints.
                cia, aa, ba = meta[:, [lo + r[0] for r in results]].tolist()
                for ci, a, b, (_ki, row, support, extra) in zip(
                        cia, aa, ba, results, strict=True):
                    klass = drained[ci]
                    itemset = klass.itemsets[a] + (klass.itemsets[b][-1],)
                    self.client.emit(itemset, support)
                    groups.setdefault((ci, a), []).append(
                        (b, Child(itemset, row, support, extra)))
            # Child classes are rebuilt in canonical sibling order (b
            # ascending), NOT evaluation order: chunk_sort_key may have
            # permuted the pairs, and class member order is load-bearing
            # (pair orientation / search order within the class).
            for ci, _a in sorted(groups):
                kids = [c for _b, c in sorted(groups[(ci, _a)])]
                self.push(self.client.make_class(drained[ci], kids))
            with span("store.free"):
                for klass in drained:
                    self.client.release(klass)

    def _chunk_slices(self, total: int,
                      widths: Optional[np.ndarray],
                      ) -> List[Tuple[int, slice]]:
        """Cut [0, total) into dispatch chunks.  Without widths: fixed
        ``pair_chunk`` strides.  With per-pair width caps (already in
        sorted-column order, non-increasing after the length sort): grow
        each chunk greedily while it stays within the width cap of every
        member — chunk size <= min(widths in chunk) by construction.

        The greedy chunk from ``lo`` ends at the first pair ``end > lo``
        that would not fit, ``end - widths[end] >= lo``.  ``reach`` is
        the running maximum of ``i - max(widths[i], 1)``: every ``i <=
        lo`` has it below ``lo``, so that ``end`` is the first index
        whose ``reach`` is ``>= lo``, one binary search a chunk and no
        loop over pairs."""
        slices: List[Tuple[int, slice]] = []
        q = self.chunk_quantum
        if widths is not None:
            # host-sync: width caps are a host np vector by protocol
            caps = np.asarray(widths, np.int64)
            reach = np.maximum.accumulate(
                np.arange(caps.size, dtype=np.int64) - np.maximum(caps, 1))
        lo = 0
        while lo < total:
            if widths is None:
                end = min(lo + self.pair_chunk, total)
            else:
                end = min(max(int(np.searchsorted(reach, lo, "left")),
                              lo + 1), total)
            if q > 1 and end < total and (end - lo) > q:
                # Align non-final chunks to the cls-shard count so each
                # shard's slice covers real pairs evenly (the dispatch
                # pads any remainder with dropped writes — correct but
                # wasted lanes).  Rounding DOWN keeps every width cap
                # satisfied.
                end = lo + ((end - lo) // q) * q
            slices.append((lo, slice(lo, end)))
            lo = end
        return slices

    def _triangle(self, m: int) -> Tuple[np.ndarray, np.ndarray]:
        """``np.triu_indices(m, 1)``, read-only and kept for the run."""
        tri = self._triangles.get(m)
        if tri is None:
            tri = np.triu_indices(m, 1)
            for half in tri:
                half.setflags(write=False)
            self._triangles[m] = tri
        return tri

    def _assemble(self, drained: List[ClassNode],
                  ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """Concatenate every drained class's sibling-pair triangle into
        global operand columns plus int32 ``(3, total)`` metadata: the
        (class, a, b) of each pair, as columns.

        Length-aware composition: a client whose per-pair
        dispatch width depends on operand size (the N-list engine — its
        gather widths are the buckets of the chunk *maxima*) exposes
        ``chunk_sort_key(cols) -> int array``; the assembled pairs are
        then stably sorted by that key before chunk slicing, so one
        huge operand no longer widens the dispatch for every pair in
        its chunk.  The permutation is applied to the metadata too, and
        result sets are order-independent, so this only moves padding.
        """
        cols_l: Dict[str, List[np.ndarray]] = {}
        meta_l: List[Tuple[np.ndarray, ...]] = []
        for ci, klass in enumerate(drained):
            ia, ib = self._triangle(len(klass.itemsets))
            for key, col in self.client.pair_columns(klass, ia, ib).items():
                # host-sync: protocol guarantees host np operand columns
                cols_l.setdefault(key, []).append(np.asarray(col))
            meta_l.append((np.full(ia.size, ci, np.int32), ia, ib))
        cols = {k: np.concatenate(v) for k, v in cols_l.items()}
        meta = np.array([np.concatenate(c) for c in zip(*meta_l)],
                        dtype=np.int32)
        key_fn = getattr(self.client, "chunk_sort_key", None)
        if key_fn is not None and meta.shape[1] > 1:
            key = key_fn(cols)
            if key is not None:
                # host-sync: sort key is a host np vector by protocol
                order = np.argsort(np.asarray(key), kind="stable")
                cols = {k: c[order] for k, c in cols.items()}
                meta = meta[:, order]
        return cols, meta
