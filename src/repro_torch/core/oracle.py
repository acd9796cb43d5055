"""Paper-faithful reference miners (port of ``repro.core.oracle``; pure
Python, no torch, no JAX).

Algorithms 1-3 of "Boosting Frequent Itemset Mining via Early Stopping
Intersections" (Nguyen, 2019) as printed, including the Early-Stopping
(ES) variants, with per-call comparison counters.  The port keeps its own
copy, line for line, because it imports nothing of the JAX package:
``BitmapDB.from_db`` uses the frequent-item helpers, ``DevicePrePost``
the ``PPCTree`` and ``MiningStats``, and the CLI's ``--engine oracle``
calls :func:`mine`.

Conventions
-----------
* A database is a list of transactions; a transaction is an iterable of
  hashable items.
* ``minsup`` is an absolute count.
* Itemsets are reported as frozensets mapped to their absolute support.
* Eclat/dEclat sort items in *increasing* frequency; PrePost+ builds its
  PPC-tree on *decreasing* frequency and searches in the reverse
  (increasing) order — the paper's §II-A choices.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Hashable, List, Sequence, Tuple

Item = Hashable
Transaction = Sequence[Item]
Database = Sequence[Transaction]
ItemsetSupports = Dict[FrozenSet[Item], int]


@dataclass
class MiningStats:
    """Counters matching the paper's Table IV / Figures 7-15 metrics."""

    candidates: int = 0        # proposed candidate itemsets (pairs tested)
    nodes: int = 0             # expanded (frequent) nodes in the search tree
    comparisons: int = 0       # loop iterations inside intersect/difference
    es_checks: int = 0         # early-stopping bound evaluations (ES overhead)
    es_aborts: int = 0         # intersections cut short by the ES criterion
    runtime_s: float = 0.0

    @property
    def ratio(self) -> float:
        """#Cands / #Nodes — the paper's predictor of ES effectiveness."""
        return self.candidates / max(self.nodes, 1)

    def as_dict(self) -> Dict[str, float]:
        return {
            "candidates": self.candidates,
            "nodes": self.nodes,
            "ratio": round(self.ratio, 4),
            "comparisons": self.comparisons,
            "es_checks": self.es_checks,
            "es_aborts": self.es_aborts,
            "runtime_s": round(self.runtime_s, 6),
        }


# ---------------------------------------------------------------------------
# Shared preprocessing
# ---------------------------------------------------------------------------

def item_frequencies(db: Database) -> Dict[Item, int]:
    freq: Dict[Item, int] = defaultdict(int)
    for t in db:
        for it in set(t):
            freq[it] += 1
    return dict(freq)


def frequent_items_ascending(db: Database, minsup: int) -> List[Item]:
    """Frequent 1-itemsets sorted in increasing frequency (Eclat order)."""
    freq = item_frequencies(db)
    items = [it for it, f in freq.items() if f >= minsup]
    # Deterministic tie-break on repr so runs are reproducible across hash seeds.
    items.sort(key=lambda it: (freq[it], repr(it)))
    return items


def build_tidlists(db: Database, items: Sequence[Item]) -> Dict[Item, List[int]]:
    """TID-list per item; TIDs are 1-based like the paper's running example."""
    wanted = set(items)
    tids: Dict[Item, List[int]] = {it: [] for it in items}
    for tid, t in enumerate(db, start=1):
        for it in set(t):
            if it in wanted:
                tids[it].append(tid)
    return tids


# ---------------------------------------------------------------------------
# Brute force (ground truth of the ground truth; tiny DBs only)
# ---------------------------------------------------------------------------

def mine_bruteforce(db: Database, minsup: int) -> ItemsetSupports:
    """Enumerate all itemsets by support counting. Exponential; tests only."""
    from itertools import combinations

    freq = item_frequencies(db)
    items = sorted((it for it, f in freq.items() if f >= minsup), key=repr)
    tsets = [frozenset(t) for t in db]
    out: ItemsetSupports = {}
    for k in range(1, len(items) + 1):
        found_any = False
        for combo in combinations(items, k):
            s = frozenset(combo)
            support = sum(1 for t in tsets if s <= t)
            if support >= minsup:
                out[s] = support
                found_any = True
        if not found_any:
            break
    return out


# ---------------------------------------------------------------------------
# Eclat (Algorithm 1)
# ---------------------------------------------------------------------------

def _intersect(U: List[int], V: List[int], stats: MiningStats) -> List[int]:
    """INTERSECT (Alg. 1 lines 18-29). One comparison per loop iteration."""
    Z: List[int] = []
    i = j = 0
    nu, nv = len(U), len(V)
    while i < nu and j < nv:
        stats.comparisons += 1
        if U[i] == V[j]:
            Z.append(U[i])
            i += 1
            j += 1
        elif U[i] < V[j]:
            i += 1
        else:
            j += 1
    return Z


def _intersect_es(U: List[int], V: List[int], minsup: int,
                  stats: MiningStats) -> List[int]:
    """INTERSECT_ES (Alg. 1 lines 30-45): abort once |U|-s_U or |V|-s_V
    drops below minsup. Output is exact for frequent candidates and a
    (possibly truncated) certificate of infrequency otherwise."""
    Z: List[int] = []
    i = j = 0
    s_u = s_v = 0
    nu, nv = len(U), len(V)
    while i < nu and j < nv:
        stats.comparisons += 1
        if U[i] == V[j]:
            Z.append(U[i])
            i += 1
            j += 1
        elif U[i] < V[j]:
            i += 1
            s_u += 1
            stats.es_checks += 1
            if nu - s_u < minsup:
                stats.es_aborts += 1
                break
        else:
            j += 1
            s_v += 1
            stats.es_checks += 1
            if nv - s_v < minsup:
                stats.es_aborts += 1
                break
    return Z


def mine_eclat(db: Database, minsup: int, early_stop: bool = False,
               ) -> Tuple[ItemsetSupports, MiningStats]:
    """Depth-first Eclat over TID-lists (Algorithm 1)."""
    if minsup < 1:
        raise ValueError("minsup must be an absolute count >= 1")
    stats = MiningStats()
    t0 = time.perf_counter()

    items = frequent_items_ascending(db, minsup)
    tidlists = build_tidlists(db, items)

    out: ItemsetSupports = {}
    for it in items:
        out[frozenset((it,))] = len(tidlists[it])
        stats.nodes += 1

    def traverse(klass: List[Tuple[Tuple[Item, ...], List[int]]]) -> None:
        # klass: members of one equivalence class (shared prefix), in item order.
        for a in range(len(klass)):
            new_class: List[Tuple[Tuple[Item, ...], List[int]]] = []
            pxy_items, px_tids = klass[a]
            for b in range(a + 1, len(klass)):
                py_items, py_tids = klass[b]
                stats.candidates += 1
                if early_stop:
                    z = _intersect_es(px_tids, py_tids, minsup, stats)
                else:
                    z = _intersect(px_tids, py_tids, stats)
                if len(z) >= minsup:
                    child = pxy_items + (py_items[-1],)
                    out[frozenset(child)] = len(z)
                    stats.nodes += 1
                    new_class.append((child, z))
            if new_class:
                traverse(new_class)

    traverse([((it,), tidlists[it]) for it in items])
    stats.runtime_s = time.perf_counter() - t0
    return out, stats


# ---------------------------------------------------------------------------
# dEclat (Algorithm 2)
# ---------------------------------------------------------------------------

def _difference(U: List[int], V: List[int], stats: MiningStats) -> List[int]:
    """DIFFERENCE (Alg. 2 lines 18-31): Z = U - V over sorted TID lists."""
    Z: List[int] = []
    i = j = 0
    nu, nv = len(U), len(V)
    while i < nu and j < nv:
        stats.comparisons += 1
        if U[i] == V[j]:
            i += 1
            j += 1
        elif U[i] < V[j]:
            Z.append(U[i])
            i += 1
        else:
            j += 1
    if i < nu:
        Z.extend(U[i:])
    return Z


def _difference_es(U: List[int], V: List[int], rho_parent: int, minsup: int,
                   stats: MiningStats) -> List[int]:
    """DIFFERENCE_ES (Alg. 2 lines 32-47): abort when rho(Px) - |Z| < minsup.

    Every element appended to Z lowers the achievable support
    rho(Pxy) = rho(Px) - |D(Pxy)| by one; once it cannot reach minsup the
    remaining merge work is provably redundant."""
    Z: List[int] = []
    i = j = 0
    nu, nv = len(U), len(V)
    while i < nu and j < nv:
        stats.comparisons += 1
        if U[i] == V[j]:
            i += 1
            j += 1
        elif U[i] < V[j]:
            Z.append(U[i])
            i += 1
            stats.es_checks += 1
            if rho_parent - len(Z) < minsup:
                stats.es_aborts += 1
                return Z
        else:
            j += 1
    if i < nu:
        # The tail flush can also cross the bound; honour it exactly.
        for k in range(i, nu):
            Z.append(U[k])
            stats.es_checks += 1
            if rho_parent - len(Z) < minsup:
                stats.es_aborts += 1
                return Z
    return Z


def mine_declat(db: Database, minsup: int, early_stop: bool = False,
                ) -> Tuple[ItemsetSupports, MiningStats]:
    """Depth-first dEclat over diffsets (Algorithm 2).

    Level 1 stores TID-lists; level 2 uses D(xy) = T(x) - T(y); deeper
    levels use D(Pxy) = D(Py) - D(Px) with
    rho(Pxy) = rho(Px) - |D(Pxy)| (paper §III-B).
    """
    if minsup < 1:
        raise ValueError("minsup must be an absolute count >= 1")
    stats = MiningStats()
    t0 = time.perf_counter()

    items = frequent_items_ascending(db, minsup)
    tidlists = build_tidlists(db, items)

    out: ItemsetSupports = {}
    for it in items:
        out[frozenset((it,))] = len(tidlists[it])
        stats.nodes += 1

    # Class member: (itemset, listing, support, is_tidlist)
    def traverse(klass: List[Tuple[Tuple[Item, ...], List[int], int, bool]]) -> None:
        for a in range(len(klass)):
            new_class: List[Tuple[Tuple[Item, ...], List[int], int, bool]] = []
            px_items, px_list, px_sup, px_is_tid = klass[a]
            for b in range(a + 1, len(klass)):
                py_items, py_list, py_sup, py_is_tid = klass[b]
                stats.candidates += 1
                if px_is_tid:
                    # Level-2 transition: D(xy) = T(x) - T(y).
                    u, v = px_list, py_list
                else:
                    # D(Pxy) = D(Py) - D(Px).
                    u, v = py_list, px_list
                if early_stop:
                    z = _difference_es(u, v, px_sup, minsup, stats)
                else:
                    z = _difference(u, v, stats)
                sup = px_sup - len(z)
                if sup >= minsup:
                    child = px_items + (py_items[-1],)
                    out[frozenset(child)] = sup
                    stats.nodes += 1
                    new_class.append((child, z, sup, False))
            if new_class:
                traverse(new_class)

    traverse([((it,), tidlists[it], len(tidlists[it]), True) for it in items])
    stats.runtime_s = time.perf_counter() - t0
    return out, stats


# ---------------------------------------------------------------------------
# PrePost+ (Algorithm 3): PPC-tree, N-lists, NL_intersect(_ES)
# ---------------------------------------------------------------------------

@dataclass
class _PPCNode:
    name: Item
    frequency: int = 0
    children: Dict[Item, "_PPCNode"] = field(default_factory=dict)
    pre: int = -1
    post: int = -1


PPCode = Tuple[int, int, int]  # (pre, post, frequency)


class PPCTree:
    """PPC-tree (paper §IV-A): prefix tree over transactions reordered in
    decreasing item frequency, annotated with pre/post traversal ranks."""

    def __init__(self, db: Database, minsup: int):
        freq = item_frequencies(db)
        frequent = {it: f for it, f in freq.items() if f >= minsup}
        # Decreasing frequency (ties broken deterministically), paper §II-A.
        self.order_desc: List[Item] = sorted(
            frequent, key=lambda it: (-frequent[it], repr(it)))
        self.rank_desc = {it: r for r, it in enumerate(self.order_desc)}
        self.item_support = frequent

        self.root = _PPCNode(name=None)
        for t in db:
            kept = sorted({it for it in t if it in frequent},
                          key=lambda it: self.rank_desc[it])
            node = self.root
            for it in kept:
                nxt = node.children.get(it)
                if nxt is None:
                    nxt = _PPCNode(name=it)
                    node.children[it] = nxt
                nxt.frequency += 1
                node = nxt

        # Pre/post ranks. Children are visited in insertion order, which is
        # the order transactions introduced them (matches the paper's figures).
        self._rank()
        self.nlists: Dict[Item, List[PPCode]] = self._collect_nlists()

    def _rank(self) -> None:
        pre_counter = 0
        post_counter = 0
        # Iterative DFS to avoid recursion limits on deep trees.
        stack: List[Tuple[_PPCNode, bool]] = [(self.root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                node.post = post_counter
                post_counter += 1
                continue
            node.pre = pre_counter
            pre_counter += 1
            stack.append((node, True))
            for child in reversed(list(node.children.values())):
                stack.append((child, False))
        # The paper ranks item nodes only (root excluded from its figures);
        # offsets are irrelevant to the ancestor test, so we keep raw ranks.

    def _collect_nlists(self) -> Dict[Item, List[PPCode]]:
        nl: Dict[Item, List[PPCode]] = defaultdict(list)
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            nl[node.name].append((node.pre, node.post, node.frequency))
            stack.extend(node.children.values())
        # Ascending pre-order rank, per §IV-A.
        return {it: sorted(codes) for it, codes in nl.items()}


def _nl_support(nl: List[PPCode]) -> int:
    return sum(c[2] for c in nl)


def _merge_same_code(Z: List[PPCode]) -> List[PPCode]:
    """Combine PP-codes sharing (pre, post) — Alg. 3 line 31."""
    if not Z:
        return Z
    merged: List[PPCode] = []
    for pre, post, f in Z:
        if merged and merged[-1][0] == pre and merged[-1][1] == post:
            merged[-1] = (pre, post, merged[-1][2] + f)
        else:
            merged.append((pre, post, f))
    return merged


def _nl_intersect(U: List[PPCode], V: List[PPCode],
                  stats: MiningStats) -> List[PPCode]:
    """NL_INTERSECT (Alg. 3 lines 19-33). U = NL(xS), V = NL(yS); a code of
    V contributes when it is an ancestor of the current code of U."""
    Z: List[PPCode] = []
    i = j = 0
    nu, nv = len(U), len(V)
    while i < nu and j < nv:
        stats.comparisons += 1
        xi, yj = U[i], V[j]
        if xi[0] > yj[0]:
            if xi[1] < yj[1]:
                Z.append((yj[0], yj[1], xi[2]))
                i += 1
            else:
                j += 1
        else:
            i += 1
    return _merge_same_code(Z)


def _nl_intersect_es(U: List[PPCode], V: List[PPCode], rho_v: int,
                     minsup: int, stats: MiningStats) -> List[PPCode]:
    """NL_INTERSECT_ES (Alg. 3 lines 34-52): every skipped V-code removes
    its frequency mass from the achievable support; abort when the bound
    drops below minsup (returns the empty N-list, support 0).

    PAPER ERRATUM (documented in DESIGN.md §Errata): as printed, the
    criterion is ``rho_V - skip < minSup`` with ``skip`` accumulated on
    *every* j-advance.  Because j only ever advances through the skip
    branch, a V-code that already contributed matches to Z also lands in
    ``skip``, so the printed bound ignores support mass that has already
    been earned and can abort a *frequent* candidate (it is only exact
    when Z is empty at check time, as in the paper's Example 4.2).  The
    sound version of the same idea — which we implement — is

        z_mass + (rho_V - skip) < minSup

    i.e. mass already earned plus everything still achievable from the
    unpassed V-codes.  This preserves the paper's guarantees (identical
    output, never more comparisons)."""
    Z: List[PPCode] = []
    z_mass = 0
    i = j = 0
    skip = 0
    nu, nv = len(U), len(V)
    while i < nu and j < nv:
        stats.comparisons += 1
        xi, yj = U[i], V[j]
        if xi[0] > yj[0]:
            if xi[1] < yj[1]:
                Z.append((yj[0], yj[1], xi[2]))
                z_mass += xi[2]
                i += 1
            else:
                skip += yj[2]
                stats.es_checks += 1
                if z_mass + (rho_v - skip) < minsup:
                    stats.es_aborts += 1
                    return []
                j += 1
        else:
            i += 1
    return _merge_same_code(Z)


def mine_prepost(db: Database, minsup: int, early_stop: bool = False,
                 ) -> Tuple[ItemsetSupports, MiningStats]:
    """PrePost+ (Algorithm 3): N-list intersection over the PPC-tree with
    suffix-sharing depth-first search in ascending frequency order."""
    if minsup < 1:
        raise ValueError("minsup must be an absolute count >= 1")
    stats = MiningStats()
    t0 = time.perf_counter()

    tree = PPCTree(db, minsup)
    order_asc = list(reversed(tree.order_desc))  # search order, §IV-A

    out: ItemsetSupports = {}
    for it in order_asc:
        out[frozenset((it,))] = tree.item_support[it]
        stats.nodes += 1

    # Class member: (itemset-as-tuple with newest item first, N-list, support)
    def traverse(klass: List[Tuple[Tuple[Item, ...], List[PPCode], int]]) -> None:
        for a in range(len(klass)):
            new_class: List[Tuple[Tuple[Item, ...], List[PPCode], int]] = []
            xs_items, xs_nl, _ = klass[a]
            for b in range(a + 1, len(klass)):
                ys_items, ys_nl, ys_sup = klass[b]
                stats.candidates += 1
                if early_stop:
                    z = _nl_intersect_es(xs_nl, ys_nl, ys_sup, minsup, stats)
                else:
                    z = _nl_intersect(xs_nl, ys_nl, stats)
                sup = _nl_support(z)
                if sup >= minsup:
                    child = xs_items + (ys_items[-1],)
                    out[frozenset(child)] = sup
                    stats.nodes += 1
                    new_class.append((child, z, sup))
            if new_class:
                traverse(new_class)

    traverse([((it,), tree.nlists[it], tree.item_support[it])
              for it in order_asc])
    stats.runtime_s = time.perf_counter() - t0
    return out, stats


# ---------------------------------------------------------------------------
# Convenience front-end
# ---------------------------------------------------------------------------

MINERS = {
    "eclat": mine_eclat,
    "declat": mine_declat,
    "prepost": mine_prepost,
}


def mine(db: Database, minsup: int, scheme: str = "eclat",
         early_stop: bool = False) -> Tuple[ItemsetSupports, MiningStats]:
    try:
        fn = MINERS[scheme]
    except KeyError:
        raise ValueError(
            f"unknown scheme {scheme!r}; pick from {sorted(MINERS)}"
        ) from None
    return fn(db, minsup, early_stop=early_stop)
