"""Frequent-item preprocessing shared by the packers.

Counterpart of the two helpers of ``repro.core.oracle`` that
``BitmapDB.from_db`` needs (``item_frequencies``,
``frequent_items_ascending``).  The rest of the reference oracle (the
paper's Algorithms 1-3 and PrePost+) is ported with the PrePost+ slice.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Hashable, List, Sequence

Item = Hashable
Database = Sequence[Sequence[Item]]


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
