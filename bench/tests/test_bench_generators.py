"""The generators found by name: the Kosarak family's draw unchanged, and
the dense tabular family at accidents.dat's published widths, where its
latent classes make a lattice in which nearly every candidate is
frequent.

    PYTHONPATH=src python -m pytest bench/tests/test_bench_generators.py -q
"""

import hashlib
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import byname, gen  # noqa: E402
from bench.reference import eclat as reference  # noqa: E402

CONFIGS = ROOT / "bench" / "configs"
# The tabular family at accidents.dat's published widths (test data).
TABULAR = json.loads((ROOT / "bench" / "tests" / "tabular.json").read_text())


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def digest(tx):
    h = hashlib.sha256()
    h.update(tx.items.tobytes())
    h.update(tx.mask.tobytes())
    return h.hexdigest()


def test_kosarak_draw_is_unchanged():
    """The Kosarak configuration's first 4,000 baskets, bit for bit as
    the generator drew them before generators were found by name."""
    tx = gen.draw(dict(config("kosarak-eclat"), n_trans=4000))
    assert tx.items.shape == (4000, 32) and tx.items.dtype == np.int32
    assert digest(tx) == (
        "36c4f45c8cd88152213e41cad163cd6f68c0415bed0c958220f80d2b6a05b9c6")


def test_an_unknown_generator_names_the_missing_file():
    conf = dict(config("kosarak-eclat"), generator="no_such_family")
    with pytest.raises(FileNotFoundError,
                       match=r"generators/no_such_family\.py is missing"):
        gen.draw(conf)


@pytest.mark.parametrize(
    "path", sorted((ROOT / "bench" / "generators").glob("*.py")),
    ids=lambda p: p.stem)
def test_each_generator_file_is_found_by_its_name(path):
    family = byname.load("generators", path.stem)
    assert callable(family.stream) and "n_trans" in family.PARAMS


def test_tabular_stream_keeps_accidents_widths():
    """accidents.dat's published shape at its full 340,183 records: all
    468 items drawn, a mean of 33.8 items a record, every record 18 to 51
    items long, and no item twice in a record."""
    assert (TABULAR["n_trans"], TABULAR["n_items"]) == (340183, 468)
    tx = gen.draw(TABULAR)
    assert tx.n_trans == 340183
    lens = tx.mask.sum(axis=1)
    assert abs(lens.mean() - 33.8) < 0.05
    assert lens.min() >= 18 and lens.max() <= 51
    assert np.unique(tx.items[tx.mask]).size == 468
    assert tx.items.min() >= 0 and tx.items.max() < 468
    rows = np.where(tx.mask, tx.items, -1)
    rows.sort(axis=1)
    assert not ((rows[:, 1:] == rows[:, :-1]) & (rows[:, 1:] >= 0)).any()


def candidates(itemsets, labels):
    """Pairs an Eclat walk evaluates: each class, the frequent items at
    the root and below it the frequent extensions of one prefix by a
    later item in the walk's order, pairs its members once."""
    rank = {lab: r for r, lab in enumerate(labels)}
    members = Counter({(): len(labels)})
    for s in itemsets:
        if len(s) > 1:
            members[tuple(sorted(rank[i] for i in s))[:-1]] += 1
    return sum(m * (m - 1) // 2 for m in members.values())


def test_candidates_counts_the_reference_walk():
    """``candidates`` read from a map equals the pairs the reference's
    walk intersects, counted as it runs."""
    tx = gen.draw(dict(TABULAR, n_trans=2000))
    packed = reference.pack(tx.items, tx.mask, 700, 2)
    walk = reference._Walk(packed, 700, None, True)
    seen = []
    real = walk._class

    def counted(prefix, tp, rows, sups, labels, pc):
        seen.append(len(labels) * (len(labels) - 1) // 2)
        return real(prefix, tp, rows, sups, labels, pc)
    walk._class = counted
    walk.run()
    assert len(walk.out) > 1000
    assert candidates(walk.out, packed.labels) == sum(seen)


def test_tabular_lattice_is_dense():
    """34,018 records, mined by the reference at 0.28: nearly every
    candidate is frequent (at most 1.25 candidates an itemset of two
    items or more) and the lattice is deep."""
    tx = gen.draw(dict(TABULAR, n_trans=34018))
    low = gen.absolute_minsup(0.28, tx.n_trans)
    packed = reference.pack(tx.items, tx.mask, low, 128)
    found, _ = reference.mine(packed, low)
    n1 = len(packed.labels)
    assert len(found) - n1 > 10_000
    assert candidates(found, packed.labels) <= 1.25 * (len(found) - n1)
    assert max(map(len, found)) >= 8
