"""The benchmark's reference miner, its control and its generator, on
small databases on the CPU.

    PYTHONPATH=src python -m pytest bench/tests -q
"""

import sys
from itertools import combinations
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import control, gen  # noqa: E402
from bench import run as bench_run  # noqa: E402
from bench.reference import eclat as reference  # noqa: E402

SMALL = {
    "powerlaw": dict(generator="powerlaw", data_seed=3, batch=256,
                     n_trans=700, n_items=40, avg_trans_len=5.0, alpha=1.2),
    "dense": dict(generator="powerlaw", data_seed=4, batch=256, n_trans=600,
                  n_items=9, avg_trans_len=5.0, alpha=0.6),
}


def brute_force(tx: gen.Transactions, minsup: int) -> dict:
    """Every itemset with its support, by enumerating the combinations of
    the frequent items (an itemset's items are each as frequent as it)
    and intersecting their transaction sets (tiny data only)."""
    tids = {}
    for t, (row, m) in enumerate(zip(tx.items, tx.mask, strict=True)):
        for it in row[m].tolist():
            tids.setdefault(it, set()).add(t)
    items = sorted(i for i, ts in tids.items() if len(ts) >= minsup)
    out = {}
    for k in range(1, len(items) + 1):
        found = False
        for combo in combinations(items, k):
            sup = len(set.intersection(*(tids[i] for i in combo)))
            if sup >= minsup:
                out[frozenset(combo)] = sup
                found = True
        if not found:
            break
    return out


@pytest.mark.parametrize("family,minsup", [("powerlaw", 15),
                                           ("powerlaw", 40),
                                           ("dense", 150)])
@pytest.mark.parametrize("seed", [0, 2**33 + 7])
def test_reference_matches_brute_force(family, minsup, seed):
    tx = gen.generate(SMALL[family], seed)
    packed = reference.pack(tx.items, tx.mask, minsup, 2)
    got, _ = reference.mine(packed, minsup)
    assert got == brute_force(tx, minsup)
    assert len(got) > len(packed.labels)          # mines past level 1


def test_reference_at_a_higher_minsup_than_packed():
    tx = gen.generate(SMALL["powerlaw"], 5)
    packed = reference.pack(tx.items, tx.mask, 10, 2)
    full, _ = reference.mine(packed, 10)
    high, _ = reference.mine(packed, 30)
    assert high == {k: v for k, v in full.items() if v >= 30}


@pytest.mark.parametrize("family,minsup", [("powerlaw", 15), ("dense", 150)])
def test_control_fails_the_comparison(family, minsup):
    tx = gen.generate(SMALL[family], 1)
    want, _ = reference.mine(reference.pack(tx.items, tx.mask, minsup, 2),
                             minsup)
    assert bench_run.compare(dict(want), want) == 0
    for name, got in control.broken(want).items():
        bad = bench_run.compare(got, want)
        assert bad == 1, name
        out = bench_run.Outcome(jobs=[], setup_s=0, window_s=0,
                                peak_bytes=None, mismatched=bad,
                                jobs_wrong=1)
        assert not all(c["value"] <= c["limit"]
                       for c in bench_run.check_lines(out).values())


def test_control_script_readings():
    cell = bench_run.load_cell("kosarak-eclat.deep")
    cell.config = dict(cell.config, n_trans=4000)
    cell.traffic = dict(cell.traffic, minsup_rel=[0.004, 0.01])
    rows = control.readings(cell, 11)
    assert rows and all(r["mismatched_itemsets"] > r["limit"] for r in rows)


@pytest.mark.parametrize("seed", [0, 9])
def test_reference_packing_is_the_programs(seed):
    """The reference's own packing holds the bits, rows and order of the
    program's ``BitmapDB.from_db`` for the same transactions."""
    from repro_torch.core.bitmap import BitmapDB

    conf = dict(bench_run.load_cell("kosarak-eclat.deep").config,
                n_trans=9000)
    tx = gen.generate(conf, seed)
    want = BitmapDB.from_db(tx.as_lists(), 20, 128)
    packed = reference.pack(tx.items, tx.mask, 20, 128)
    assert packed.labels == want.items
    np.testing.assert_array_equal(packed.supports, want.supports)
    np.testing.assert_array_equal(
        packed.rows.view(np.uint32).reshape(want.bitmaps.shape),
        want.bitmaps)


def test_kosarak_stream_keeps_the_published_widths():
    """kosarak.dat's published shape: a mean of 8.1 distinct items a
    basket over 41,270 items.  At the configuration's exponent the
    expected number of items never drawn in 990,000 baskets is under
    one (the exponent is fitted to it: a steeper skew leaves items out),
    and the top item is in most baskets."""
    conf = bench_run.load_cell("kosarak-eclat.deep").config
    assert (conf["avg_trans_len"], conf["n_items"]) == (8.1, 41270)
    tx = gen.draw(dict(conf, n_trans=60000))
    lens = tx.mask.sum(axis=1)
    assert abs(lens.mean() - 8.1) < 0.05
    rows = np.where(tx.mask, tx.items, -1)
    rows.sort(axis=1)
    assert not ((rows[:, 1:] == rows[:, :-1]) & (rows[:, 1:] >= 0)).any()
    sup = np.bincount(tx.items[tx.mask], minlength=conf["n_items"])
    top = np.sort(sup)[::-1] / tx.n_trans
    assert 0.6 < top[0] < 0.8 and top[1] < 0.5

    def unseen(alpha):
        pop = 1.0 / np.arange(1, conf["n_items"] + 1) ** alpha
        pop /= pop.sum()
        n_draws = conf["n_trans"] * conf["avg_trans_len"]
        return np.exp(-n_draws * pop).sum()
    assert unseen(conf["alpha"]) < 1 < unseen(conf["alpha"] + 0.05)


def test_shuffle_keeps_the_sizes():
    conf = SMALL["powerlaw"]
    a, b = gen.generate(conf, 1), gen.generate(conf, 2)
    assert not np.array_equal(a.items, b.items)
    ra, _ = reference.mine(reference.pack(a.items, a.mask, 20, 2), 20)
    rb, _ = reference.mine(reference.pack(b.items, b.mask, 20, 2), 20)
    assert sorted(ra.values()) == sorted(rb.values())
    again = gen.generate(conf, 1)
    np.testing.assert_array_equal(a.items, again.items)
    for seed in (-1, 2**31 + 9, 2**64 + 1):        # any whole number
        assert gen.generate(conf, seed).n_trans == a.n_trans
