"""The port's scheduler bookkeeping on the CPU: the chunk slicer against
the greedy loop it replaced, the row store's free list against a plain
list stack, and the (class, a, b) pair metadata through the
``chunk_sort_key`` permutation of a mixed adaptive drain group, with
the map and the child class order held against the JAX engine."""

import random
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core.eclat import BitmapMiner as JBitmapMiner
from repro.core.oracle import mine_bruteforce

from repro_torch.core.eclat import BitmapMiner
from repro_torch.core.frontier import FrontierScheduler
from repro_torch.core.rowstore import DeviceRowStore

from test_torch_engine import _counters


# ---------------------------------------------------------------------------
# the chunk slicer
# ---------------------------------------------------------------------------

def _greedy_slices(total, widths, pair_chunk, q):
    """The slicer as a loop over pairs: each chunk grows while the next
    pair's width cap admits it, then rounds down to the quantum."""
    slices = []
    lo = 0
    while lo < total:
        if widths is None:
            end = min(lo + pair_chunk, total)
        else:
            end = lo + 1
            while end < total and (end - lo) < int(widths[end]):
                end += 1
        if q > 1 and end < total and (end - lo) > q:
            end = lo + ((end - lo) // q) * q
        slices.append((lo, slice(lo, end)))
        lo = end
    return slices


def _widths(rng, kind, total):
    if kind == "none":
        return None
    if kind == "non_increasing":
        return np.sort(rng.integers(1, 80, total))[::-1].astype(np.int64)
    if kind == "non_monotone":
        return rng.integers(1, 80, total).astype(np.int64)
    # caps of 0 and 1 (and below) among wider ones
    w = rng.integers(-1, 3, total).astype(np.int64)
    wide = rng.random(total) < 0.3
    w[wide] = rng.integers(3, 40, int(wide.sum()))
    return w


_KINDS = ["none", "non_increasing", "non_monotone", "small_caps"]


@pytest.mark.parametrize("q", [1, 4, 8])
@pytest.mark.parametrize("kind", _KINDS)
def test_chunk_slices_equal_the_greedy_loop(kind, q):
    rng = np.random.default_rng(10 * _KINDS.index(kind) + q)
    totals = [1, 2, 3, q, q + 1, 299, 300] + rng.integers(
        1, 301, 40).tolist()
    for total in totals:
        pair_chunk = int(rng.integers(1, 100))
        widths = _widths(rng, kind, total)
        sched = FrontierScheduler(SimpleNamespace(chunk_quantum=q),
                                  pair_chunk)
        got = sched._chunk_slices(total, widths)
        assert got == _greedy_slices(total, widths, pair_chunk, q), (
            kind, q, total, pair_chunk,
            None if widths is None else widths.tolist())


# ---------------------------------------------------------------------------
# the row store's free list
# ---------------------------------------------------------------------------

def _round_capacity(n):
    cap = 64
    while cap < n:
        cap *= 2
    return cap


class _ListStack:
    """The free list as a Python list: ``pop()`` hands out, ``extend()``
    takes back; growth and compaction stack their free slots lowest on
    top."""

    def __init__(self, n, capacity):
        self.cap = _round_capacity(max(capacity, n, 1))
        self.free = list(range(self.cap - 1, n - 1, -1))

    @property
    def n_live(self):
        return self.cap - len(self.free)

    def alloc(self, k):
        if len(self.free) < k:
            old, self.cap = self.cap, _round_capacity(
                max(2 * self.cap, self.n_live + k))
            self.free.extend(range(self.cap - 1, old - 1, -1))
        return [self.free.pop() for _ in range(k)]

    def release(self, ids):
        self.free.extend(int(i) for i in ids)

    def compact(self, reserve):
        dead = set(self.free)
        live = [s for s in range(self.cap) if s not in dead]
        mapping = [-1] * self.cap
        for new, old in enumerate(live):
            mapping[old] = new
        self.cap = _round_capacity(max(len(live) + reserve, 1))
        self.free = list(range(self.cap - 1, len(live) - 1, -1))
        return mapping

    def compact_if_sparse(self, threshold, reserve):
        new_cap = _round_capacity(max(self.n_live + reserve, 1))
        if (self.n_live / self.cap < threshold
                and new_cap <= self.cap // 2):
            return self.compact(reserve)
        return None


@pytest.mark.parametrize("seed", range(6))
def test_free_list_pops_as_a_list_stack(seed):
    rng = random.Random(seed)
    n = 5
    store = DeviceRowStore(np.zeros((n, 1, 1), np.uint32), capacity=8)
    model = _ListStack(n, 8)
    live = list(range(n))
    assert store.alloc(0).tolist() == model.alloc(0) == []
    store.free(np.zeros(0, np.int32))
    model.release([])
    for step in range(120):
        op = rng.choice(["alloc"] * 4 + ["free"] * 4 + ["compact",
                                                         "compact_if"])
        if op == "alloc":
            k = rng.choice([0, 1, rng.randrange(2, 40), rng.randrange(40, 160)])
            got = store.alloc(k)
            assert got.dtype == np.int32
            assert got.tolist() == model.alloc(k), (step, k)
            live += got.tolist()
        elif op == "free":
            ids = rng.sample(live, rng.randrange(0, len(live) + 1))
            dead = set(ids)
            live = [s for s in live if s not in dead]
            store.free(np.asarray(ids, np.int64))
            model.release(ids)
        else:
            reserve = rng.randrange(0, 50)
            if op == "compact":
                got, want = store.compact(reserve=reserve), model.compact(
                    reserve)
            else:
                thr = rng.choice([0.25, 0.5, 0.9])
                got = store.compact_if_sparse(thr, reserve=reserve)
                want = model.compact_if_sparse(thr, reserve)
            assert (got is None) == (want is None), step
            if got is not None:
                assert got.tolist() == want, step
                live = [int(got[s]) for s in live]
        assert store.capacity == model.cap, step
        assert store.n_live == model.n_live == len(live), step
        assert store.occupancy == model.n_live / model.cap, step
    assert store.grows > 0 and store.compactions > 0


# ---------------------------------------------------------------------------
# pair metadata through the chunk_sort_key permutation
# ---------------------------------------------------------------------------

def _core_tail_db(seed, n_trans=60, core=5, tail=10):
    """A dense core of items beside a sparse tail: the adaptive rule
    flips the core's classes to diffsets and keeps the tail's tidsets,
    so drain groups mix AND and DIFF pairs."""
    rng = random.Random(seed)
    db = [[i for i in range(core) if rng.random() < 0.9]
          + [core + i for i in range(tail) if rng.random() < 0.3]
          for _ in range(n_trans)]
    return [t for t in db if t]


def _spy_classes(miner, sink):
    real = type(miner).make_class

    def spy(self, parent, children):
        node = real(self, parent, children)
        sink.append(list(node.itemsets))
        return node

    miner.make_class = spy.__get__(miner)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("inflight", [1, 2])
def test_sorted_pair_metadata_names_the_dispatched_pairs(
        monkeypatch, inflight, seed):
    real = FrontierScheduler._assemble
    groups = []

    def spy(self, drained):
        cols, meta = real(self, drained)
        # the same group assembled with no sort key: canonical order
        plain = FrontierScheduler(
            SimpleNamespace(pair_columns=self.client.pair_columns), 1)
        groups.append((cols, meta, *real(plain, drained)))
        return cols, meta

    monkeypatch.setattr(FrontierScheduler, "_assemble", spy)
    kw = dict(scheme="adaptive", diff_density=0.5, diff_hysteresis=0.05,
              block_words=1, pair_chunk=64, inflight=inflight)
    db, minsup = _core_tail_db(seed), 6
    miner = BitmapMiner(device="cpu", **kw)
    j_miner = JBitmapMiner(backend="jnp", **kw)
    classes, j_classes = [], []
    _spy_classes(miner, classes)
    _spy_classes(j_miner, j_classes)
    out, st = miner.mine(db, minsup)
    j_out, j_st = j_miner.mine(db, minsup)

    permuted = 0
    for cols, meta, pcols, pmeta in groups:
        assert meta.dtype == np.int32 and meta.shape == pmeta.shape
        at = {tuple(p): j for j, p in enumerate(pmeta.T.tolist())}
        where = [at[tuple(p)] for p in meta.T.tolist()]
        assert sorted(where) == list(range(pmeta.shape[1]))
        for key, col in cols.items():
            assert np.array_equal(col, pcols[key][where]), key
        if where != sorted(where):
            permuted += 1
            assert cols["op"].min() != cols["op"].max()
    assert permuted > 0
    assert out == j_out == mine_bruteforce(db, minsup)
    assert classes == j_classes
    assert _counters(st) == _counters(j_st)
