"""The word count behind ``mine_roofline``: the words the configuration's
scheme needs, counted by the reference's walk (``bench/reference``)."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench import gen  # noqa: E402
from bench.reference import eclat as reference  # noqa: E402

CONF = dict(generator="powerlaw", data_seed=7, batch=512, n_trans=1024,
            n_items=60, avg_trans_len=6.0, alpha=1.2)
DENSE = dict(generator="powerlaw", data_seed=2, batch=512, n_trans=1280,
             n_items=12, avg_trans_len=6.0, alpha=0.8)


def _children(packed, minsup):
    out, _ = reference.mine(packed, minsup)
    return len(out) - len([s for s in packed.supports if s >= minsup])


def hand_count(tx, minsup, scheme, early_stop=True):
    """Word-by-word count in plain Python: the scheme's classes in its
    order, each pair's operands read one 32-bit word at a time; a class
    head's operand counted once, at the words any of its pairs read."""
    n = tx.n_trans
    sets = [set(row[m].tolist()) for row, m in zip(tx.items, tx.mask,
                                                   strict=True)]
    sup = {}
    for t in sets:
        for it in t:
            sup[it] = sup.get(it, 0) + 1
    items = sorted((i for i in sup if sup[i] >= minsup),
                   key=lambda i: (sup[i], repr(i)))
    n_words = -(-n // 32)

    def words(tids):
        w = [0] * n_words
        for t in tids:
            w[t // 32] |= 1 << (t % 32)
        return w

    tid = {i: {t for t, s in enumerate(sets) if i in s} for i in items}
    total = 0

    def walk(prefix_tids, members):
        nonlocal total
        for a in range(len(members)):
            kids = []
            ta = members[a][1]
            shared = set()
            for b in range(a + 1, len(members)):
                tb = members[b][1]
                if scheme == "eclat":
                    u, v = words(ta), words(tb)
                    cnt, rest_a, rest_b = 0, len(ta), len(tb)
                else:
                    if prefix_tids is None:
                        u, v = words(ta), words(tb)
                    else:
                        u = words(prefix_tids - tb)
                        v = words(prefix_tids - ta)
                    cnt = 0
                read = []
                for w in range(n_words):
                    if scheme == "declat" and u[w] == 0:
                        continue
                    read.append(w)
                    if scheme == "eclat":
                        cnt += bin(u[w] & v[w]).count("1")
                        rest_a -= bin(u[w]).count("1")
                        rest_b -= bin(v[w]).count("1")
                        bound = cnt + min(rest_a, rest_b)
                    else:
                        cnt += bin(u[w] & ~v[w] & 0xFFFFFFFF).count("1")
                        bound = len(ta) - cnt
                    if early_stop and bound < minsup:
                        break
                total += len(read)
                shared.update(read)
                tab = ta & tb
                if len(tab) >= minsup:
                    total += n_words
                    kids.append((members[b][0], tab))
            total += len(shared)
            if len(kids) > 1:
                walk(ta, kids)

    walk(None, [(i, tid[i]) for i in items])
    return total


@pytest.mark.parametrize("scheme", ["eclat", "declat"])
@pytest.mark.parametrize("minsup", [20, 45])
@pytest.mark.parametrize("early_stop", [True, False])
def test_word_count_equals_a_count_by_hand(scheme, minsup, early_stop):
    # 1024 transactions: 32 words, whole blocks of 2 words, no padding.
    tx = gen.generate(CONF, 3)
    packed = reference.pack(tx.items, tx.mask, minsup, 2)
    _, words = reference.mine(packed, minsup, scheme, early_stop=early_stop)
    assert words.total == hand_count(tx, minsup, scheme, early_stop)


@pytest.mark.parametrize("conf,minsup", [(CONF, 20), (DENSE, 500)])
@pytest.mark.parametrize("scheme", ["eclat", "declat"])
@pytest.mark.parametrize("block_words", [2, 128])
def test_criterion_on_never_exceeds_off(conf, minsup, scheme, block_words):
    tx = gen.generate(conf, 5)
    packed = reference.pack(tx.items, tx.mask, minsup, block_words)
    _, on = reference.mine(packed, minsup, scheme)
    _, off = reference.mine(packed, minsup, scheme, early_stop=False)
    assert 0 < on.total <= off.total
    assert on.shared <= off.shared and on.partner <= off.partner
    assert on.shared <= on.partner   # a head is read no further than a pair
    if scheme == "eclat":
        assert on.total < off.total   # these pairs do stop early


@pytest.mark.parametrize("conf,minsup", [(CONF, 20), (DENSE, 500)])
def test_criterion_off_equals_the_full_operands(conf, minsup):
    """Eclat without the criterion reads every candidate's partner whole
    (the port's ``word_ops_full``) and each class head whole, once."""
    from repro_torch.core.bitmap import BitmapDB
    from repro_torch.core.eclat import BitmapMiner

    tx = gen.generate(conf, 6)
    packed = reference.pack(tx.items, tx.mask, minsup, 2)
    _, off = reference.mine(packed, minsup, "eclat", early_stop=False)
    bdb = BitmapDB.from_db(tx.as_lists(), minsup, 2)
    _, st = BitmapMiner(scheme="eclat", block_words=2, device="cpu",
                        inflight=1).mine_packed(bdb, minsup)
    assert off.partner == st.word_ops_full
    assert off.child == _children(packed, minsup) * packed.row_words
    assert off.shared % packed.row_words == 0
    assert 0 < off.shared < off.partner


@pytest.mark.parametrize("conf,minsup", [(CONF, 20), (CONF, 45),
                                         (DENSE, 500)])
@pytest.mark.parametrize("scheme", ["eclat", "declat"])
def test_count_is_the_port_at_one_word_a_block(conf, minsup, scheme):
    """At one word a block the port's work counter, which counts each
    pair's words, is the reference's partner count; at wider blocks it
    reads more."""
    from repro_torch.core.bitmap import BitmapDB
    from repro_torch.core.eclat import BitmapMiner

    tx = gen.generate(conf, 8)
    packed = reference.pack(tx.items, tx.mask, minsup, 2)
    _, words = reference.mine(packed, minsup, scheme)
    assert words.child == _children(packed, minsup) * packed.row_words
    db = tx.as_lists()
    ops = {}
    for bw in (1, 2, 8):
        _, st = BitmapMiner(scheme=scheme, block_words=bw, device="cpu",
                            inflight=1).mine_packed(
                                BitmapDB.from_db(db, minsup, bw), minsup)
        ops[bw] = st.word_ops
    assert words.partner == ops[1]
    assert ops[1] <= ops[2] <= ops[8]


def test_popcount_without_numpy_bitwise_count(monkeypatch):
    x = np.random.default_rng(0).integers(0, 2**63, 1000, dtype=np.uint64)
    want = np.array([bin(int(v)).count("1") for v in x])
    monkeypatch.delattr(np, "bitwise_count", raising=False)
    np.testing.assert_array_equal(reference.popcount(x), want)
    y = x.view(np.uint32)
    np.testing.assert_array_equal(
        reference.popcount(y), [bin(int(v)).count("1") for v in y])
