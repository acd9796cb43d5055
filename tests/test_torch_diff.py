"""The port's dEclat / adaptive slice held against the JAX package, on the
CPU (``device="cpu"``: the plain PyTorch versions of the kernels).

Inputs are made with numpy from a seed and fed to both the jnp refs and
the port.  Integer work, so every comparison is exact (tolerance 0): the
difference scan's Z, counts, skip-aware ``blocks_done`` and aliveness,
the fused dispatch's slabs, mined itemsets and every counter that is not
a time.  One small case per kernel runs the Pallas kernel in interpret
mode; the sweeps use the jnp refs.
"""

import json
import random
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core.bitmap import suffix_popcounts_np
from repro.core.eclat import mine_bitmap as j_mine_bitmap
from repro.core.oracle import mine as oracle_mine
from repro.core.oracle import mine_bruteforce
from repro.kernels.bitmap_diff import bitmap_diff_es as pallas_diff
from repro.kernels.ref import bitmap_diff_es_ref, screen_and_diff_ref

from repro_torch.core.eclat import (DEFAULT_DIFF_DENSITY, BitmapMiner,
                                    mine_bitmap)
from repro_torch.core.frontier import ClassNode, FrontierScheduler
from repro_torch.kernels import bitmap_diff as tbd
from repro_torch.kernels import ops as tops

from test_equivalence import REGIMES, gen_db
from test_torch_engine import _counters, _fimi, _smoke

ROOT = Path(__file__).resolve().parents[1]
ADAPTIVE_SMOKE = dict(block_words=1, diff_density=0.3, diff_hysteresis=0.05)


def _bitmaps(rng, n, nb, bw, density=0.25):
    u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64).astype(
        np.uint32)
    if density < 0.5:
        u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64).astype(
            np.uint32)
    return u


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.copy())


def _eq(a: torch.Tensor, b) -> bool:
    a, b = a.numpy(), np.asarray(b)
    if b.dtype == np.uint32:
        a = a.view(np.uint32)
    return a.shape == b.shape and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# the difference scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_blocks,bw", [(1, 128), (3, 128), (6, 8), (9, 1)])
def test_diff_scan_matches_ref(n_blocks, bw):
    """Plain ``bitmap_diff_es`` == ``bitmap_diff_es_ref`` across shapes and
    minsup (ES off at <= 0), with zero-mass U blocks and bit-31 words."""
    rng = np.random.default_rng(23)
    P = 9
    U = _bitmaps(rng, P, n_blocks, bw)
    if n_blocks > 2:
        U[::2, 1] = 0                     # zero-mass U blocks
    U[0, 0, 0] = 0x80000001
    V = _bitmaps(rng, P, n_blocks, bw)
    su = suffix_popcounts_np(U)
    rho = su[:, 0].astype(np.int32)
    nt = n_blocks * bw * 32
    for minsup in (-3, 0, 1, nt // 64, nt // 8, nt):
        r = bitmap_diff_es_ref(U, V, su, rho, jnp.int32(minsup))
        p = tops.bitmap_diff_es(_t(U), _t(V), _t(su), _t(rho), minsup)
        for name, a, b in zip(("Z", "cnt", "blocks", "alive"), p, r,
                              strict=True):
            assert _eq(a, b), (minsup, name)


def test_diff_scan_skips_zero_mass_u_blocks():
    """Z / count / aliveness equal the andnot scan's; ``blocks_done``
    drops exactly the zero-mass members of the visited prefix."""
    rng = np.random.default_rng(31)
    P, nb, bw = 12, 6, 8
    U = _bitmaps(rng, P, nb, bw, density=0.2)
    U[:, 1] = 0
    U[:, 4] = 0
    V = _bitmaps(rng, P, nb, bw)
    su, sv = suffix_popcounts_np(U), suffix_popcounts_np(V)
    rho = su[:, 0].astype(np.int32)
    mass = su[:, :-1] - su[:, 1:]
    for minsup in (0, 5, 40):
        Zd, cd, bd, ad = tops.bitmap_diff_es(_t(U), _t(V), _t(su), _t(rho),
                                             minsup)
        Za, ca, ba, aa = tops.bitmap_intersect_es(
            _t(U), _t(V), _t(su), _t(sv), _t(rho), minsup, mode="andnot")
        assert torch.equal(Zd, Za) and torch.equal(cd, ca)
        assert torch.equal(ad, aa)
        bd, ba = bd.numpy(), ba.numpy()
        assert (bd <= ba).all() and (bd < ba).any(), minsup
        for i in range(P):
            assert bd[i] == ((np.arange(nb) < ba[i]) & (mass[i] > 0)).sum()
        r = bitmap_diff_es_ref(U, V, su, rho, jnp.int32(minsup))
        assert _eq(torch.from_numpy(bd), r[2])


def test_diff_scan_matches_pallas_interpret():
    """One small case against the Pallas kernel itself (interpret mode)."""
    rng = np.random.default_rng(5)
    U = _bitmaps(rng, 4, 3, 8)
    U[1, 1] = 0
    V = _bitmaps(rng, 4, 3, 8)
    su = suffix_popcounts_np(U)
    rho = su[:, 0].astype(np.int32)
    for minsup in (0, 60):
        p = pallas_diff(U, V, su, rho, jnp.int32(minsup), interpret=True)
        t = tops.bitmap_diff_es(_t(U), _t(V), _t(su), _t(rho), minsup)
        for a, b in zip(t, p, strict=True):
            assert _eq(a, b), minsup


# ---------------------------------------------------------------------------
# fused screen + difference + survivor-only scatter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("es", [False, True])
@pytest.mark.parametrize("n_blocks,bw", [(1, 128), (3, 128), (5, 8), (7, 1)])
def test_fused_screen_and_diff_matches_ref(es, n_blocks, bw):
    """Children land at ``slots`` only for pairs that finished alive with
    ``rho - |d| >= minsup``; dead pairs' slots, out-of-range slots and the
    rest of the slab stay untouched — equal to ``screen_and_diff_ref``."""
    rng = np.random.default_rng(13)
    cap, P = 32, 9
    store0 = _bitmaps(rng, cap, n_blocks, bw)
    if n_blocks > 2:
        store0[:6, 1] = 0
    suffix0 = suffix_popcounts_np(store0)
    ua = rng.integers(0, 12, P).astype(np.int32)
    vb = rng.integers(0, 12, P).astype(np.int32)
    slots = np.arange(12, 12 + P, dtype=np.int32)
    slots[-1] = cap + 3
    slots[-2] = -1
    rho = suffix0[ua, 0].astype(np.int32)
    nt = n_blocks * bw * 32
    for minsup in (0, 1, nt // 64, nt // 8):
        r = screen_and_diff_ref(store0, suffix0, ua, vb,
                                np.where(slots < 0, cap, slots), rho,
                                jnp.int32(minsup), early_stop=es)
        rows, suffix = _t(store0), _t(suffix0)
        out = tops.screen_and_diff(rows, suffix, ua, vb, slots, rho, minsup,
                                   early_stop=es)
        assert out[0] is rows and out[1] is suffix       # in place
        key = (es, minsup)
        for a, b in zip(out[2:], r[2:], strict=True):
            assert _eq(a, b), key
        assert _eq(rows, r[0]) and _eq(suffix, r[1]), key
        keep = out[4].numpy() & (rho - out[2].numpy() >= minsup)
        for i in np.flatnonzero(~keep):
            if 0 <= slots[i] < cap:
                assert np.array_equal(rows.numpy()[slots[i]].view(np.uint32),
                                      store0[slots[i]]), key


def test_diff_kernel_wrappers_reject_cpu_tensors():
    U = torch.zeros((2, 1, 4), dtype=torch.int32)
    s = torch.zeros((2, 2), dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tbd.bitmap_diff_es(U, U, s, r, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tbd.screen_and_diff(U, s, r, r, r, r, 1, 1)
    assert tbd.bitmap_diff_es.launches == 0


# ---------------------------------------------------------------------------
# the miners: itemsets and every counter equal to the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inflight", [1, 2])
@pytest.mark.parametrize("scheme", ["declat", "adaptive"])
@pytest.mark.parametrize("regime", ["powerlaw", "dense", "longpat"])
def test_diff_miners_match_jax_engine_on_smoke(regime, scheme, inflight):
    db, minsup = _smoke()[regime]
    kw = (dict(ADAPTIVE_SMOKE) if scheme == "adaptive"
          else dict(block_words=8))
    ref_out, _ = oracle_mine(db, minsup, "eclat", early_stop=True)
    for es in (True, False):
        out, st = mine_bitmap(db, minsup, scheme, early_stop=es,
                              inflight=inflight, device="cpu", **kw)
        j_out, j_st = j_mine_bitmap(db, minsup, scheme, early_stop=es,
                                    inflight=inflight, backend="jnp", **kw)
        assert out == j_out == ref_out, (regime, scheme, es)
        assert _counters(st) == _counters(j_st), (regime, scheme, es)


def test_adaptive_matches_smoke_baseline():
    """The committed baseline's ``adaptive`` blocks (JAX engine, default
    knobs otherwise) are a table of expected values for the port."""
    base = json.loads((ROOT / "benchmarks/baselines/BENCH_smoke.json")
                      .read_text())["datasets"]
    for regime, (db, minsup) in _smoke().items():
        want_all = base[regime]["adaptive"]
        assert want_all["knobs"] == ADAPTIVE_SMOKE
        for tag, es in (("es", True), ("full", False)):
            out, st = mine_bitmap(db, minsup, "adaptive", early_stop=es,
                                  device="cpu", **ADAPTIVE_SMOKE)
            got, want = _counters(st), want_all[tag]
            assert len(out) == base[regime]["frequent_itemsets"]
            assert {k: got[k] for k in got if k in want} == {
                k: want[k] for k in got if k in want}, (regime, tag)
    assert base["dense"]["adaptive"]["es"]["word_ops"] == 4730


@pytest.mark.parametrize("regime", REGIMES)
def test_diff_miners_match_oracle_and_jax_on_equivalence_regimes(regime):
    for seed in range(3):
        db, minsup = gen_db(regime, seed)
        expected, _ = oracle_mine(db, minsup, "declat", early_stop=False)
        for scheme, kw in (("declat", {}),
                           ("adaptive", dict(diff_density=0.3,
                                             diff_hysteresis=0.1))):
            for es in (False, True):
                out, st = mine_bitmap(db, minsup, scheme, early_stop=es,
                                      block_words=4, device="cpu", **kw)
                j_out, j_st = j_mine_bitmap(db, minsup, scheme,
                                            early_stop=es, block_words=4,
                                            backend="jnp", **kw)
                assert out == expected == j_out, (regime, seed, scheme, es)
                assert _counters(st) == _counters(j_st), (regime, seed,
                                                          scheme, es)


# ---------------------------------------------------------------------------
# adaptive representation policy (mirrors tests/test_adaptive.py)
# ---------------------------------------------------------------------------

def _dense_db(seed=0, n_items=6, n_trans=40, dens=0.85):
    rng = random.Random(seed)
    db = [[i for i in range(n_items) if rng.random() < dens]
          for _ in range(n_trans)]
    return [t for t in db if t]


def test_scheme_validation():
    with pytest.raises(ValueError):
        BitmapMiner(scheme="fpgrowth", device="cpu")
    for scheme in ("eclat", "declat"):
        with pytest.raises(ValueError):
            BitmapMiner(scheme=scheme, diff_density=0.5, device="cpu")
    assert BitmapMiner(scheme="adaptive", device="cpu").diff_density == \
        DEFAULT_DIFF_DENSITY == 0.5
    assert BitmapMiner(scheme="adaptive", diff_density=0.3,
                       device="cpu").diff_density == 0.3


def test_child_representation_hysteresis_band_and_one_way():
    m = BitmapMiner(scheme="adaptive", diff_density=0.5,
                    diff_hysteresis=0.1, device="cpu")
    m._n_trans = 100
    sup = lambda *v: np.asarray(v, np.int32)  # noqa: E731
    for sups, want in (((20, 30), "tidset"), ((50, 50), "tidset"),
                       ((55, 55), "tidset"), ((60, 60), "diffset"),
                       ((90, 95), "diffset"), ((), "tidset")):
        assert m._child_representation("tidset", sup(*sups)) == want, sups
    for sups in ((1, 2), (50, 55), (99, 99), ()):
        assert m._child_representation("diffset", sup(*sups)) == "diffset"
    e = BitmapMiner(scheme="eclat", device="cpu")
    d = BitmapMiner(scheme="declat", device="cpu")
    e._n_trans = d._n_trans = 10
    assert e._child_representation("tidset", sup(10, 10)) == "tidset"
    assert d._child_representation("tidset", sup(10, 10)) == "diffset"


def _spy_make_class(m, sink):
    real = BitmapMiner.make_class

    def spy(self, parent, children):
        node = real(self, parent, children)
        sink.append(node)
        return node

    m.make_class = spy.__get__(m)


def test_no_flip_flop_across_drain_groups():
    """diffset -> tidset never occurs; a threshold above every density
    flips nothing; a low one does flip — results exact throughout."""
    db = _dense_db(seed=3)
    root_density = float(np.mean([len(t) for t in db]) / 6)
    for dd in (0.3, root_density, 0.95):
        m = BitmapMiner(scheme="adaptive", diff_density=dd,
                        diff_hysteresis=0.05, block_words=2, pair_chunk=8,
                        device="cpu")
        nodes = []
        _spy_make_class(m, nodes)
        out, _ = m.mine(db, 2)
        assert out == mine_bruteforce(db, 2), dd
        trans = [(n.representation, n.payload) for n in nodes]
        assert ("diffset", "tidset") not in trans, dd
        if dd == 0.95:
            assert all(p == "tidset" for _, p in trans)
        if dd == 0.3:
            assert any(r == "diffset" for r, _ in trans)


def test_representation_tag_survives_scheduler_remap():
    class _NullClient:
        def release(self, klass):
            pass

    sched = FrontierScheduler(_NullClient(), pair_chunk=4)
    k1 = ClassNode(itemsets=[(0,), (1,)], rows=np.asarray([3, 5], np.int32),
                   supports=np.asarray([4, 4], np.int32),
                   representation="diffset", payload="diffset")
    k2 = ClassNode(itemsets=[(2,), (3,)], rows=np.asarray([0, 7], np.int32),
                   supports=np.asarray([4, 4], np.int32),
                   representation="tidset", payload="tidset")
    sched.push(k1)
    sched.remap(np.asarray([2, -1, -1, 0, -1, 1, -1, 3], np.int32),
                drained=[k2])
    assert k1.rows.tolist() == [0, 1] and k1.representation == "diffset"
    assert k2.rows.tolist() == [2, 3] and k2.representation == "tidset"


def test_adaptive_forced_compaction_matches_bruteforce():
    db = _dense_db(seed=1, n_items=12, n_trans=80, dens=0.6)
    m = BitmapMiner(scheme="adaptive", diff_density=0.3, diff_hysteresis=0.1,
                    block_words=1, pair_chunk=4, compact_occupancy=1.0,
                    device="cpu")
    nodes = []
    _spy_make_class(m, nodes)
    out, stats = m.mine(db, 8)
    assert out == mine_bruteforce(db, 8)
    assert stats.compactions > 0
    assert any(n.representation == "diffset" for n in nodes)


def test_mixed_mode_dispatch_accounting(monkeypatch):
    """device_calls == tidset launches + diffset launches, and both occur
    in one adaptive run over a DB with a dense cluster and a sparse tail."""
    calls = {"and": 0, "diff": 0}
    real_and, real_diff = tops.screen_and_intersect, tops.screen_and_diff

    def count_and(*a, **k):
        calls["and"] += 1
        return real_and(*a, **k)

    def count_diff(*a, **k):
        calls["diff"] += 1
        return real_diff(*a, **k)

    monkeypatch.setattr(tops, "screen_and_intersect", count_and)
    monkeypatch.setattr(tops, "screen_and_diff", count_diff)
    rng = random.Random(0)
    db = []
    for _ in range(60):
        t = [i for i in range(4) if rng.random() < 0.9]
        t += [4 + j for j in range(5) if rng.random() < 0.15]
        if t:
            db.append(t)
    out, stats = mine_bitmap(db, 3, scheme="adaptive", diff_density=0.55,
                             diff_hysteresis=0.05, block_words=2,
                             pair_chunk=8, device="cpu")
    assert out == mine_bruteforce(db, 3)
    assert calls["and"] >= 1 and calls["diff"] >= 1
    assert calls["and"] + calls["diff"] == stats.device_calls


def test_sparse_adaptive_never_flips():
    rng = random.Random(4)
    db = [[i for i in range(9) if rng.random() < 0.15] for _ in range(40)]
    db = [t for t in db if t] or [[0]]
    out_a, st_a = mine_bitmap(db, 2, scheme="adaptive", diff_density=0.9,
                              diff_hysteresis=0.05, block_words=2,
                              device="cpu")
    out_e, st_e = mine_bitmap(db, 2, scheme="eclat", block_words=2,
                              device="cpu")
    assert out_a == out_e == mine_bruteforce(db, 2)
    assert (st_a.device_calls, st_a.word_ops) == (st_e.device_calls,
                                                  st_e.word_ops)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--scheme", "declat"],
    ["--scheme", "adaptive", "--diff-density", "0.3",
     "--diff-hysteresis", "0.05", "--block-words", "1"],
])
def test_cli_cpu_diff_schemes_match_reference_cli(extra, tmp_path,
                                                   monkeypatch, capsys):
    from repro.core import cli as jcli
    from repro_torch.core import cli as tcli

    db, _ = _smoke()["dense"]
    path = _fimi(tmp_path, db)
    tcli.main(["--input", path, "--minsup", "150", "--device", "cpu",
               "--json-out", str(tmp_path / "t.json"), *extra])
    t_err = capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", [
        "repro-mine", "--input", path, "--minsup", "150", "--json-out",
        str(tmp_path / "j.json"), *extra])
    jcli.main()
    j_err = capsys.readouterr().err
    t = json.loads((tmp_path / "t.json").read_text())
    assert t == json.loads((tmp_path / "j.json").read_text())
    assert len(t) > 10

    def stats(err):
        blob = err[err.index("{"):err.index("}") + 1]
        return {k: v for k, v in json.loads(blob).items()
                if not k.endswith("_s")}
    assert stats(t_err) == stats(j_err)


def test_negative_slot_is_skipped_unlike_jax_drop_mode():
    """Known divergence, pinned: JAX's ``.at[slots].set(mode="drop")``
    wraps a negative slot (-1 -> capacity - 1) and writes there; the
    port's fused dispatches (plain and kernel alike) skip any slot
    outside [0, capacity).  The engines never hand out a negative slot."""
    rng = np.random.default_rng(8)
    cap = 8
    store0 = _bitmaps(rng, cap, 2, 8)
    suffix0 = suffix_popcounts_np(store0)
    ua, vb = np.array([0], np.int32), np.array([1], np.int32)
    rho = suffix0[ua, 0].astype(np.int32)
    r = screen_and_diff_ref(store0, suffix0, ua, vb, np.array([-1], np.int32),
                            rho, jnp.int32(1), early_stop=False)
    assert not np.array_equal(np.asarray(r[0])[cap - 1], store0[cap - 1])
    rows, suffix = _t(store0), _t(suffix0)
    tops.screen_and_diff(rows, suffix, ua, vb, np.array([-1], np.int32), rho,
                         1, early_stop=False)
    assert np.array_equal(rows.numpy().view(np.uint32), store0)
    assert np.array_equal(suffix.numpy(), suffix0)
