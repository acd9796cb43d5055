"""The port's PrePost+ slice held against the JAX package, on the CPU
(``device="cpu"``: the plain PyTorch versions of the kernels).

Inputs are made with numpy from a seed and fed to both the jnp refs and
the port.  Integer work, so every comparison is exact (tolerance 0): the
N-list length buckets, the PPC-tree's codes, the N-list ops' match
tables, counters and pool slabs, the pool allocator's offsets and slab
contents, mined itemsets and every counter that is not a time (and the
oracle's ``comparisons`` / ``es_checks``).  One small case runs the
Pallas merge kernel in interpret mode; the sweeps use the jnp refs.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.core import bitmap as jbitmap
from repro.core.oracle import PPCTree as JPPCTree
from repro.core.oracle import mine as oracle_mine
from repro.core.prepost import mine_prepost_device as j_mine_prepost
from repro.core.rowstore import NListPool as JNListPool
from repro.kernels import ref as jref
from repro.kernels.nlist_merge import nlist_merge as pallas_merge

from repro_torch.core import bitmap as tbitmap
from repro_torch.core import oracle as toracle
from repro_torch.core.prepost import DevicePrePost, mine_prepost_device
from repro_torch.core.rowstore import NListPool
from repro_torch.kernels import nlist_merge as tnl
from repro_torch.kernels import ops as tops

from test_equivalence import REGIMES, gen_db
from test_torch_engine import _counters, _fimi, _smoke

ROOT = Path(__file__).resolve().parents[1]
SENT = np.iinfo(np.int32).max


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32).copy())


def _eq(a: torch.Tensor, b) -> bool:
    a, b = a.numpy(), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


def _random_pool(rng, cap, offs_lens):
    """Random PPC-code slab with ascending-pre extents at (off, len)."""
    codes = np.stack([rng.integers(0, 1000, cap), rng.integers(0, 1000, cap),
                      rng.integers(1, 20, cap)], axis=1).astype(np.int32)
    for off, ln in offs_lens:
        seg = codes[off:off + ln]
        codes[off:off + ln] = seg[np.argsort(seg[:, 0], kind="stable")]
    return codes


# ---------------------------------------------------------------------------
# length buckets and the PPC-tree
# ---------------------------------------------------------------------------

def test_nl_pad_len_matches_reference_with_fallback():
    assert tbitmap.NL_LEN_BUCKETS == jbitmap.NL_LEN_BUCKETS
    assert tbitmap.NL_PAIR_CHUNK_BUCKETS == jbitmap.NL_PAIR_CHUNK_BUCKETS
    assert tbitmap.NL_REF_LEN == jbitmap.NL_REF_LEN
    assert tbitmap.NL_SENTINEL == jbitmap.NL_SENTINEL == SENT
    ns = [0, 1, 7, 8, 9, 32, 33, 2048, 8192, 8193, 32768, 32769, 65536,
          65537, 300000]
    for n in ns:
        assert tbitmap.nl_pad_len(n) == jbitmap.nl_pad_len(n), n
    assert tbitmap.nl_pad_len(32769) == 65536
    assert tbitmap.nl_pad_len(65537) == 131072
    lens = np.asarray(ns, np.int64)
    assert np.array_equal(tbitmap.nl_pad_len_np(lens),
                          jbitmap.nl_pad_len_np(lens))


@pytest.mark.parametrize("regime", REGIMES)
def test_ppctree_codes_match_reference(regime):
    cases = [gen_db(regime, seed) for seed in range(4)]
    if regime == "powerlaw":
        cases += list(_smoke().values())
    for db, minsup in cases:
        t, j = toracle.PPCTree(db, minsup), JPPCTree(db, minsup)
        assert t.order_desc == j.order_desc
        assert t.item_support == j.item_support
        assert t.nlists == j.nlists


def test_oracle_miners_match_reference():
    from repro.core.oracle import mine_bruteforce as j_brute
    for regime in REGIMES:
        db, minsup = gen_db(regime, 1)
        assert toracle.mine_bruteforce(db, minsup) == j_brute(db, minsup)
        for scheme in ("eclat", "declat", "prepost"):
            for es in (False, True):
                t_out, t_st = toracle.mine(db, minsup, scheme, early_stop=es)
                j_out, j_st = oracle_mine(db, minsup, scheme, early_stop=es)
                assert t_out == j_out
                assert ({k: v for k, v in t_st.as_dict().items()
                         if k != "runtime_s"}
                        == {k: v for k, v in j_st.as_dict().items()
                            if k != "runtime_s"}), (regime, scheme, es)
    with pytest.raises(ValueError):
        toracle.mine([[1]], 1, "nope")


# ---------------------------------------------------------------------------
# the N-list ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("es", [False, True])
@pytest.mark.parametrize("lu,lv", [(8, 8), (8, 32), (32, 8)])
def test_nlist_extend_matches_ref(es, lu, lv):
    rng = np.random.default_rng(7)
    cap, P = 1024, 9
    u_off = rng.integers(0, 256, P).astype(np.int32)
    v_off = rng.integers(256, 512 - lv, P).astype(np.int32)
    u_len = rng.integers(1, lu + 1, P).astype(np.int32)
    v_len = rng.integers(1, lv + 1, P).astype(np.int32)
    u_len[0] = 0                                    # an empty operand
    codes = _random_pool(rng, cap, list(zip(u_off, u_len, strict=True))
                         + list(zip(v_off, v_len, strict=True)))
    out_off = (512 + lu * np.arange(P)).astype(np.int32)
    out_off[-1] = cap + 5                           # skipped
    rho = rng.integers(0, 120, P).astype(np.int32)
    for minsup in (0, 1, 10, 80):
        r = jref.nlist_extend_ref(jnp.asarray(codes), u_off, u_len, v_off,
                                  v_len, out_off, rho, jnp.int32(minsup),
                                  lu=lu, lv=lv, early_stop=es)
        slab = _t(codes)
        g = tops.nlist_extend(slab, u_off, u_len, v_off, v_len, out_off,
                              rho, minsup, lu=lu, lv=lv, early_stop=es)
        assert g[0] is slab                            # in place
        for name, a, b in zip(("codes", "child_len", "support", "cmps",
                               "checks", "alive"), g, r, strict=True):
            assert _eq(a, b), (es, minsup, name)


@pytest.mark.parametrize("es", [False, True])
def test_nlist_presize_scatter_split_matches_ref(es):
    """presize == ``nlist_presize_ref``; scatter into tight survivor
    extents == ``nlist_scatter_ref``, the rest of the slab untouched."""
    rng = np.random.default_rng(17)
    cap, P, lu, lv = 2048, 9, 8, 32
    u_off = rng.integers(0, 256, P).astype(np.int32)
    v_off = rng.integers(256, 512 - lv, P).astype(np.int32)
    u_len = rng.integers(1, lu + 1, P).astype(np.int32)
    v_len = rng.integers(1, lv + 1, P).astype(np.int32)
    codes = _random_pool(rng, cap, list(zip(u_off, u_len, strict=True))
                         + list(zip(v_off, v_len, strict=True)))
    rho = rng.integers(0, 120, P).astype(np.int32)
    for minsup in (0, 1, 10, 80):
        r = jref.nlist_presize_ref(jnp.asarray(codes), u_off, u_len, v_off,
                                   v_len, rho, jnp.int32(minsup), lu=lu,
                                   lv=lv, early_stop=es)
        g = tops.nlist_presize(_t(codes), u_off, u_len, v_off, v_len, rho,
                               minsup, lu=lu, lv=lv, early_stop=es)
        for name, a, b in zip(("out_slot", "child_len", "support", "cmps",
                               "checks", "alive"), g, r, strict=True):
            assert _eq(a, b), (es, minsup, name)
        child_len, support = g[1].numpy(), g[2].numpy()
        keep = support >= minsup
        out_off = np.full(P, cap, np.int32)
        bump = 512
        for p in np.flatnonzero(keep):
            out_off[p] = bump
            bump += int(child_len[p])
        rc, rl = jref.nlist_scatter_ref(jnp.asarray(codes), r[0], u_off,
                                        u_len, v_off, v_len, out_off, lu=lu,
                                        lv=lv)
        slab = _t(codes)
        sc, sl = tops.nlist_scatter(slab, g[0], u_off, u_len, v_off, v_len,
                                    out_off, lu=lu, lv=lv)
        assert sc is slab and _eq(sc, rc) and _eq(sl, rl)
        written = np.zeros(cap, bool)
        for p in np.flatnonzero(keep):
            written[out_off[p]:out_off[p] + child_len[p]] = True
        assert np.array_equal(sc.numpy()[~written], codes[~written])


def test_nlist_presize_past_largest_bucket():
    """An operand of 32769 codes: the match table is 65536 wide (the
    power-of-two fallback), and every output equals the reference's.
    (V runs out after a few dozen steps, so the walk stays short.)"""
    n_long = 32769
    lu = tbitmap.nl_pad_len(n_long)
    assert lu == 65536 == jbitmap.nl_pad_len(n_long)
    k = np.arange(n_long)
    long_u = np.stack([10 + k, 50 + k, 1 + k % 3], 1).astype(np.int32)
    v = np.array([[20, 80, 7], [35, 10, 2], [8, 200001, 4]], np.int32)
    codes = np.concatenate([long_u, v, np.zeros((16, 3), np.int32)])
    cap = codes.shape[0]
    u_off = np.array([0, 0], np.int32)
    u_len = np.array([n_long, n_long], np.int32)
    v_off = np.array([n_long, n_long + 1], np.int32)
    v_len = np.array([2, 2], np.int32)
    rho = np.array([40, 6], np.int32)
    for es, minsup in ((False, 1), (True, 5)):
        r = jref.nlist_presize_ref(jnp.asarray(codes), u_off, u_len, v_off,
                                   v_len, rho, jnp.int32(minsup), lu=lu,
                                   lv=8, early_stop=es)
        g = tops.nlist_presize(_t(codes), u_off, u_len, v_off, v_len, rho,
                               minsup, lu=lu, lv=8, early_stop=es)
        for a, b in zip(g, r, strict=True):
            assert _eq(a, b), es
        assert int((g[0][0] != SENT).sum()) > 10       # matches recorded
        out_off = np.array([cap - 8, cap], np.int32)
        rc, _ = jref.nlist_scatter_ref(jnp.asarray(codes), r[0], u_off,
                                       u_len, v_off, v_len, out_off, lu=lu,
                                       lv=8)
        sc, _ = tops.nlist_scatter(_t(codes), g[0], u_off, u_len, v_off,
                                   v_len, out_off, lu=lu, lv=8)
        assert _eq(sc, rc), es


def test_nlist_intersect_matches_ref_and_pallas_interpret():
    rng = np.random.default_rng(3)
    P, lu, lv = 16, 8, 32

    def mk(n, width):
        pre = np.sort(rng.integers(0, 500, (n, width)).astype(np.int32), 1)
        post = rng.integers(0, 500, (n, width)).astype(np.int32)
        freq = rng.integers(1, 10, (n, width)).astype(np.int32)
        return pre, post, freq

    up, upo, uf = mk(P, lu)
    vp, vpo, vf = mk(P, lv)
    ul = rng.integers(1, lu + 1, P).astype(np.int32)
    vl = rng.integers(1, lv + 1, P).astype(np.int32)
    rho = rng.integers(0, 100, P).astype(np.int32)
    for es in (False, True):
        for minsup in (0, 1, 20):
            r = jref.nlist_intersect_ref(up, upo, uf, vp, vpo, vf, ul, vl,
                                         rho, jnp.int32(minsup),
                                         early_stop=es)
            t = tops.nlist_intersect(*(_t(a) for a in (up, upo, uf, vp, vpo,
                                                       vf)),
                                     ul, vl, rho, minsup, early_stop=es)
            for a, b in zip(t, r, strict=True):
                assert _eq(a, b), (es, minsup)
        p = pallas_merge(up, upo, uf, vp, vpo, vf, ul, vl, rho,
                         jnp.int32(20), early_stop=es, interpret=True)
        t = tops.nlist_intersect(*(_t(a) for a in (up, upo, uf, vp, vpo,
                                                   vf)),
                                 ul, vl, rho, 20, early_stop=es)
        for a, b in zip(t, p, strict=True):
            assert _eq(a, b), es


def test_compact_codes_matches_ref():
    rng = np.random.default_rng(5)
    cap = 64
    codes = rng.integers(-1000, 1000, (cap, 3)).astype(np.int32)
    perm = rng.permutation(cap)[:40].astype(np.int32)
    perm[::3] = -1
    perm[1::7] = cap + 2
    got = tops.compact_codes(_t(codes), perm)
    want = jref.compact_gather_ref(jnp.asarray(codes), jnp.asarray(perm))
    assert _eq(got, want)


def test_nlist_kernel_wrappers_reject_cpu_tensors():
    c = torch.zeros((64, 3), dtype=torch.int32)
    r = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tnl.nlist_merge(c, r, r, r, r, r, 1, lu=8)
    with pytest.raises(ValueError, match="CUDA"):
        tnl.zmerge_scatter(c, torch.zeros((2, 8), dtype=torch.int32), r, r,
                           r, r, r)
    assert tnl.nlist_merge.launches == 0
    assert tnl.zmerge_scatter.launches == 0


# ---------------------------------------------------------------------------
# the N-list pool
# ---------------------------------------------------------------------------

def _same_pools(t: NListPool, j: JNListPool, step=None):
    assert t.codes.numpy().tolist() == np.asarray(j.codes).tolist(), step
    for attr in ("_row_off", "_row_len", "_row_cap", "_free_rows", "_free",
                 "_bump", "capacity", "live_codes", "peak_codes",
                 "total_alloc_codes", "grows", "compactions",
                 "last_compaction_occupancy", "n_live_rows"):
        assert getattr(t, attr) == getattr(j, attr), (step, attr)


def test_nlist_pool_trace_matches_reference():
    """alloc / write / free / split / grow / compact / compact_if_sparse:
    the same row ids, offsets, free lists and slab contents."""
    rng = np.random.default_rng(9)
    j, t = JNListPool(capacity=64), NListPool(capacity=64, device="cpu")
    live = []

    def alloc(lengths):
        rj, rt = j.alloc_rows(lengths), t.alloc_rows(lengths)
        assert np.array_equal(rj, rt)
        arrays = [rng.integers(0, 500, (n, 3)).astype(np.int32)
                  for n in lengths]
        j.write_rows(rj, arrays)
        t.write_rows(rt, arrays)
        live.extend(rt.tolist())
        return arrays

    def free(positions):
        ids = [live[i] for i in positions]
        j.free_rows(ids)
        t.free_rows(ids)
        for i in sorted(positions, reverse=True):
            del live[i]

    alloc([3, 9, 40, 200, 1])
    _same_pools(t, j, "alloc")
    free([3])                         # a 512 extent goes free
    alloc([5, 6, 30])                 # served by splitting it
    _same_pools(t, j, "split")
    alloc([600, 2500])                # grows the slab
    _same_pools(t, j, "grow")
    for r in live[:3]:
        assert np.array_equal(t.read_row(r), j.read_row(r))
    free([0, 2, 5, 6])
    t.set_length(live[0], 1)
    j.set_length(live[0], 1)
    t.compact(reserve=10)
    j.compact(reserve=10)
    _same_pools(t, j, "compact")
    for r in live:
        assert np.array_equal(t.read_row(r), j.read_row(r))
    free(list(range(len(live) - 1)))
    assert t.compact_if_sparse(0.9, reserve=4) == j.compact_if_sparse(
        0.9, reserve=4)
    _same_pools(t, j, "compact_if_sparse")
    alloc([70000 // 3])               # past the largest tuned bucket
    _same_pools(t, j, "big")
    assert np.array_equal(t.offsets(live), j.offsets(live))
    assert np.array_equal(t.lengths(live), j.lengths(live))
    assert t.grows >= 1 and t.compactions >= 1


def test_nlist_pool_from_arrays_round_trip():
    """A JAX pool's state goes in; the port's pool allocates exactly as the
    JAX pool continues, and its state comes out again."""
    rng = np.random.default_rng(2)
    j = JNListPool(capacity=64)
    rows = j.alloc_rows([3, 40, 9, 600])
    j.write_rows(rows, [rng.integers(0, 99, (n, 3)).astype(np.int32)
                        for n in (3, 40, 9, 600)])
    j.free_rows([rows[1], rows[3]])
    t = NListPool.from_arrays(np.asarray(j.codes), j._row_off, j._row_len,
                              j._row_cap, j._free_rows, j._free, j._bump,
                              device="cpu")
    state = t.to_arrays()
    assert np.array_equal(state["codes"], np.asarray(j.codes))
    assert state["row_off"].tolist() == j._row_off
    assert state["free_rows"].tolist() == j._free_rows
    assert {b: v.tolist() for b, v in state["free"].items()} == j._free
    assert state["bump"] == j._bump and t.live_codes == j.live_codes
    again = NListPool.from_arrays(device="cpu", **state)
    assert again.to_arrays()["row_cap"].tolist() == j._row_cap
    for lengths in ([5, 30], [100, 1, 2000]):
        assert np.array_equal(t.alloc_rows(lengths), j.alloc_rows(lengths))
        assert t._row_off == j._row_off and t._free == j._free
    with pytest.raises(ValueError, match="int32"):
        NListPool.from_arrays(np.zeros((64, 3), np.int64), [], [], [], [],
                              {}, 0, device="cpu")
    with pytest.raises(TypeError):
        NListPool(64)                 # no default device


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def test_device_prepost_matches_smoke_baseline():
    base = json.loads((ROOT / "benchmarks/baselines/BENCH_smoke.json")
                      .read_text())["datasets"]
    for regime, (db, minsup) in _smoke().items():
        for tag, es in (("es", True), ("full", False)):
            out, st = mine_prepost_device(db, minsup, early_stop=es,
                                          device="cpu")
            got, want = _counters(st), base[regime]["prepost"][tag]
            assert len(out) == base[regime]["frequent_itemsets"]
            assert {k: got[k] for k in got if k in want} == {
                k: want[k] for k in got if k in want}, (regime, tag)
            o_out, o_st = oracle_mine(db, minsup, "prepost", early_stop=es)
            assert out == o_out
            assert (st.comparisons, st.es_checks, st.es_aborts) == (
                o_st.comparisons, o_st.es_checks, o_st.es_aborts)
    assert base["powerlaw"]["prepost"]["es"]["comparisons"] == 57952


@pytest.mark.parametrize("knobs", [dict(inflight=1), dict(inflight=2),
                                   dict(autotune_chunk=True, pair_chunk=64,
                                        compact_occupancy=1.0)])
@pytest.mark.parametrize("regime", ["powerlaw", "dense", "longpat"])
def test_device_prepost_matches_jax_engine_on_smoke(regime, knobs):
    db, minsup = _smoke()[regime]
    for es in (True, False):
        out, st = mine_prepost_device(db, minsup, early_stop=es,
                                      device="cpu", **knobs)
        j_out, j_st = j_mine_prepost(db, minsup, early_stop=es,
                                     backend="jnp", **knobs)
        assert out == j_out, (regime, knobs, es)
        assert _counters(st) == _counters(j_st), (regime, knobs, es)


@pytest.mark.parametrize("regime", REGIMES)
def test_device_prepost_equals_oracle_on_equivalence_regimes(regime):
    """Itemsets equal the oracle's, and comparisons / es_checks equal its
    counts exactly (invariant I4); ES never raises comparisons."""
    for seed in range(4):
        db, minsup = gen_db(regime, seed)
        cmps = {}
        for es in (False, True):
            out, st = mine_prepost_device(db, minsup, early_stop=es,
                                          pair_chunk=2, device="cpu")
            o_out, o_st = oracle_mine(db, minsup, "prepost", early_stop=es)
            assert out == o_out, (regime, seed, es)
            assert (st.comparisons, st.es_checks) == (o_st.comparisons,
                                                      o_st.es_checks)
            cmps[es] = st.comparisons
        assert cmps[True] <= cmps[False]


def test_mine_tree_equals_mine():
    db, minsup = _smoke()["dense"]
    out, st = DevicePrePost(device="cpu").mine(db, minsup)
    out2, st2 = DevicePrePost(device="cpu").mine_tree(
        toracle.PPCTree(db, minsup), minsup)
    assert out == out2 and _counters(st) == _counters(st2)


def test_prepost_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrePost()
    with pytest.raises(RuntimeError, match="CUDA"):
        mine_prepost_device([[1, 2]], 1)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--scheme", "prepost"],
    ["--scheme", "prepost", "--no-es"],
    ["--engine", "oracle", "--scheme", "prepost"],
    ["--engine", "oracle", "--scheme", "adaptive"],
])
def test_cli_cpu_prepost_and_oracle_match_reference_cli(extra, tmp_path,
                                                        monkeypatch, capsys):
    from repro.core import cli as jcli
    from repro_torch.core import cli as tcli

    db, _ = _smoke()["longpat"]
    path = _fimi(tmp_path, db)
    tcli.main(["--input", path, "--minsup", "120", "--device", "cpu",
               "--json-out", str(tmp_path / "t.json"), *extra])
    t_err = capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", [
        "repro-mine", "--input", path, "--minsup", "120", "--json-out",
        str(tmp_path / "j.json"), *extra])
    jcli.main()
    j_err = capsys.readouterr().err
    t = json.loads((tmp_path / "t.json").read_text())
    assert t == json.loads((tmp_path / "j.json").read_text())
    assert len(t) > 100

    def stats(err):
        blob = err[err.index("{"):err.index("}") + 1]
        return {k: v for k, v in json.loads(blob).items()
                if not k.endswith("_s")}
    assert stats(t_err) == stats(j_err)
