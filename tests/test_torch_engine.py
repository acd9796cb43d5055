"""The port's data, packing, row store, scheduler, miner and CLI held
against the JAX package, on the CPU (``device="cpu"``: the plain
PyTorch versions of the kernels).

Integer work, so everything is compared exactly: generated databases,
packed rows and suffix tables, allocator slot ids and slab contents,
mined itemsets and every ``DeviceMiningStats`` counter that is not a
time.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import bitmap as jbitmap
from repro.core.eclat import mine_bitmap as j_mine_bitmap
from repro.core.oracle import mine as oracle_mine
from repro.core.rowstore import DeviceRowStore as JRowStore
from repro.data import transactions as jdata

from repro_torch.core import bitmap as tbitmap
from repro_torch.core import guards as tguards
from repro_torch.core.eclat import BitmapMiner, mine_bitmap
from repro_torch.core.rowstore import DeviceRowStore
from repro_torch.data import transactions as tdata

from test_equivalence import REGIMES, gen_db

ROOT = Path(__file__).resolve().parents[1]

# Stats fields that are wall-clock times, not counters.
_TIMES = {"runtime_s", "assemble_s", "resolve_s"}


def _smoke():
    """The three smoke regimes of ``benchmarks/bench_paper.py``."""
    return {
        "powerlaw": (tdata.gen_powerlaw_baskets(
            n_trans=300, n_items=200, avg_trans_len=6, seed=0), 3),
        "dense": (tdata.gen_dense_tabular(
            n_trans=500, n_cols=9, vals_per_col=4, seed=0), 175),
        "longpat": (tdata.gen_dense_tabular(
            n_trans=400, n_cols=10, vals_per_col=3, correlation=0.95,
            n_classes=2, seed=1), 120),
    }


def _counters(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items() if k not in _TIMES}


# ---------------------------------------------------------------------------
# data: generators and packing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_generators_identical_per_seed(seed):
    for name, kw in (("gen_quest", dict(n_trans=120, n_items=40)),
                     ("gen_powerlaw_baskets", dict(n_trans=150, n_items=60)),
                     ("gen_bipartite", dict(n_users=80, n_items=50)),
                     ("gen_dense_tabular", dict(n_trans=90))):
        assert (getattr(tdata, name)(seed=seed, **kw)
                == getattr(jdata, name)(seed=seed, **kw)), name
    for name in ("chess-like", "retail-like"):
        assert tdata.make_dataset(name, seed) == jdata.make_dataset(name,
                                                                    seed)
    assert tdata.DATASET_REPLICAS == jdata.DATASET_REPLICAS
    assert tdata.PAPER_REPLICAS == jdata.PAPER_REPLICAS


@pytest.mark.parametrize("name,scale", [("kosarak-paper", 0.01),
                                        ("pumsb-paper", 0.05)])
def test_stream_paper_dataset_byte_identical(name, scale):
    t, tms = tdata.stream_paper_dataset(name, scale=scale, seed=1)
    j, jms = jdata.stream_paper_dataset(name, scale=scale, seed=1)
    assert tms == jms and t.items == j.items
    assert t.bitmaps.dtype == np.uint32
    assert t.bitmaps.tobytes() == j.bitmaps.tobytes()
    assert np.array_equal(t.supports, j.supports)
    assert (t.n_trans, t.minsup, t.block_words) == (j.n_trans, j.minsup,
                                                    j.block_words)


def _assert_bdb_equal(t, j):
    assert t.items == j.items
    assert t.bitmaps.dtype == np.uint32 and np.array_equal(t.bitmaps,
                                                           j.bitmaps)
    assert t.supports.dtype == np.int32 and np.array_equal(t.supports,
                                                           j.supports)
    assert (t.n_trans, t.minsup, t.block_words) == (j.n_trans, j.minsup,
                                                    j.block_words)


@pytest.mark.parametrize("block_words", [1, 8, 128])
def test_bitmapdb_from_db_matches_reference(block_words):
    cases = list(_smoke().values())
    cases += [gen_db(regime, seed) for regime in REGIMES for seed in (0, 1)]
    for db, minsup in cases:
        t = tbitmap.BitmapDB.from_db(db, minsup, block_words)
        j = jbitmap.BitmapDB.from_db(db, minsup, block_words)
        _assert_bdb_equal(t, j)
        assert np.array_equal(tbitmap.suffix_popcounts_np(t.bitmaps),
                              jbitmap.suffix_popcounts_np(j.bitmaps))
        for r in range(min(t.n_items, 3)):
            assert np.array_equal(tbitmap.unpack_row(t.bitmaps[r]),
                                  jbitmap.unpack_row(j.bitmaps[r]))


def test_bitmapdb_arrays_round_trip_with_reference():
    """The state carried across: a JAX BitmapDB's fields go in, the
    port's come out, and they build the same JAX BitmapDB again."""
    db, minsup = _smoke()["powerlaw"]
    j = jbitmap.BitmapDB.from_db(db, minsup, 8)
    t = tbitmap.BitmapDB.from_arrays(j.items, j.bitmaps, j.supports,
                                     j.n_trans, j.minsup, j.block_words)
    _assert_bdb_equal(t, j)
    _assert_bdb_equal(jbitmap.BitmapDB(**t.to_arrays()), j)
    with pytest.raises(ValueError, match="uint32"):
        tbitmap.BitmapDB.from_arrays(j.items, j.bitmaps.view(np.int32),
                                     j.supports, j.n_trans, j.minsup, 8)
    with pytest.raises(ValueError, match="block_words"):
        tbitmap.BitmapDB.from_arrays(j.items, j.bitmaps, j.supports,
                                     j.n_trans, j.minsup, 4)


def test_pack_tidlists_matches_reference():
    rng = np.random.default_rng(1)
    tl = [sorted(rng.choice(1000, size=k, replace=False).tolist())
          for k in (0, 1, 31, 32, 500)]
    for bw in (1, 4, 128):
        assert np.array_equal(tbitmap.pack_tidlists(tl, 1000, bw),
                              jbitmap.pack_tidlists(tl, 1000, bw))
    with pytest.raises(ValueError):
        tbitmap.pack_tidlists([[1000]], 1000, 4)
    assert tbitmap.chunk_width_for(30976, 65536, tbitmap.PAIR_CHUNK_BUCKETS,
                                   1024) == 65536
    cols = np.arange(70, dtype=np.int32)
    for n in (1, 64, 65, 70):
        assert np.array_equal(
            tbitmap.bucket_pad(cols[:n], n, tbitmap.PAIR_CHUNK_BUCKETS, -1),
            jbitmap.bucket_pad(cols[:n], n, jbitmap.PAIR_CHUNK_BUCKETS, -1))
    assert all(tbitmap.chunk_width_for(w, c, tbitmap.PAIR_CHUNK_BUCKETS,
                                       1024)
               == jbitmap.chunk_width_for(w, c, jbitmap.PAIR_CHUNK_BUCKETS,
                                          1024)
               for w in (8, 64, 1024, 30976) for c in (64, 4096, 65536))


# ---------------------------------------------------------------------------
# row store: a scripted alloc / free / grow / compact trace
# ---------------------------------------------------------------------------

def test_rowstore_trace_matches_reference():
    import jax.numpy as jnp
    from repro.kernels.ref import screen_and_intersect_ref

    rng = np.random.default_rng(4)
    rows_np = jbitmap.pack_tidlists(
        [sorted(rng.choice(200, size=k, replace=False).tolist())
         for k in (5, 17, 40, 90, 120)], 200, 2)
    j = JRowStore(rows_np, capacity=8)
    t = DeviceRowStore(rows_np, capacity=8)

    def same_slabs():
        assert t.rows.numpy().view(np.uint32).tolist() == np.asarray(
            j.rows).tolist()
        assert np.array_equal(t.suffix.numpy(), np.asarray(j.suffix))

    same_slabs()
    # write children through the fused dispatch so the slab holds more
    # than level-1 rows before it grows and compacts
    slots = j.alloc(3)
    assert np.array_equal(slots, t.alloc(3))
    ua, vb = np.array([0, 1, 3], np.int32), np.array([4, 2, 4], np.int32)
    rho = np.zeros(3, np.int32)
    j.rows, j.suffix, *_ = screen_and_intersect_ref(
        j.rows, j.suffix, ua, vb, slots, rho, jnp.int32(1))
    from repro_torch.kernels import ops
    ops.screen_and_intersect(t.rows, t.suffix, ua, vb, slots, rho, 1)
    same_slabs()
    live = list(range(5)) + slots.tolist()
    # "free" takes positions in the live list; compaction renumbers it
    for step in (("free", [1, 5]), ("alloc", 9), ("free", [0, 6, 7]),
                 ("alloc", 70), ("free", list(range(10, 60))),
                 ("compact", 3), ("free", [2]), ("alloc", 20),
                 ("compact_if", 0.9), ("free", list(range(5, 40))),
                 ("compact_if", 0.9), ("alloc", 3), ("compact", 0)):
        op, arg = step
        if op == "alloc":
            got = t.alloc(arg)
            assert np.array_equal(j.alloc(arg), got), step
            live += got.tolist()
        elif op == "free":
            ids = [live[i] for i in arg]
            j.free(ids)
            t.free(ids)
            live = [s for i, s in enumerate(live) if i not in set(arg)]
        else:
            if op == "compact":
                jm, tm = j.compact(reserve=arg), t.compact(reserve=arg)
            else:
                jm = j.compact_if_sparse(arg, reserve=4)
                tm = t.compact_if_sparse(arg, reserve=4)
            assert (jm is None) == (tm is None), step
            if jm is not None:
                assert np.array_equal(jm, tm), step
                live = tm[live].tolist()
        same_slabs()
        for attr in ("capacity", "n_live", "grows", "compactions",
                     "peak_live", "peak_capacity", "peak_device_words",
                     "last_compaction_occupancy"):
            assert getattr(t, attr) == getattr(j, attr), (step, attr)
    assert t.grows > 0 and t.compactions >= 2


@pytest.mark.parametrize("n_shards,shard", [(1, 0), (2, 0), (2, 1)])
def test_rowstore_level1_suffix_tables_equal_the_host_table(n_shards, shard):
    """The suffix tables the store computes from its uploaded rows equal
    the host table of its local block shard (the tail shard's pad block
    counts zero); the slots past the level-1 rows stay zero."""
    rng = np.random.default_rng(29 + 2 * n_shards + shard)
    n, nb, bw = 9, 5, 3
    rows = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64
                        ).astype(np.uint32)
    rows[0] |= np.uint32(1 << 31)          # bit 31 set in every word
    rows[1] = 0                            # an empty row
    t = DeviceRowStore(rows, capacity=16, n_shards=n_shards, shard=shard)
    nbl = t.local_blocks
    local = np.zeros((n, nbl, bw), np.uint32)
    part = rows[:, shard * nbl:(shard + 1) * nbl]
    local[:, :part.shape[1]] = part
    assert np.array_equal(t.suffix[:n].numpy(),
                          tbitmap.suffix_popcounts_np(local))
    assert t.capacity > n and not t.suffix[n:].any()


# ---------------------------------------------------------------------------
# the miner: itemsets and every counter equal to the JAX engine's
# ---------------------------------------------------------------------------

_KNOBS = {
    "default": dict(),
    "serial": dict(inflight=1),
    "autotune": dict(autotune_chunk=True, pair_chunk=64),
    "forced-compaction": dict(compact_occupancy=1.0, pair_chunk=256),
}


@pytest.mark.parametrize("knobs", list(_KNOBS))
@pytest.mark.parametrize("regime", ["powerlaw", "dense", "longpat"])
def test_miner_matches_jax_engine_on_smoke(regime, knobs):
    db, minsup = _smoke()[regime]
    kw = dict(block_words=8, **_KNOBS[knobs])
    ref_out, _ = oracle_mine(db, minsup, "eclat", early_stop=True)
    for es in (True, False):
        out, st = mine_bitmap(db, minsup, "eclat", early_stop=es,
                              device="cpu", **kw)
        j_out, j_st = j_mine_bitmap(db, minsup, "eclat", early_stop=es,
                                    backend="jnp", **kw)
        assert out == j_out == ref_out, (regime, knobs, es)
        assert _counters(st) == _counters(j_st), (regime, knobs, es)


def test_miner_matches_smoke_baseline():
    """The committed smoke baseline (written by the JAX engine) is a table
    of expected values for the port at block_words=8."""
    base = json.loads((ROOT / "benchmarks/baselines/BENCH_smoke.json")
                      .read_text())["datasets"]
    for regime, (db, minsup) in _smoke().items():
        for tag, es in (("es", True), ("full", False)):
            out, st = mine_bitmap(db, minsup, early_stop=es, block_words=8,
                                  device="cpu")
            want = base[regime][tag]
            got = _counters(st)
            assert len(out) == base[regime]["frequent_itemsets"]
            assert {k: got[k] for k in got if k in want} == {
                k: want[k] for k in got if k in want}, (regime, tag)


@pytest.mark.parametrize("regime", REGIMES)
def test_miner_matches_oracle_and_jax_on_equivalence_regimes(regime):
    for seed in range(3):
        db, minsup = gen_db(regime, seed)
        expected, _ = oracle_mine(db, minsup, "eclat", early_stop=False)
        for es in (False, True):
            out, st = mine_bitmap(db, minsup, early_stop=es, block_words=4,
                                  device="cpu")
            j_out, j_st = j_mine_bitmap(db, minsup, early_stop=es,
                                        block_words=4, backend="jnp")
            assert out == expected == j_out, (regime, seed, es)
            assert _counters(st) == _counters(j_st), (regime, seed, es)


def test_miner_runs_under_purity_guard():
    db, minsup = gen_db("powerlaw", 1)
    m = BitmapMiner(block_words=4, device="cpu")
    seen = []
    real = m.evaluate_pairs

    def spy(cols):
        seen.append(tguards.purity_guard_active())
        return real(cols)

    m.evaluate_pairs = spy
    m.mine(db, minsup)
    assert seen and all(seen)
    assert not tguards.purity_guard_active()


def test_guard_depth_and_escape():
    assert not tguards.purity_guard_active()
    with tguards.device_purity_guard():
        assert tguards.purity_guard_active()
        with tguards.host_sync("test escape"):
            assert not tguards.purity_guard_active()
        assert tguards.purity_guard_active()
    assert not tguards.purity_guard_active()
    with pytest.raises(ValueError):
        with tguards.host_sync(""):
            pass
    with pytest.raises(KeyError), tguards.device_purity_guard():
        raise KeyError("restored on exceptions too")
    assert not tguards.purity_guard_active()


# ---------------------------------------------------------------------------
# device selection
# ---------------------------------------------------------------------------

def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="CUDA"):
        BitmapMiner()
    with pytest.raises(RuntimeError, match="CUDA"):
        mine_bitmap([[1, 2]], 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_later_schemes_raise_not_implemented():
    """The schemes a later slice was to bring are ported now: they build,
    and only an unknown scheme (or an adaptive knob on another scheme)
    raises."""
    for scheme in ("declat", "adaptive"):
        assert BitmapMiner(scheme=scheme, device="cpu").scheme == scheme
    with pytest.raises(ValueError):
        BitmapMiner(scheme="nope", device="cpu")
    with pytest.raises(ValueError, match="diff_density"):
        BitmapMiner(scheme="eclat", diff_density=0.5, device="cpu")


# ---------------------------------------------------------------------------
# CLI and import hygiene
# ---------------------------------------------------------------------------

def _fimi(tmp_path, db):
    p = tmp_path / "db.fimi"
    p.write_text("\n".join(" ".join(map(str, t)) for t in db if t) + "\n")
    return str(p)


def test_cli_cpu_matches_reference_cli(tmp_path, monkeypatch, capsys):
    from repro.core import cli as jcli
    from repro_torch.core import cli as tcli

    db, _ = _smoke()["dense"]
    path = _fimi(tmp_path, db)
    tcli.main(["--input", path, "--minsup", "150", "--device", "cpu",
               "--json-out", str(tmp_path / "t.json")])
    monkeypatch.setattr(sys, "argv", [
        "repro-mine", "--input", path, "--minsup", "150", "--engine",
        "oracle", "--json-out", str(tmp_path / "j.json")])
    jcli.main()
    t = json.loads((tmp_path / "t.json").read_text())
    assert t == json.loads((tmp_path / "j.json").read_text())
    assert len(t) > 10
    err = capsys.readouterr().err
    assert "device=cpu" in err and '"word_ops"' in err


@pytest.mark.parametrize("argv,msg", [
    (["--engine", "oracle"], "PrePost+ slice"),
    (["--scheme", "declat"], "dEclat/adaptive slice"),
    (["--scheme", "prepost"], "PrePost+ slice"),
])
def test_cli_later_choices_exit_with_roadmap_item(argv, msg, capsys):
    """The choices that waited for a later slice (``msg`` names it) now
    mine on the CPU and report their engine's counters."""
    from repro_torch.core import cli as tcli
    tcli.main(["--dataset", "chess-like", "--minsup", "0.7", "--device",
               "cpu", *argv])
    err = capsys.readouterr().err
    assert "frequent itemsets:" in err and "not ported" not in err, msg
    assert ('"comparisons"' in err) == ("declat" not in argv), msg


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port loads no ``jax`` and no
    ``repro``; ``chip_smoke.py`` imports neither either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "new = {'repro_torch.core.distributed', 'repro_torch.launch.mesh',\n"
        "       'repro_torch.launch.multihost',\n"
        "       'repro_torch.launch.forcedevices',\n"
        "       'repro_torch.launch.train', 'repro_torch.train.optimizer',\n"
        "       'repro_torch.train.train_step',\n"
        "       'repro_torch.train.checkpoint', 'repro_torch.tree',\n"
        "       'repro_torch.data.lm_data',\n"
        "       'repro_torch.configs.mixtral_8x22b',\n"
        "       'repro_torch.configs.deepseek_v2_236b',\n"
        "       'repro_torch.configs.sasrec', 'repro_torch.configs.din',\n"
        "       'repro_torch.configs.xdeepfm',\n"
        "       'repro_torch.models.gnn', 'repro_torch.data.graph_data',\n"
        "       'repro_torch.distributed.sharding',\n"
        "       'repro_torch.distributed.compression',\n"
        "       'repro_torch.distributed.collectives',\n"
        "       'repro_torch.launch.gnn_ranks',\n"
        "       'repro_torch.configs.graphsage_reddit',\n"
        "       'repro_torch.configs.fim_eclat',\n"
        "       'repro_torch.launch.cells', 'repro_torch.launch.dryrun',\n"
        "       'repro_torch.launch.hillclimb',\n"
        "       'repro_torch.roofline.analysis',\n"
        "       'repro_torch.roofline.comms',\n"
        "       'repro_torch.roofline.counters'}\n"
        "print(len(mods), bad, sorted(new - set(mods)))\n"
        "sys.exit(1 if bad or len(mods) < 12 or new - set(mods) else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & {"jax", "jaxlib", "repro"}, names


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a CUDA device (or without the rest of the repo next to it)
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        r = subprocess.run([sys.executable, str(script)], env=env,
                           capture_output=True, text=True, timeout=120,
                           cwd=tmp_path)
        assert r.returncode != 0, script
        assert '"ok"' not in r.stdout, script
