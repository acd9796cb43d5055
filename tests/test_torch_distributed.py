"""The port's sharded miner held against the JAX package, on the CPU.

* the plain sharded dispatch (``repro_torch.kernels.ref.
  screen_and_intersect_sharded_ref``) against the JAX ref, in one process,
  bit for bit;
* the per-pair-threshold scan against the JAX ``_blocked_es_scan`` /
  ``_blocked_diff_scan``;
* the sharded row store's layout against the JAX one;
* in gloo worlds of 1, 2 and 4 ranks (``repro_torch.launch.forcedevices.
  run_ranks``, every rank with a timeout): the sharded dispatch
  (``ops.ShardedScreen``) against the plain version, and the
  ``DistributedMiner`` against ``mine_bruteforce``, the JAX single-device
  engine's counters (single-real-block databases, where every mesh must
  match them), the cls invariance on a multi-block database, the JAX
  ``DistributedMiner``'s counters on the same mesh shapes (one JAX
  subprocess on forced host devices), and compaction on a 2 x 2 mesh.

The ranks run ``tests/torch_dist_ranks.py``, which imports no JAX.
"""

import functools
import json
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core.bitmap import popcount32_np, suffix_popcounts_np
from repro.core.eclat import BitmapMiner as JBitmapMiner
from repro.core.oracle import mine_bruteforce
from repro.core.rowstore import _local_suffix_tables
from repro.kernels import ref as jref

from repro_torch.core.rowstore import DeviceRowStore
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch.forcedevices import run_ranks

import torch_dist_ranks as ranks

ROOT = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 90.0
_I32_MIN = -(2 ** 31)

SHAPES = [(1, 1), (2, 1), (1, 2), (2, 2)]


def _t(a: np.ndarray) -> "torch.Tensor":
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _rows(r, cap, nb, bw, n_live):
    rows = np.zeros((cap, nb, bw), np.uint32)
    x = r.integers(0, 2 ** 32, (n_live, nb, bw), dtype=np.uint64)
    x &= r.integers(0, 2 ** 32, (n_live, nb, bw), dtype=np.uint64)
    rows[:n_live] = x.astype(np.uint32)
    rows[:3, 1 % nb] = 0                   # zero-mass blocks
    rows[3, :] = 0                         # an empty row
    return rows


def _rho(rows, ua, mode, r):
    if mode == "and":
        return r.integers(0, 100, ua.size).astype(np.int32)
    return popcount32_np(rows).reshape(rows.shape[0], -1).sum(1).astype(
        np.int32)[ua]


# -- the plain sharded dispatch against the JAX ref -------------------------

@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("mode", ["and", "andnot"])
@pytest.mark.parametrize("n_cls", [1, 2])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_ref_matches_jax(n_shards, n_cls, mode, early_stop):
    """Bound, count, blocks, alive and both slabs (the untouched slots
    too) bit for bit, with a padded block axis (5 real blocks) for 2 and 4
    shards and a pad slot (== capacity)."""
    r = np.random.default_rng(17 * n_shards + n_cls)
    cap, nb_real, bw, n = 32, 5, 4, 12
    nb = -(-nb_real // n_shards) * n_shards
    rows = np.zeros((cap, nb, bw), np.uint32)
    rows[:, :nb_real] = _rows(r, cap, nb_real, bw, 20)
    suffix = _local_suffix_tables(rows, n_shards)
    ua = r.integers(0, 20, n).astype(np.int32)
    vb = r.integers(0, 20, n).astype(np.int32)
    slots = np.arange(20, 20 + n, dtype=np.int32)
    slots[-1] = cap
    rho = _rho(rows, ua, mode, r)
    for minsup in (0, 3, 20, 60):
        want = jref.screen_and_intersect_sharded_ref(
            rows, suffix, ua, vb, slots, rho, jnp.int32(minsup),
            jnp.int32(nb_real), n_shards=n_shards, n_cls=n_cls, mode=mode,
            early_stop=early_stop)
        got = tref.screen_and_intersect_sharded_ref(
            _t(rows), _t(suffix), _t(ua), _t(vb), _t(slots), _t(rho), minsup,
            nb_real, n_shards=n_shards, n_cls=n_cls, mode=mode,
            early_stop=early_stop)
        names = ("rows", "suffix", "bound", "count", "blocks", "alive")
        for name, w, g in zip(names, want, got, strict=True):
            assert np.array_equal(_np(w), g.numpy()), (minsup, name)


def test_sharded_ref_cls_must_divide_pairs():
    v = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_cls"):
        tref.screen_and_intersect_sharded_ref(
            torch.zeros((4, 1, 2), dtype=torch.int32),
            torch.zeros((4, 2), dtype=torch.int32), v, v, v, v, 1,
            n_shards=1, n_cls=2)


@pytest.mark.parametrize("mode", ["and", "andnot", "diff"])
def test_per_pair_threshold_scan_matches_jax(mode):
    """``ops.bitmap_intersect_es`` / ``ops.bitmap_diff_es`` with a per-pair
    ``thr`` (random, <= 0, INT32_MIN, above every bound) against the JAX
    scans with the same vector."""
    r = np.random.default_rng(5)
    P, nb, bw = 40, 6, 4
    U = _rows(r, P, nb, bw, P)
    V = _rows(r, P, nb, bw, P)
    su = suffix_popcounts_np(U)
    sv = suffix_popcounts_np(V)
    rho = su[:, 0].copy()
    thr = r.integers(-50, nb * bw * 32, P).astype(np.int32)
    thr[:4] = (_I32_MIN, -1, 0, 2 ** 31 - 1)
    if mode == "diff":
        want = jref._blocked_diff_scan(jnp.asarray(U), jnp.asarray(V), su,
                                       rho, thr)
        got = ops.bitmap_diff_es(_t(U), _t(V), _t(su), _t(rho), 0,
                                 thr=_t(thr))
    else:
        want = jref._blocked_es_scan(jnp.asarray(U), jnp.asarray(V), su, sv,
                                     rho, thr, mode=mode)
        got = ops.bitmap_intersect_es(_t(U), _t(V), _t(su), _t(sv), _t(rho),
                                      0, mode=mode, thr=_t(thr))
    for w, g in zip(want, got, strict=True):
        assert np.array_equal(_np(w), g.numpy())
    # Thresholds at or below 0 never kill (every bound here is >= 0);
    # INT32_MAX kills at block 0.
    assert got[3][:3].all() and not bool(got[3][3])
    assert int(got[2][3]) == (0 if mode == "diff" and su[3, 0] == su[3, 1]
                              else 1)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_store_layout_matches_jax(n_shards):
    """Each shard's local slab and suffix table, side by side, are the JAX
    store's padded rows and ``_local_suffix_tables``; peak_device_words
    counts every shard's slab (the JAX store's global figure)."""
    r = np.random.default_rng(n_shards)
    rows = _rows(r, 7, 5, 4, 7)
    nb = -(-5 // n_shards) * n_shards
    padded = np.zeros((7, nb, 4), np.uint32)
    padded[:, :5] = rows
    want_suffix = _local_suffix_tables(padded, n_shards)
    stores = [DeviceRowStore(rows, capacity=16, n_shards=n_shards, shard=s)
              for s in range(n_shards)]
    got_rows = np.concatenate([s.rows[:7].numpy() for s in stores], axis=1)
    got_suffix = np.concatenate([s.suffix[:7].numpy() for s in stores],
                                axis=1)
    assert np.array_equal(got_rows, padded.view(np.int32))
    assert np.array_equal(got_suffix, want_suffix)
    for s in stores:
        assert s.n_blocks == nb and s.local_blocks == nb // n_shards
        assert s.peak_device_words == 64 * (nb * 4 + want_suffix.shape[1])
        s.alloc(60)                       # grows every shard alike
        assert s.rows.shape == (128, nb // n_shards, 4)
        assert s.peak_device_words == 128 * (nb * 4 + want_suffix.shape[1])


# -- gloo worlds: the sharded dispatch --------------------------------------

@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
def test_sharded_dispatch_gloo_matches_plain(shape):
    """Every rank's dispatch on its block shard against the plain sharded
    dispatch in one process (``torch_dist_ranks.check_dispatch``)."""
    ranks.check_dispatch(shape, "cpu", RANK_TIMEOUT_S)


# -- gloo worlds: the DistributedMiner --------------------------------------

def _single_block_dbs():
    """``tests/test_mesh2d.py``'s sweep-1 databases: at most 60
    transactions, one real block at block_words=2."""
    rng = random.Random(11)
    dbs = []
    for _ in range(2):
        ni = rng.randint(5, 8)
        nt = rng.randint(20, 60)
        db = [[i for i in range(ni) if rng.random() < 0.5]
              for _ in range(nt)]
        db = [t for t in db if t]
        dbs.append((db, rng.randint(2, max(2, len(db) // 3))))
    return dbs


SWEEP1 = [dict(scheme=scheme, early_stop=es, capacity=256, block_words=2,
               inflight=inflight, diff_density=dd)
          for scheme, dd in (("eclat", None), ("declat", None),
                             ("adaptive", 0.3))
          for es in (False, True) for inflight in (1, 2)]
SWEEP2 = [dict(kw, capacity=512) for kw in SWEEP1]
JAX_RUN = dict(scheme="eclat", early_stop=True, capacity=512, block_words=2,
               inflight=1)
COMPACT_RUN = dict(scheme="eclat", early_stop=True, capacity=64,
                   block_words=2, inflight=2, compact_occupancy=0.9)


def _multiblock_db():
    rng = np.random.default_rng(2)
    return [list(np.flatnonzero(rng.random(30) < 0.35)) for _ in range(300)]


@functools.lru_cache(maxsize=None)
def _world_runs(shape):
    """Every mining run a mesh shape needs, in one world: the single-block
    sweep on both databases, then on the multi-block database the sweep
    ((1,1) and (1,2)), the run held against the JAX DistributedMiner
    ((2,1), (2,2)) and the compaction run ((2,2))."""
    multi = {(1, 1): SWEEP2, (1, 2): SWEEP2, (2, 1): [JAX_RUN],
             (2, 2): [JAX_RUN, COMPACT_RUN]}[shape]
    jobs = [(db, ms, SWEEP1) for db, ms in _single_block_dbs()]
    jobs.append((_multiblock_db(), 18, multi))
    per_rank = run_ranks(ranks.mine, shape[0] * shape[1], (shape, jobs),
                         timeout_s=RANK_TIMEOUT_S)
    names = ["single0", "single1", "multi"]
    return {name: [r[i] for r in per_rank] for i, name in enumerate(names)}


def _agreed(per_rank):
    """The ranks' results for one run, required equal on every rank."""
    first = per_rank[0]
    for other in per_rank[1:]:
        assert other == first
    return first


@pytest.mark.parametrize("shape", SHAPES)
def test_miner_single_block_counters_equal_jax_engine(shape):
    """On single-real-block databases every mesh shape gives the itemsets
    of ``mine_bruteforce`` and EVERY counter of the JAX single-device
    ``BitmapMiner`` (eclat/declat/adaptive, ES on and off, inflight 1
    and 2), as ``tests/test_mesh2d.py`` requires of the JAX engine."""
    runs = _world_runs(shape)
    for i, (db, ms) in enumerate(_single_block_dbs()):
        bf = mine_bruteforce(db, ms)
        per_rank = runs[f"single{i}"]
        for j, kw in enumerate(SWEEP1):
            got, cnt = _agreed([r[j] for r in per_rank])
            jkw = {k: v for k, v in kw.items() if k != "capacity"}
            _, st = JBitmapMiner(**jkw).mine(db, ms)
            assert got == bf, (shape, i, kw)
            assert cnt == ranks.counters(st), (shape, i, kw)


def test_miner_multiblock_cls_invariant():
    """Multi-block database (300 transactions, minsup 18): (1,1) and (1,2)
    agree on every counter for every scheme, ES on/off, inflight 1/2, and
    their itemsets equal the JAX engine's."""
    a = _world_runs((1, 1))["multi"]
    b = _world_runs((1, 2))["multi"]
    db = _multiblock_db()
    for j, kw in enumerate(SWEEP2):
        got_a, cnt_a = _agreed([r[j] for r in a])
        got_b, cnt_b = _agreed([r[j] for r in b])
        jkw = {k: v for k, v in kw.items() if k != "capacity"}
        want, _ = JBitmapMiner(**jkw).mine(db, 18)
        assert got_a == got_b == want, kw
        assert cnt_a == cnt_b, kw


@functools.lru_cache(maxsize=None)
def _jax_distributed_table():
    """The JAX DistributedMiner's counters on the multi-block database, on
    forced host devices, in one subprocess."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "jax_distributed_counters.py"),
         "--dataset", "multiblock", "--meshes", "2x1,2x2"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_miner_counters_equal_jax_distributed(shape):
    """Block-sharded meshes change the ES counters (shard-local
    thresholds); they must equal the JAX DistributedMiner's on the same
    mesh shape, every counter."""
    want = _jax_distributed_table()[f"{shape[0]}x{shape[1]}"]
    got, cnt = _agreed([r[0] for r in _world_runs(shape)["multi"]])
    assert want.pop("frequent_itemsets") == len(got)
    assert cnt == want


def test_miner_compaction_fires_on_2x2():
    """Aggressive compaction on a 2 x 2 mesh with two groups in flight:
    it fires, and the itemsets stay the JAX engine's."""
    got, cnt = _agreed([r[1] for r in _world_runs((2, 2))["multi"]])
    want, _ = JBitmapMiner(scheme="eclat", block_words=2).mine(
        _multiblock_db(), 18)
    assert got == want
    assert cnt["compactions"] > 0


def test_mining_mesh_rejects_cls_not_dividing_world():
    """``make_mining_mesh(cls=3)`` in a world of 2 raises; the heartbeat's
    all-reduce barrier passes on both ranks."""
    msgs = run_ranks(ranks.mesh_rejects, 2, (3,), timeout_s=RANK_TIMEOUT_S)
    assert all(m and "cls=3" in m for m in msgs), msgs


def test_run_ranks_fails_when_a_rank_fails():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(ranks.fail_on_rank, 2, (1,), timeout_s=RANK_TIMEOUT_S)
