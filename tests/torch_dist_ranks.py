"""Per-rank bodies of the sharded-miner tests (``test_torch_distributed.py``
on the CPU, ``test_torch_cuda.py`` on the card), run in gloo worlds by
``repro_torch.launch.forcedevices.run_ranks``.

A module of its own, importing torch and the port only, so that each
spawned rank starts without JAX, and the card tests run where JAX is not
installed.
"""

import numpy as np
import torch

TIMES = ("runtime_s", "assemble_s", "resolve_s")


def counters(stats) -> dict:
    return {k: v for k, v in stats.as_dict().items() if k not in TIMES}


def mesh_of(shape):
    from repro_torch.launch.mesh import make_mining_mesh
    return make_mining_mesh(block=shape[0], cls=shape[1])


def dispatch(rank, world, shape, cases, device="cpu"):
    """Run ``ops.ShardedScreen`` on this rank's block shard, on
    ``device``, for each case ``(rows, ua, vb, slots, rho, minsup, mode,
    early_stop)`` (``rows`` the full uint32 slab, real blocks only).
    Returns per case ``(shard, local rows, local suffix, bound, count,
    blocks, alive)``, as numpy."""
    from repro_torch.core.rowstore import DeviceRowStore
    from repro_torch.kernels import ops
    if device != "cpu":
        torch.cuda.set_device(torch.device(device))
    mesh = mesh_of(shape)
    out = []
    for rows, ua, vb, slots, rho, minsup, mode, es in cases:
        fused = ops.make_screen_and_intersect_sharded(mesh, mode=mode,
                                                      early_stop=es)
        store = DeviceRowStore(rows, capacity=rows.shape[0], device=device,
                               n_shards=fused.n_shards, shard=fused.shard)
        res = fused(store.rows, store.suffix, ua, vb, slots, rho, minsup,
                    rows.shape[1])
        out.append((fused.shard,) + tuple(t.cpu().numpy() for t in res))
    return out


def mine(rank, world, shape, jobs):
    """For each job ``(db, minsup, runs)``, mine ``db`` with a
    ``DistributedMiner`` on ``shape`` once per knob dict of ``runs``;
    returns, per job, ``[(itemsets, counters)]``."""
    from repro_torch.core.distributed import DistributedMiner
    mesh = mesh_of(shape)
    out = []
    for db, minsup, runs in jobs:
        res = []
        for kw in runs:
            got, st = DistributedMiner(mesh, device="cpu", **kw).mine(
                db, minsup)
            res.append((got, counters(st)))
        out.append(res)
    return out


def mesh_rejects(rank, world, cls):
    """One heartbeat barrier, then ``make_mining_mesh(cls=cls)``: returns
    its error message (None if it built a mesh)."""
    from repro_torch.launch.mesh import make_mining_mesh
    from repro_torch.launch.multihost import Heartbeat
    beat = Heartbeat(1)
    beat.maybe_beat(0)
    assert beat.beats == 1
    try:
        make_mining_mesh(cls=cls)
    except ValueError as e:
        return str(e)
    return None


def fail_on_rank(rank, world, bad):
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def dispatch_cases(r):
    """Sharded-dispatch cases on one 64-row slab of 5 real blocks: both
    modes, ES on and off, three minsups; 13 pairs (no multiple of the
    cls size), the last one's slot at capacity."""
    cap, nb, bw, live = 64, 5, 4, 24
    x = r.integers(0, 2 ** 32, (live, nb, bw), dtype=np.uint64)
    x &= r.integers(0, 2 ** 32, (live, nb, bw), dtype=np.uint64)
    rows = np.zeros((cap, nb, bw), np.uint32)
    rows[:live] = x.astype(np.uint32)
    rows[:3, 1] = 0                        # zero-mass blocks
    rows[3] = 0                            # an empty row
    mass = np.unpackbits(rows.view(np.uint8), axis=None).reshape(
        cap, -1).sum(1).astype(np.int32)
    cases = []
    for mode in ("and", "andnot"):
        for es in (False, True):
            for minsup in (0, 20, 60):
                n = 13
                ua = r.integers(0, live, n).astype(np.int32)
                vb = r.integers(0, live, n).astype(np.int32)
                slots = np.arange(live, live + n, dtype=np.int32)
                slots[-1] = cap
                rho = (r.integers(0, 100, n).astype(np.int32)
                       if mode == "and" else mass[ua])
                cases.append((rows, ua, vb, slots, rho, minsup, mode, es))
    return cases


def check_dispatch(shape, device, timeout_s):
    """Every rank's ``ShardedScreen`` on its block shard (on ``device``)
    against ``ref.screen_and_intersect_sharded_ref`` in this process: the
    per-pair vectors on every rank, and each rank's local slab and suffix
    tables equal to its shard of the plain ones."""
    from repro_torch.core.rowstore import DeviceRowStore
    from repro_torch.kernels import ref
    from repro_torch.launch.forcedevices import run_ranks
    if device != "cpu":
        from repro_torch.kernels import _build
        _build.load()                   # once, before the ranks load it
    cases = dispatch_cases(np.random.default_rng(3))
    out = run_ranks(dispatch, shape[0] * shape[1], (shape, cases, device),
                    timeout_s=timeout_s)
    S = shape[0]
    for i, (rows, ua, vb, slots, rho, minsup, mode, es) in enumerate(cases):
        stores = [DeviceRowStore(rows, capacity=rows.shape[0], n_shards=S,
                                 shard=s) for s in range(S)]
        nbl = stores[0].local_blocks
        want = ref.screen_and_intersect_sharded_ref(
            torch.cat([st.rows for st in stores], dim=1),
            torch.cat([st.suffix for st in stores], dim=1),
            *(torch.from_numpy(a) for a in (ua, vb, slots, rho)), minsup,
            rows.shape[1], n_shards=S, n_cls=1, mode=mode, early_stop=es)
        for rank_out in out:
            shard, lrows, lsuffix, *vecs = rank_out[i]
            key = (shape, mode, es, minsup, shard)
            for w, g in zip(want[2:], vecs, strict=True):
                assert np.array_equal(w.numpy(), g), key
            assert np.array_equal(
                want[0].numpy()[:, shard * nbl:(shard + 1) * nbl], lrows), key
            assert np.array_equal(
                want[1].numpy()[:, shard * (nbl + 1):(shard + 1) * (nbl + 1)],
                lsuffix), key
