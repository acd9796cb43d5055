#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port, on one NVIDIA H100.

    python3 chip_smoke.py                      # every phase (one CUDA device)
    python3 chip_smoke.py --report out.json    # also write the numbers there
    python3 chip_smoke.py --profile traces/    # also profile one main-path run

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and then:

1. holds every kernel against its plain PyTorch version on the card, bit
   for bit (ES scan in both modes, ES on/off, minsup <= 0, bw 1/8/128 up
   to the kosarak-paper row of 242 blocks; the fused dispatch with
   untouched non-survivor and out-of-range slots; compaction of rows,
   suffix tables and (cap, 3) codes with -1 and >= cap entries);
2. mines the three smoke regimes at block_words=8, ES on and off, and
   requires every counter of ``benchmarks/baselines/BENCH_smoke.json``;
3. mines kosarak-paper at scale 0.1, all four rungs, and requires the
   itemset counts and work counters of ``BENCH_full.json``;
4. drives the main path at real size — kosarak-paper at scale 1.0
   (990,000 transactions, 242 blocks of 128 words, an 8192-row slab of
   about 1 GB) through ``BitmapMiner.mine_packed`` — with every kernel's
   launch count set to 0 just before and read just after; then ES off
   must give the same itemsets, every support is recomputed on the host
   from the packed bitmaps, and the largest rung must equal the port's
   plain path on the CPU;
5. holds the main path's first fused dispatch (every level-1 pair on a
   fresh real-size slab) bit for bit against its plain version, then
   times each kernel with CUDA events at the main path's shapes, beside
   its bound, its plain version and (compaction) a PyTorch library call.

It prints the card's name and power limit, a ``kernels`` JSON line and,
last, ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BASELINES = ROOT / "benchmarks" / "baselines"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth,
# and the 32-bit non-tensor rate (67 T/s float32), which is used as the
# peak for the kernels' 32-bit integer operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

SMOKE_KEYS = ("word_ops", "word_ops_full", "device_calls", "peak_rows",
              "scatter_words", "compactions", "screened_out",
              "kernel_aborts", "child_scatters")
FULL_KEYS = ("frequent_itemsets", "word_ops", "word_ops_full",
             "device_calls")
TIME_KEYS = {"runtime_s", "assemble_s", "resolve_s"}


class SmokeFailure(RuntimeError):
    pass


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*parts) -> None:
    print(*parts, flush=True)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------

def _max_err(a, b) -> int:
    """Largest |a - b| over two integer/bool tensors of one shape."""
    import torch
    need(tuple(a.shape) == tuple(b.shape),
         f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def phase_kernels(dev, rng) -> dict:
    import torch
    from repro_torch.kernels import compact as kcompact
    from repro_torch.kernels import ops, ref

    def rows(n, nb, bw, density):
        u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        for _ in range(density):            # each AND halves the density
            u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)

    err = {"bitmap_intersect_es": 0, "compact_gather": 0}
    n_checks = {"bitmap_intersect_es": 0, "compact_gather": 0}

    def agree(name, got, want, what):
        e = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
        err[name] = max(err[name], e)
        n_checks[name] += 1
        need(e == 0, f"{name} disagrees with its plain version: {what} "
                     f"(max abs err {e})")

    from repro_torch.core.bitmap import suffix_popcounts
    # Standalone scan: both modes, ES on/off, minsup <= 0, bw 1/8/128.
    for bw, nb, P, density in ((1, 9, 33, 1), (8, 7, 33, 1), (128, 3, 33, 1),
                               (128, 242, 64, 3)):
        U, V = rows(P, nb, bw, density), rows(P, nb, bw, density)
        su, sv = suffix_popcounts(U), suffix_popcounts(V)
        rho = su[:, 0].contiguous()
        nt = nb * bw * 32
        for mode in ("and", "andnot"):
            for minsup in (-(2 ** 31), -4, 0, 1, nt // 64, nt // 16,
                           nt // 8, nt):
                got = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup,
                                              mode=mode)
                want = ops.bitmap_intersect_es(U, V, su, sv, rho, minsup,
                                               mode=mode, backend="plain")
                agree("bitmap_intersect_es", got, want,
                      f"scan bw={bw} nb={nb} mode={mode} minsup={minsup}")
        got = (ops.bitmap_count(U, V),
               *ops.bitmap_intersect_full(U, V, mode="andnot"),
               *ops.screen_pairs(U[:, 0].contiguous(), V[:, 0].contiguous(),
                                 su[:, 1], sv[:, 1], rho, nt // 64))
        want = (ops.bitmap_count(U, V, backend="plain"),
                *ops.bitmap_intersect_full(U, V, mode="andnot",
                                           backend="plain"),
                *ops.screen_pairs(U[:, 0], V[:, 0], su[:, 1], sv[:, 1], rho,
                                  nt // 64, backend="plain"))
        agree("bitmap_intersect_es", got, want,
              f"count/full/screen bw={bw} nb={nb}")

    # Fused dispatch: survivors written, everything else untouched.
    for bw, nb, cap, density in ((8, 7, 64, 1), (128, 3, 64, 1),
                                 (128, 242, 48, 3)):
        slab0 = rows(cap, nb, bw, density)
        suf0 = suffix_popcounts(slab0)
        P = 20
        ua = torch.from_numpy(rng.integers(0, 16, P).astype(np.int32)).to(dev)
        vb = torch.from_numpy(rng.integers(0, 16, P).astype(np.int32)).to(dev)
        slots_np = np.arange(16, 16 + P, dtype=np.int32)
        slots_np[-1] = cap + 3              # pad slot
        slots_np[-2] = -1                   # negative slot
        slots = torch.from_numpy(slots_np).to(dev)
        rho = suf0[ua.long(), 0].contiguous()
        nt = nb * bw * 32
        for mode in ("and", "andnot"):
            for es in (True, False):
                for minsup in (0, 1, nt // 64, nt // 16, nt // 8):
                    rk, sk = slab0.clone(), suf0.clone()
                    rp, sp = slab0.clone(), suf0.clone()
                    got = ops.screen_and_intersect(
                        rk, sk, ua, vb, slots, rho, minsup, mode=mode,
                        early_stop=es)
                    want = ops.screen_and_intersect(
                        rp, sp, ua, vb, slots, rho, minsup, mode=mode,
                        early_stop=es, backend="plain")
                    what = (f"fused bw={bw} nb={nb} mode={mode} es={es} "
                            f"minsup={minsup}")
                    agree("bitmap_intersect_es", got, want, what)
                    cnt, alive = got[2], got[4]
                    sup = cnt if mode == "and" else rho - cnt
                    keep = (alive & (sup >= minsup)).cpu().numpy()
                    for i in np.flatnonzero(~keep):
                        s = int(slots_np[i])
                        if 0 <= s < cap:
                            need(torch.equal(rk[s], slab0[s])
                                 and torch.equal(sk[s], suf0[s]),
                                 f"{what}: non-survivor slot {s} written")
                    need(torch.equal(rk[16 + P:], slab0[16 + P:])
                         and torch.equal(rk[:16], slab0[:16]),
                         f"{what}: rows outside the child slots written")

    # Compaction: rows, suffix tables and codes; -1 and >= cap entries.
    cap = 40
    perm_np = rng.permutation(cap)[:24].astype(np.int32)
    perm_np[::4] = -1
    perm_np[1::7] = cap + 2
    perm = torch.from_numpy(perm_np).to(dev)
    base = rows(cap + 1, 3, 8, 0).reshape(-1)
    for slab, what in ((rows(cap, 242, 128, 1), "rows (cap, 242, 128)"),
                       (rows(cap, 3, 8, 0), "rows (cap, 3, 8)"),
                       (base[1:1 + cap * 24].view(cap, 3, 8),
                        "rows (cap, 3, 8), 4-byte aligned"),
                       (suffix_popcounts(rows(cap, 242, 8, 1)),
                        "suffix (cap, 243)"),
                       (rows(cap, 1, 3, 0)[:, 0].contiguous(),
                        "codes (cap, 3)")):
        got = kcompact.compact_gather(slab, perm)
        want = ref.compact_gather_ref(slab, perm)
        agree("compact_gather", (got,), (want,), what)
    r0 = rows(cap, 7, 8, 1)
    got = ops.compact_rows(r0, suffix_popcounts(r0), perm)
    want = ops.compact_rows(r0, suffix_popcounts(r0), perm, backend="plain")
    agree("compact_gather", got, want, "compact_rows")
    torch.cuda.synchronize()
    say(f"phase kernels: ok — {n_checks} comparisons, max abs err {err}")
    return {"max_abs_err": err, "checks": n_checks}


# ---------------------------------------------------------------------------
# phases 2-3: the committed baselines
# ---------------------------------------------------------------------------

def _smoke_datasets():
    from repro_torch.data.transactions import (gen_dense_tabular,
                                               gen_powerlaw_baskets)
    return {
        "powerlaw": (gen_powerlaw_baskets(n_trans=300, n_items=200,
                                          avg_trans_len=6, seed=0), 3),
        "dense": (gen_dense_tabular(n_trans=500, n_cols=9,
                                    vals_per_col=4, seed=0), 175),
        "longpat": (gen_dense_tabular(n_trans=400, n_cols=10,
                                      vals_per_col=3, correlation=0.95,
                                      n_classes=2, seed=1), 120),
    }


def phase_smoke(dev) -> dict:
    from repro_torch.core.eclat import mine_bitmap
    base = json.loads((BASELINES / "BENCH_smoke.json").read_text())
    out = {}
    for name, (db, minsup) in _smoke_datasets().items():
        want = base["datasets"][name]
        results = {}
        for tag, es in (("es", True), ("full", False)):
            t0 = time.perf_counter()
            got, st = mine_bitmap(db, minsup, "eclat", early_stop=es,
                                  block_words=8, device=dev)
            wall = time.perf_counter() - t0
            d = st.as_dict()
            need(len(got) == want["frequent_itemsets"],
                 f"smoke {name} {tag}: {len(got)} itemsets, baseline "
                 f"{want['frequent_itemsets']}")
            for k in SMOKE_KEYS:
                need(d[k] == want[tag][k], f"smoke {name} {tag}: {k}="
                                           f"{d[k]}, baseline {want[tag][k]}")
            results[tag] = (got, d, wall)
        need(results["es"][0] == results["full"][0],
             f"smoke {name}: ES on/off itemsets differ")
        out[name] = {tag: {"wall_s": r[2], **{k: r[1][k] for k in SMOKE_KEYS}}
                     for tag, r in results.items()}
        say(f"phase smoke {name}: ok — F={len(results['es'][0])} "
            f"word_ops {results['es'][1]['word_ops']}/"
            f"{results['es'][1]['word_ops_full']} wall es "
            f"{results['es'][2]:.3f} s full {results['full'][2]:.3f} s")
    return out


def _rung(bdb, minsup):
    from repro_torch.core.bitmap import BitmapDB
    keep = np.flatnonzero(bdb.supports >= minsup)
    return BitmapDB(items=[bdb.items[i] for i in keep],
                    bitmaps=bdb.bitmaps[keep], supports=bdb.supports[keep],
                    n_trans=bdb.n_trans, minsup=minsup,
                    block_words=bdb.block_words)


def _miner(dev, early_stop=True):
    from repro_torch.core.eclat import BitmapMiner
    return BitmapMiner(scheme="eclat", early_stop=early_stop, inflight=2,
                       autotune_chunk=True, device=dev)


def phase_full(dev) -> dict:
    from repro_torch.data.transactions import stream_paper_dataset
    base = json.loads((BASELINES / "BENCH_full.json").read_text())
    traj = {r["minsup"]: r for r in
            base["datasets"]["kosarak-paper"]["trajectory"]}
    bdb, minsups = stream_paper_dataset("kosarak-paper", scale=0.1, seed=0)
    out = {}
    for ms in sorted(minsups, reverse=True):
        t0 = time.perf_counter()
        got, st = _miner(dev).mine_packed(_rung(bdb, ms), ms)
        wall = time.perf_counter() - t0
        d = dict(st.as_dict(), frequent_itemsets=len(got))
        for k in FULL_KEYS:
            need(d[k] == traj[ms][k], f"kosarak 0.1 minsup={ms}: {k}={d[k]}"
                                      f", baseline {traj[ms][k]}")
        need(st.peak_device_words == traj[ms]["peak_device_words_per_host"],
             f"kosarak 0.1 minsup={ms}: peak_device_words "
             f"{st.peak_device_words}")
        out[ms] = {"wall_s": wall, **{k: d[k] for k in FULL_KEYS}}
        say(f"phase full kosarak-paper@0.1 minsup={ms}: ok — F={len(got)} "
            f"word_ops {st.word_ops} calls {st.device_calls} "
            f"wall {wall:.3f} s")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path at real size
# ---------------------------------------------------------------------------

def _host_supports_ok(bdb, itemsets) -> int:
    """Recompute every itemset's support on the host from the packed
    bitmaps (numpy AND + popcount); returns how many were checked."""
    from repro_torch.core.bitmap import popcount32_np
    row_of = {it: r for r, it in enumerate(bdb.items)}
    for itemset, sup in itemsets.items():
        rows = [row_of[i] for i in itemset]
        z = bdb.bitmaps[rows[0]].copy()
        for r in rows[1:]:
            z &= bdb.bitmaps[r]
        host = int(popcount32_np(z).sum())
        need(host == sup, f"itemset {sorted(itemset)}: card support {sup}, "
                          f"host {host}")
        need(sup >= bdb.minsup, f"itemset {sorted(itemset)} below minsup")
    return len(itemsets)


def phase_main(dev, counters) -> dict:
    import torch
    from repro_torch.data.transactions import stream_paper_dataset
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    bdb, minsups = stream_paper_dataset("kosarak-paper", scale=1.0, seed=0)
    pack_s = time.perf_counter() - t0
    ms = minsups[0]
    say(f"phase main: kosarak-paper@1.0 packed in {pack_s:.2f} s — "
        f"{bdb.n_trans} transactions, {bdb.n_items} frequent items, "
        f"{bdb.n_blocks} blocks x {bdb.block_words} words, minsup {ms}")

    # Record the compactions' shapes (for the timing phase); the real
    # compact_rows still runs and counts its launches.
    compactions = []
    real_compact = ops.compact_rows

    def recording_compact(rows, suffix, perm, **kw):
        compactions.append((tuple(rows.shape), tuple(suffix.shape),
                            np.array(perm, np.int32, copy=True)))
        return real_compact(rows, suffix, perm, **kw)

    ops.compact_rows = recording_compact
    try:
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        out_es, st_es = _miner(dev).mine_packed(bdb, ms)
        torch.cuda.synchronize()
        wall_es = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
    finally:
        ops.compact_rows = real_compact
    say(f"phase main ES on: F={len(out_es)} word_ops {st_es.word_ops}/"
        f"{st_es.word_ops_full} calls {st_es.device_calls} compactions "
        f"{st_es.compactions} peak_device_words {st_es.peak_device_words} "
        f"wall {wall_es:.3f} s launches {launches}")
    for name, n in launches.items():
        need(n > 0, f"main path launched {name} no time")

    t0 = time.perf_counter()
    out_no, st_no = _miner(dev, early_stop=False).mine_packed(bdb, ms)
    torch.cuda.synchronize()
    wall_no = time.perf_counter() - t0
    need(out_no == out_es, "scale 1.0: ES on and ES off itemsets differ")
    need(st_no.word_ops == st_no.word_ops_full, "ES off skipped work")
    need(st_es.word_ops < st_es.word_ops_full, "ES saved no work")
    say(f"phase main ES off: F={len(out_no)} word_ops {st_no.word_ops} "
        f"calls {st_no.device_calls} peak_device_words "
        f"{st_no.peak_device_words} wall {wall_no:.3f} s")

    t0 = time.perf_counter()
    n_checked = _host_supports_ok(bdb, out_es)
    say(f"phase main: {n_checked} supports recomputed on the host, equal "
        f"({time.perf_counter() - t0:.2f} s)")

    big = minsups[-1]
    sub = _rung(bdb, big)
    t0 = time.perf_counter()
    out_c, st_c = _miner(dev).mine_packed(sub, big)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p, st_p = _miner("cpu").mine_packed(sub, big)
    wall_p = time.perf_counter() - t0
    need(out_c == out_p, f"minsup={big}: card and CPU plain path itemsets "
                         f"differ")
    cd = {k: v for k, v in st_c.as_dict().items() if k not in TIME_KEYS}
    pd = {k: v for k, v in st_p.as_dict().items() if k not in TIME_KEYS}
    need(cd == pd, f"minsup={big}: card and CPU counters differ: "
                   f"{ {k: (cd[k], pd[k]) for k in cd if cd[k] != pd[k]} }")
    say(f"phase main largest rung minsup={big}: card == CPU plain path — "
        f"F={len(out_c)} word_ops {st_c.word_ops} wall card {wall_c:.3f} s "
        f"cpu {wall_p:.3f} s")
    return {"bdb": bdb, "minsup": ms, "launches": launches,
            "compactions": compactions,
            "report": {
                "n_trans": bdb.n_trans, "n_items": bdb.n_items,
                "n_blocks": bdb.n_blocks, "block_words": bdb.block_words,
                "pack_s": pack_s, "minsup": ms, "launches": launches,
                "es": {"wall_s": wall_es, **st_es.as_dict(),
                       "frequent_itemsets": len(out_es)},
                "full": {"wall_s": wall_no, **st_no.as_dict()},
                "largest_rung": {"minsup": big, "wall_card_s": wall_c,
                                 "wall_cpu_s": wall_p,
                                 "frequent_itemsets": len(out_c),
                                 **cd}}}


def profile_main(dev, main, trace_dir: Path) -> dict:
    """One more main-path run under ``torch.profiler`` (``--profile DIR``):
    device busy time (the union of kernel, memcpy and memset intervals in
    the exported trace) against the host wall clock, and device time by
    kernel.  The profiler's own host overhead inflates the wall, so the
    idle share reads high by that much."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.rowstore import DeviceRowStore

    # The slab set-up alone (zeroed slab, host suffix table, row upload).
    bdb = main["bdb"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    DeviceRowStore(bdb.bitmaps, capacity=bdb.n_items + 4096, device=dev)
    torch.cuda.synchronize()
    store_ms = (time.perf_counter() - t0) * 1e3

    miner = _miner(dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        miner.mine_packed(main["bdb"], main["minsup"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / "main_path_trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                   "gpu_memset"):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            key = f"{e['cat']}:{str(e.get('name', ''))[:60]}"
            n, t = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, t + float(e["dur"]) / 1e3)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    busy_ms = busy_us / 1e3
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "store_setup_ms": store_ms,
           "idle_share": (1 - busy_ms / wall_ms) if spans else None,
           "by_name": {k: {"count": n, "ms": t}
                       for k, (n, t) in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][1])},
           "trace": str(path)}
    say(f"profile main path: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({len(spans)} device events); slab set-up "
        f"alone {store_ms:.3f} ms")
    for k, v in list(out["by_name"].items())[:8]:
        say(f"  {v['ms']:.4f} ms  x{v['count']}  {k}")
    return out


# ---------------------------------------------------------------------------
# phase 5: timings at the main path's shapes
# ---------------------------------------------------------------------------

def _timer(dev):
    import torch
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.int8, device=dev)

    def time_ms(fn, iters):
        """Mean ms of ``fn`` over ``iters`` launches, each timed with CUDA
        events after flushing the 50 MB L2 (the main path finds its
        operands cold)."""
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            flush_buf.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters
    return time_ms


def _bound(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timing(dev, main) -> dict:
    import torch
    from repro_torch.core.rowstore import DeviceRowStore
    from repro_torch.kernels import ops

    time_ms = _timer(dev)
    bdb, ms = main["bdb"], main["minsup"]
    nb, bw = bdb.n_blocks, bdb.block_words

    # The main path's first dispatch: every level-1 pair on a fresh slab.
    store = DeviceRowStore(bdb.bitmaps, capacity=bdb.n_items + 4096,
                           device=dev)
    ia, ib = np.triu_indices(bdb.n_items, 1)
    P = int(ia.size)
    slots = store.alloc(P)
    _, (ua, vb, sl, rho) = ops.upload_columns(dev, [
        ia.astype(np.int32), ib.astype(np.int32), slots,
        bdb.supports[ia].astype(np.int32)])

    def scan(backend="auto"):
        return ops.screen_and_intersect(store.rows, store.suffix, ua, vb, sl,
                                        rho, ms, backend=backend)

    # The dispatch at this size against its plain version on a copy of the
    # same fresh slab: counts, blocks, alive and both slabs, exactly.
    rows_p, suffix_p = store.rows.clone(), store.suffix.clone()
    _, _, cnt, blocks, alive = scan()
    got = (cnt, blocks, alive, store.rows, store.suffix)
    want = ops.screen_and_intersect(rows_p, suffix_p, ua, vb, sl, rho, ms,
                                    backend="plain")
    want = (*want[2:], *want[:2])
    scan_err = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
    need(scan_err == 0, f"fused dispatch at {P} pairs x {nb} blocks "
                        f"disagrees with its plain version (max abs err "
                        f"{scan_err})")
    del rows_p, suffix_p, want
    blocks_np = blocks.cpu().numpy().astype(np.int64)
    n_surv = int((alive & (cnt >= ms)).sum().item())
    # Each input byte once: an operand row is needed up to the furthest
    # block any of its pairs scanned (rows are shared by many pairs).
    row_blocks = np.zeros(store.capacity, np.int64)
    np.maximum.at(row_blocks, ia, blocks_np)
    np.maximum.at(row_blocks, ib, blocks_np)
    scan_bytes = (int(row_blocks.sum()) * (bw + 1) * 4    # row + suffix words
                  + n_surv * (nb * bw + nb + 1) * 4       # child rows
                  + P * 4 * 4 + P * 9)                    # columns, outputs
    blocks_sum = int(blocks_np.sum())
    scan_ops = 3 * blocks_sum * bw                        # and, popc, add
    scan_stream = 2 * blocks_sum * (bw + 1) * 4           # bytes it streams
    scan_bound, scan_by = _bound(scan_bytes, scan_ops)
    scan_ms = time_ms(scan, 20)
    scan_plain_ms = time_ms(lambda: scan("plain"), 3)
    del store
    say(f"timing bitmap_intersect_es (fused, {P} pairs x {nb} blocks x {bw} "
        f"words, blocks_done {blocks_sum}, {n_surv} survivors, equal to "
        f"plain): kernel "
        f"{scan_ms:.4f} ms, plain {scan_plain_ms:.4f} ms, bound "
        f"{scan_bound:.4f} ms ({scan_by}: {scan_bytes} B, {scan_ops} ops); "
        f"streams {scan_stream} B = "
        f"{scan_stream / (scan_ms * 1e-3) / 1e9:.1f} GB/s")

    # The main path's largest compaction.
    rows_shape, suf_shape, perm_np = max(
        main["compactions"], key=lambda c: c[0][0] * (c[0][1] * c[0][2]))
    cap = rows_shape[0]
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, rows_shape, generator=g,
                         dtype=torch.int32, device=dev)
    suffix = torch.randint(0, 2 ** 20, suf_shape, generator=g,
                           dtype=torch.int32, device=dev)
    perm = torch.from_numpy(perm_np).to(dev)
    n_valid = int(((perm_np >= 0) & (perm_np < cap)).sum())
    row_b = 4 * (rows_shape[1] * rows_shape[2] + suf_shape[1])
    comp_bytes = (n_valid + perm_np.size) * row_b + perm_np.size * 4
    comp_bound, comp_by = _bound(comp_bytes, 0)

    def library():
        idx = perm.clamp(0, cap - 1)
        dead = (perm < 0) | (perm >= cap)
        return (rows.index_select(0, idx).masked_fill_(dead[:, None, None], 0),
                suffix.index_select(0, idx).masked_fill_(dead[:, None], 0))

    comp_ms = time_ms(lambda: ops.compact_rows(rows, suffix, perm), 20)
    comp_plain_ms = time_ms(
        lambda: ops.compact_rows(rows, suffix, perm, backend="plain"), 5)
    comp_lib_ms = time_ms(library, 20)
    got = ops.compact_rows(rows, suffix, perm)
    lib = library()
    need(torch.equal(got[0], lib[0]) and torch.equal(got[1], lib[1]),
         "compact_rows disagrees with index_select + mask")
    say(f"timing compact_gather (compact_rows, {cap} -> {perm_np.size} rows "
        f"of {rows_shape[1]}x{rows_shape[2]} words + suffix, {n_valid} "
        f"live): kernel {comp_ms:.4f} ms, plain {comp_plain_ms:.4f} ms, "
        f"library {comp_lib_ms:.4f} ms, bound {comp_bound:.4f} ms "
        f"({comp_by}: {comp_bytes} B)")
    return {
        "bitmap_intersect_es": {
            "ms": scan_ms, "plain_ms": scan_plain_ms, "bound_ms": scan_bound,
            "bound_by": scan_by, "library_ms": None,
            "max_abs_err": scan_err, "pairs": P,
            "blocks_done": blocks_sum, "survivors": n_surv,
            "bytes": scan_bytes, "ops": scan_ops,
            "streamed_bytes": scan_stream},
        "compact_gather": {
            "ms": comp_ms, "plain_ms": comp_plain_ms, "bound_ms": comp_bound,
            "bound_by": comp_by, "library_ms": comp_lib_ms,
            "max_abs_err": 0,
            "rows_in": cap, "rows_out": int(perm_np.size),
            "live": n_valid, "bytes": comp_bytes}}


# ---------------------------------------------------------------------------

KERNELS = (
    ("bitmap_intersect_es", "src/repro_torch/csrc/bitmap_intersect.cu",
     "src/repro/kernels/bitmap_intersect.py:113"),
    ("compact_gather", "src/repro_torch/csrc/compact.cu",
     "src/repro/kernels/compact.py:44"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default="",
                    help="write every measured number to this JSON file")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="also profile one main-path run and write its "
                         "trace into DIR")
    args = ap.parse_args()

    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: FAIL: no src/repro_torch next to {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60)
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    smi_line = smi.stdout.strip()
    say(smi_line)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.bitmap_intersect import bitmap_intersect_es
    from repro_torch.kernels.compact import compact_gather
    t0 = time.perf_counter()
    _build.load()
    say(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")

    rng = np.random.default_rng(20261016)
    report = {"card": smi_line, "torch": torch.__version__,
              "build_s": _build.build_seconds}
    t_start = time.perf_counter()
    report["kernels"] = phase_kernels(dev, rng)
    report["smoke"] = phase_smoke(dev)
    report["full"] = phase_full(dev)
    main_res = phase_main(dev, (bitmap_intersect_es, compact_gather))
    report["main"] = main_res["report"]
    if args.profile:
        report["profile"] = profile_main(dev, main_res, Path(args.profile))
    report["timing"] = phase_timing(dev, main_res)
    torch.cuda.synchronize()
    report["phases_s"] = time.perf_counter() - t_start
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1,
                                                default=str))
    kernels = []
    for name, source, replaces in KERNELS:
        t = report["timing"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_res["launches"][name],
            "max_abs_err": max(report["kernels"]["max_abs_err"][name],
                               t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    say(smi_line)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
