#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port, on one NVIDIA H100.

    python3 chip_smoke.py                      # every phase (one CUDA device)
    python3 chip_smoke.py --report out.json    # also write the numbers there
    python3 chip_smoke.py --profile traces/    # also profile each path
    python3 chip_smoke.py --seed 3             # serving phases' seed

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, and beside
them the checked build (device asserts, ``kernels/_build.py``), both
before any rank is spawned, and then (TF32 off throughout):

1. holds every kernel against its plain PyTorch version on the card: bit
   for bit the ES scan (both modes, ES on/off, minsup <= 0, bw 1/8/128
   up to 242 blocks), the dEclat difference (zero-mass U blocks, nb up
   to 84 and 242), both fused dispatches with untouched non-survivor and
   out-of-range slots, both scans with a per-pair threshold (random,
   <= 0, INT32_MIN, above every bound; bw 128, 8 and 1; standalone and
   fused), the N-list merge and Z-merge scatter (lengths 0,
   1, every bucket edge and 32769; whole pool slabs equal) and the
   compaction gather (rows, suffix tables, (cap, 3) codes); flash
   attention within 2e-5 (fp32, the scalar kernel) and 3e-2 (bf16, the
   tensor-core kernel) on the sweep of ``tests/test_kernels.py`` plus
   ragged lengths and Sq != Skv, and the bf16 edges again (head dims
   16/64/128 and 6, Dv != D, one kv head, no mask, one token, S 1024),
   then in both types sliding windows of 1, 100, 127, 128, 129, 4096 and
   past S at ragged S with GQA 48/8, and MLA's D 192 / Dv 128; the
   EmbeddingBag bit for bit (bool and int32 masks, an all-masked bag, the
   scalar path, 100 slots, a bag whose only valid slot is the last, 5000
   bags, a 2,000,000 x 256 table);
2. mines the three smoke regimes, ES on and off, and requires every
   counter of ``benchmarks/baselines/BENCH_smoke.json``: eclat at
   block_words=8, adaptive at its baseline knobs, PrePost+;
3. mines kosarak-paper at scale 0.1, all four rungs, and requires the
   itemset counts and work counters of ``BENCH_full.json``;
4. drives the main path at real size — kosarak-paper at scale 1.0
   (990,000 transactions, 242 blocks of 128 words, an 8192-row slab of
   about 1 GB) through ``BitmapMiner.mine_packed`` — then ES off, a host
   recount of every support, and the largest rung against the port's
   plain path on the CPU;
5. drives dEclat and adaptive at real size — accidents-paper at scale
   1.0 (340,183 transactions, 84 blocks) — ES on and off, each against
   eclat's itemset map, and the largest rung against the CPU path;
6. drives PrePost+ at real size on the main path's database: transaction
   lists from the same seeded stream, a host PPC-tree (its item supports
   equal to the BitmapDB's), ``DevicePrePost`` ES on and off against the
   main path's itemset map, and minsup 19,800 against the CPU path;
7. serves qwen1.5-0.5b at full width (bf16, seeded weights, 8 prompts
   of 2048 tokens, 32 new tokens through ``serve_greedy``; one flash
   launch per layer), holds layer 0's attention at that shape against
   the plain version, and runs the same widths in fp32 through the
   kernel and the plain path (equal tokens, logits within 1e-3);
8. runs full-size two-tower retrieval (5M x 256 and 2M x 256 tables):
   ``retrieval_scores`` for 1 user over 1,000,000 candidates (top-100 ids
   equal to the plain path's, scores recounted) and ``user_embed`` for
   512 users;
9. holds each mining path's first dispatch at real size against its
   plain version (the ES scan and the dEclat difference also repacked at
   8 and 1 words a block, the CLI default and the adaptive smoke knob),
   then times every kernel with CUDA events at its path's shapes, beside
   its bound, its plain version and, where one PyTorch call computes the
   same function, that call (with the kernel / library
   ratio, and flash attention's TFLOP/s and the EmbeddingBag's GB/s),
   and the scan with a per-pair threshold at the (1,1) sharded shape;
10. drives the sharded miner (``DistributedMiner`` on a ``(block, cls)``
   mesh): (1,1) under NCCL in this process at kosarak-paper @ 1.0 (ES on
   and off: phase 4's itemsets and counters) and @ 0.1 (the JAX
   ``DistributedMiner``'s counters, a table committed below); then gloo
   worlds of 2 and 4 ranks sharing the card (``launch.forcedevices``):
   (1,2), (2,1), (2,2), (4,1) at kosarak @ 1.0 (phase 4's itemsets; (1,2)
   with (1,1)'s counters) and @ 0.1 (the JAX table), declat and adaptive
   on accidents-paper @ 1.0 on (2,1) (phase 5's itemsets); each rank
   must launch its scan kernel, and each mesh's wall and device busy are
   printed (one-card gloo numbers: collectives staged through the host);
11. trains (``phase_train``, PERF.md §4's cells (a)-(f)): qwen1.5-0.5b
   at full width through ``launch.train.train_lm`` (fp32, AdamW, 8 x
   256, 10 steps: falling loss, step ms, tokens/s, peak memory, TFLOP/s);
   the same widths at 2 layers, one step on the card against one on the
   CPU (loss and grad norm within 1e-4); the config as configured (bf16,
   remat "dots" and "full") at seq 4096 in 8 microbatches; the JAX
   example's qwen1.5-mini recipe (200 steps, checkpoints) and a restart
   from step 100 that replays its losses; granite-3-8b at 4 layers and
   command-r-plus-104b at 1 layer (Adafactor), every width kept; and
   full-size two-tower training through ``make_train_step(twotower_loss)``
   with the EmbeddingBag kernel under its autograd rule (one launch a
   step, the user tower bit-equal to the plain path, the item table's
   gradient within 1e-6 of the plain autograd one);
12. serves the MoE archs at full width, depth cut (``phase_serve_moe``,
   PERF.md §4): mixtral-8x22b at 8 of 56 layers, 2 x 10,000 + 32 new
   (the flash kernel's window skip, the ring cache rolled and wrapped),
   and deepseek-v2-236b at 5 of 60 layers, 8 x 2048 + 32 new (MLA's
   192/128 heads through the kernel, the latent cache, shared experts);
   each with one flash launch a layer, the decode loop under the purity
   guard, layer 0's attention against the plain version, and the same
   widths in fp32 at 2 layers through the kernel and the plain path
   (equal tokens, logits within 1e-3); then times flash attention at both
   prefill shapes beside its bound, its plain version and SDPA;
13. trains the MoE archs (``phase_train_moe``, PERF.md §4's cells
   (g)-(i)): mixtral-8x22b at full width, 1 of 56 layers, fp32, through
   ``train_lm`` (AdamW, 1 x 5120, past the 4096 window, 3 steps);
   deepseek-v2-236b at full width, 2 of 60 layers (a dense and an MoE
   layer), fp32, Adafactor (4 x 1024, 2 steps): ms a step, tokens/s,
   TFLOP/s over the active params, peak memory; at both smoke configs a
   step on the card against one on the CPU (within 1e-4) and a restart
   from a checkpoint that replays its losses;
14. runs SASRec, DIN and xDeepFM at their full widths
   (``phase_recsys_models``): ``serve_p99`` and ``retrieval_cand`` walls
   (xDeepFM's 1,000,000 candidate rows scored in blocks of 32,768), two
   AdamW steps at ``train_batch`` (xDeepFM cut to 49,152), the card's
   outputs on a slice against the CPU's; then the screened two-tower
   retrieval (bf16 screen of 1,000,000 candidates, fp32 rescoring of a
   4096 shortlist) beside the exact one, top-100 ids equal;
15. trains GraphSAGE at full width (``phase_gnn``, PERF.md §4's GNN
   cells (a)-(e)): ``ogb_products`` full batch (2,449,408 nodes,
   61,859,840 edges, 3 AdamW steps: ms a step, peak memory, device busy
   share) and ``minibatch_lg`` sampled on the Reddit-scale graph
   (232,965 nodes, 114,615,892 edges, 1024 seeds, fanouts 15-10, 3
   steps: set-up, sample, upload and step walls apart); the small shapes
   card against CPU (loss within 1e-4, every gradient within 1e-4 of its
   largest entry, deterministic algorithms); ``make_sharded_loss`` equal
   to ``loss_full`` within 1e-5 at (1,1) under NCCL at ``ogb_products``
   and in gloo worlds (2,1), (1,2), (2,2) sharing the card; int8
   quantization on the card bit-equal to the CPU's, and the compressed
   all-reductions in a gloo world with a ``pod`` dimension of 2;
16. last, the checked build runs phase 1's flash sweep (each output equal
   to the normal build's bit for bit) and its ES and N-list sweeps again
   (a failed device assert traps and fails the run), then the N-list
   sweeps with the merge's adv mask in its packed form, whose reading is
   printed.

Every path runs with every kernel's launch count set to 0 just before
and read just after; a path that launched one of its kernels no time
fails.  ``--profile DIR`` adds one profiled run of each real-size path
(device busy time against the host wall).

It prints the card's name and power limit, a ``kernels`` JSON line and,
last, ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before that line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import shutil
import subprocess
import sys
import threading
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
# Dense bf16 tensor-core rate: the peak for attention's bf16 products.
PEAK_BF16_FLOPS = 989e12

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
    from repro_torch.core.bitmap import suffix_popcounts
    from repro_torch.kernels import compact as kcompact
    from repro_torch.kernels import ops, ref

    def rows(n, nb, bw, density):
        u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        for _ in range(density):            # each AND halves the density
            u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)

    err = {name: 0 for name, *_ in KERNELS}
    n_checks = {name: 0 for name, *_ in KERNELS}

    def agree(name, got, want, what):
        e = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
        err[name] = max(err[name], e)
        n_checks[name] += 1
        need(e == 0, f"{name} disagrees with its plain version: {what} "
                     f"(max abs err {e})")

    _check_scan(dev, rows, rng, agree)
    _check_thr(dev, agree)

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
    codes = rows(cap, 1, 3, 0)[:, 0].contiguous()
    agree("compact_gather", (ops.compact_codes(codes, perm),),
          (ops.compact_codes(codes, perm, backend="plain"),), "compact_codes")

    _check_diff(dev, rows, agree)
    _check_nlists(dev, rng, agree)
    _check_nlist_intersect(dev, rng, agree)

    def close(name, got, want, tol, what):
        need(tuple(got.shape) == tuple(want.shape) and got.dtype == want.dtype,
             f"{name}: {what}: {got.dtype} {tuple(got.shape)} != "
             f"{want.dtype} {tuple(want.shape)}")
        e = ((got.float() - want.float()).abs().max().item()
             if got.numel() else 0.0)
        err[name] = max(err[name], e)
        n_checks[name] += 1
        need(e < tol, f"{name} disagrees with its plain version: {what} "
                      f"(max abs err {e}, tolerance {tol})")

    _check_flash(dev, close)
    _check_bag(dev, rng, close)
    torch.cuda.synchronize()
    say(f"phase kernels: ok — {n_checks} comparisons, max abs err {err}")
    return {"max_abs_err": err, "checks": n_checks}


# B, Sq, Skv, H, KH, D, Dv, causal, dtype, tolerance: the sweep of
# tests/test_kernels.py:520-524 (its tolerances: fp32 2e-5, bf16 3e-2),
# then ragged lengths, Sq != Skv both ways, and bf16 at a ragged length.
# fp32 runs on the scalar kernel and bf16 on the tensor-core kernel, so the
# bf16 rows repeat the edges for the second kernel: head dims 16/64/128,
# Dv != D, GQA with one kv head, no mask, Sq != Skv both ways, one token,
# a ragged 65, the serve head shape at S 1024, and a head dim that TMA
# cannot take (D 6: the plain-load fill).
FLASH_CASES = (
    (2, 128, 128, 4, 2, 32, 32, True, "float32", 2e-5),
    (1, 256, 256, 8, 8, 64, 64, True, "float32", 2e-5),
    (2, 128, 256, 4, 1, 32, 16, False, "float32", 2e-5),
    (1, 128, 128, 4, 4, 128, 128, True, "float32", 2e-5),
    (1, 128, 128, 4, 2, 32, 32, True, "bfloat16", 3e-2),
    (1, 1, 1, 2, 1, 16, 16, True, "float32", 2e-5),
    (2, 65, 65, 4, 2, 32, 32, True, "float32", 2e-5),
    (1, 200, 200, 4, 4, 64, 64, True, "float32", 2e-5),
    (1, 70, 130, 4, 2, 32, 24, False, "float32", 2e-5),
    (1, 130, 70, 2, 2, 16, 16, True, "float32", 2e-5),
    (1, 200, 200, 16, 16, 64, 64, True, "bfloat16", 3e-2),
    (2, 128, 128, 4, 2, 16, 16, True, "bfloat16", 3e-2),
    (1, 256, 256, 8, 8, 64, 64, True, "bfloat16", 3e-2),
    (1, 128, 128, 4, 4, 128, 128, True, "bfloat16", 3e-2),
    (1, 70, 130, 4, 2, 32, 24, True, "bfloat16", 3e-2),
    (2, 128, 256, 4, 1, 32, 32, True, "bfloat16", 3e-2),
    (2, 128, 256, 4, 2, 64, 64, False, "bfloat16", 3e-2),
    (1, 70, 130, 4, 2, 32, 32, True, "bfloat16", 3e-2),
    (1, 130, 70, 2, 2, 16, 16, True, "bfloat16", 3e-2),
    (1, 1, 1, 2, 1, 16, 16, True, "bfloat16", 3e-2),
    (2, 65, 65, 4, 2, 32, 32, True, "bfloat16", 3e-2),
    (1, 1024, 1024, 16, 16, 64, 64, True, "bfloat16", 3e-2),
    (1, 300, 300, 4, 2, 6, 10, True, "bfloat16", 3e-2),
)
# B, S, H, KH, D, Dv, window (causal, Sq = Skv = S), each in fp32 (2e-5)
# and bf16 (3e-2): sliding windows of 1, 100, 127, 128 (a row whose first
# loaded key tile it cannot see), 129, 4096 (mixtral's, at S 5000: tiles
# skipped on the left) and past S, at ragged S with mixtral's GQA 48/8 at
# D 128; then MLA's expanded heads, D 192 / Dv 128 with one kv head per
# query head (deepseek-v2's shape; the two-slot ring), with a window too.
FLASH_WINDOW_CASES = (
    (2, 1000, 48, 8, 128, 128, 1), (1, 1000, 48, 8, 128, 128, 100),
    (1, 1000, 48, 8, 128, 128, 127), (1, 1000, 48, 8, 128, 128, 128),
    (1, 1000, 48, 8, 128, 128, 129), (1, 5000, 48, 8, 128, 128, 4096),
    (1, 1000, 48, 8, 128, 128, 6000), (1, 777, 4, 2, 64, 64, 300),
    (2, 300, 4, 4, 192, 128, 0), (1, 1000, 16, 16, 192, 128, 0),
    (1, 1000, 8, 8, 192, 128, 300), (1, 333, 4, 4, 190, 72, 64),
)


def _flash_cases() -> list:
    """Every case of the flash sweep: (B, Sq, Skv, H, KH, D, Dv, causal,
    window, dtype, tolerance)."""
    return ([(B, Sq, Skv, H, KH, D, Dv, causal, 0, dt, tol)
             for B, Sq, Skv, H, KH, D, Dv, causal, dt, tol in FLASH_CASES]
            + [(B, S, S, H, KH, D, Dv, True, w, dt, tol)
               for dt, tol in (("float32", 2e-5), ("bfloat16", 3e-2))
               for B, S, H, KH, D, Dv, w in FLASH_WINDOW_CASES])


def _flash_sweep(dev) -> list:
    """(kernel, plain) outputs of flash_attention over ``_flash_cases()``,
    the inputs drawn from one seeded generator."""
    import torch
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for B, Sq, Skv, H, KH, D, Dv, causal, w, dtype, tol in _flash_cases():
        dt = getattr(torch, dtype)
        q, k, v = (torch.randn(shape, generator=g, device=dev).to(dt)
                   for shape in ((B, Sq, H, D), (B, Skv, KH, D),
                                 (B, Skv, KH, Dv)))
        out.append((ops.flash_attention(q, k, v, causal=causal, window=w),
                    ops.flash_attention(q, k, v, causal=causal, window=w,
                                        backend="plain")))
    return out


def _check_flash(dev, close) -> None:
    """flash_attention against its plain version (dense fp32 softmax)."""
    for case, (got, want) in zip(_flash_cases(), _flash_sweep(dev),
                                 strict=True):
        B, Sq, Skv, H, KH, D, Dv, causal, w, dtype, tol = case
        close("flash_attention", got, want, tol,
              f"B={B} Sq={Sq} Skv={Skv} H={H} KH={KH} D={D} Dv={Dv} "
              f"causal={causal} window={w} {dtype}")


def _check_bag(dev, rng, close) -> None:
    """embedding_bag against its plain version, bit for bit: the sweep of
    tests/test_kernels.py:543-545 (bool and int32 masks), an all-masked
    bag, a width that is not a multiple of 4 (the scalar path), 100 slots
    (past one warp's 64 slots in registers), a bag whose only valid slot is
    the last, 5000 bags (the large-batch design), and the two-tower item
    table (2,000,000 x 256) with Zipf history bags."""
    import torch
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.kernels import ops

    def one(table, ids, mask, comb, what):
        for m in (mask, mask.to(torch.int32)):
            got = ops.embedding_bag(table, ids, m, combiner=comb)
            want = ops.embedding_bag(table, ids, m, combiner=comb,
                                     backend="plain")
            close("embedding_bag", got, want, 1e-5,
                  f"{what} {comb} mask {m.dtype}")
            need(torch.equal(got, want), f"embedding_bag: {what} {comb} "
                 f"mask {m.dtype} is not bit-equal to its plain version")

    for V, D, B, L, comb in ((100, 16, 8, 5, "mean"), (64, 32, 16, 9, "sum"),
                             (257, 8, 4, 3, "mean"), (1000, 64, 8, 20, "mean"),
                             (300, 6, 33, 7, "sum"),
                             (5000, 256, 40, 100, "mean"),
                             (700, 12, 40, 100, "sum"),
                             (3000, 64, 5000, 30, "mean")):
        table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32))
        ids = torch.from_numpy(rng.integers(0, V, (B, L)).astype(np.int32))
        mask = torch.from_numpy(rng.random((B, L)) < 0.8)
        mask[1] = False
        mask[1, -1] = True                      # only the last slot valid
        one(table.to(dev), ids.to(dev), mask.to(dev), comb,
            f"V={V} D={D} B={B} L={L}")
    ones = torch.ones((8, 4), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    mask = torch.tensor([[False] * 3, [True] * 3], device=dev)
    got = ops.embedding_bag(ones, ids, mask, combiner="mean")
    need(torch.equal(got, torch.tensor([[0.0] * 4, [1.0] * 4], device=dev)),
         f"embedding_bag: all-masked bag gives {got[0].tolist()}")
    one(ones, ids, mask, "mean", "all-masked bag")
    V, D = 2_000_000, 256
    table = torch.randn((V, D), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    b = twotower_batch(7, 512, 5_000_000, V, 50)
    one(table, torch.from_numpy(b["hist_ids"]).to(dev),
        torch.from_numpy(b["hist_mask"]).to(dev), "mean",
        f"table {V} x {D}, 512 Zipf bags of 50")


def _check_scan(dev, rows, rng, agree) -> None:
    """bitmap_intersect_es against its plain version: the standalone scan
    (both modes, ES on/off, minsup <= 0, bw 1/8/128 up to 242 blocks) and
    the fused dispatch, whose non-survivor and out-of-range slots stay
    untouched."""
    import torch
    from repro_torch.core.bitmap import suffix_popcounts
    from repro_torch.kernels import ops

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


INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


def _plain_fused_thr(rows, suffix, ua, vb, slots, rho, gate, thr, *, diff,
                     mode="and"):
    """The fused dispatch with a per-pair threshold, in plain PyTorch:
    gather, ``ref._blocked_es_scan`` / ``_blocked_diff_scan`` against
    ``thr``, and the survivors' scatter gated on ``gate``."""
    from repro_torch.kernels import ref
    U, V = rows.index_select(0, ua), rows.index_select(0, vb)
    su = suffix.index_select(0, ua)
    if diff:
        Z, cnt, blocks, alive = ref._blocked_diff_scan(U, V, su, rho, thr)
    else:
        Z, cnt, blocks, alive = ref._blocked_es_scan(
            U, V, su, suffix.index_select(0, vb), rho, thr, mode=mode)
    keep = ref._survivor_mask(cnt, alive, rho, gate,
                              mode="andnot" if diff else mode)
    ref._scatter_children(rows, suffix, Z, keep, slots)
    return cnt, blocks, alive


def _check_thr(dev, agree) -> None:
    """The ES scan and the dEclat difference with a per-pair threshold
    (the sharded miner's ``minsup - slack``) against their plain versions,
    bit for bit: both scan modes and the difference, bw 128, 8 and 1,
    thresholds random, <= 0, INT32_MIN and above every bound; standalone,
    and fused with survivors written (and with the sharded dispatch's
    second-pass form: INT32_MIN / INT32_MAX per pair, gate INT32_MIN)."""
    import torch
    from repro_torch.core.bitmap import suffix_popcounts
    from repro_torch.kernels import bitmap_diff as kbd
    from repro_torch.kernels import bitmap_intersect as kbi
    from repro_torch.kernels import ops

    rng = np.random.default_rng(20261017)

    def rows(n, nb, bw):
        u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        for _ in range(3):
            u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        u[::3, nb // 2] = 0                  # zero-mass blocks
        return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)

    for bw, nb, P in ((128, 242, 64), (128, 5, 40), (8, 33, 48),
                      (1, 300, 48)):
        U, V = rows(P, nb, bw), rows(P, nb, bw)
        su, sv = suffix_popcounts(U), suffix_popcounts(V)
        rho = su[:, 0].contiguous()
        nt = nb * bw * 32
        thr_np = rng.integers(-nt // 64, nt // 64, P).astype(np.int32)
        thr_np[:6] = (INT32_MIN, -1, 0, nt + 1, INT32_MAX, INT32_MIN + 1)
        thr = torch.from_numpy(thr_np).to(dev)
        what = f"per-pair thr bw={bw} nb={nb}"
        for mode in ("and", "andnot"):
            agree("bitmap_intersect_es",
                  ops.bitmap_intersect_es(U, V, su, sv, rho, 0, mode=mode,
                                          thr=thr),
                  ops.bitmap_intersect_es(U, V, su, sv, rho, 0, mode=mode,
                                          thr=thr, backend="plain"),
                  f"{what} scan mode={mode}")
        agree("bitmap_diff_es",
              ops.bitmap_diff_es(U, V, su, rho, 0, thr=thr),
              ops.bitmap_diff_es(U, V, su, rho, 0, thr=thr, backend="plain"),
              f"{what} diff")

        cap, n = 2 * P, P // 2
        slab = torch.cat([U, torch.zeros_like(U)])
        suf = torch.cat([su, torch.zeros_like(su)])
        ua = torch.from_numpy(rng.integers(0, P, n).astype(np.int32)).to(dev)
        vb = torch.from_numpy(rng.integers(0, P, n).astype(np.int32)).to(dev)
        slots_np = np.arange(P, P + n, dtype=np.int32)
        slots_np[-1], slots_np[-2] = cap, -1
        slots = torch.from_numpy(slots_np).to(dev)
        rho_f = suf[ua.long(), 0].contiguous()
        t = thr[:n].contiguous()
        two = torch.from_numpy(np.where(rng.random(n) < 0.5, INT32_MIN,
                                        INT32_MAX).astype(np.int32)).to(dev)
        for diff in (False, True):
            for gate, tt in ((nt // 256, t), (INT32_MIN, two)):
                rk, sk = slab.clone(), suf.clone()
                rp, sp = slab.clone(), suf.clone()
                if diff:
                    got = kbd.screen_and_diff(rk, sk, ua, vb, slots, rho_f,
                                              gate, 0, thr=tt)
                else:
                    got = kbi.screen_and_intersect(rk, sk, ua, vb, slots,
                                                   rho_f, gate, 0, thr=tt)
                want = _plain_fused_thr(rp, sp, ua, vb, slots, rho_f, gate,
                                        tt, diff=diff)
                agree("bitmap_diff_es" if diff else "bitmap_intersect_es",
                      (*got, rk, sk), (*want, rp, sp),
                      f"{what} fused diff={diff} gate={gate}")


def _check_diff(dev, rows, agree) -> None:
    """bitmap_diff_es against its plain version: the standalone scan and
    the fused dispatch, with zero-mass U blocks (a zero-mass prefix too)
    and words with bit 31 set."""
    import torch
    from repro_torch.core.bitmap import suffix_popcounts
    from repro_torch.kernels import ops

    for bw, nb, P, density in ((1, 9, 33, 1), (8, 7, 33, 1), (128, 3, 33, 1),
                               (128, 84, 48, 3), (128, 242, 24, 3)):
        U, V = rows(P, nb, bw, density), rows(P, nb, bw, density)
        U[::2, nb // 3] = 0
        U[1::3, :(nb + 1) // 2] = 0
        su = suffix_popcounts(U)
        rho = su[:, 0].contiguous()
        nt = nb * bw * 32
        for minsup in (-(2 ** 31), -4, 0, 1, nt // 64, nt // 16, nt // 8,
                       nt):
            agree("bitmap_diff_es",
                  ops.bitmap_diff_es(U, V, su, rho, minsup),
                  ops.bitmap_diff_es(U, V, su, rho, minsup, backend="plain"),
                  f"diff scan bw={bw} nb={nb} minsup={minsup}")

    for bw, nb, cap, density in ((1, 9, 64, 1), (8, 7, 64, 1),
                                 (128, 84, 48, 3)):
        slab0 = rows(cap, nb, bw, density)
        slab0[:8, nb // 2] = 0
        suf0 = suffix_popcounts(slab0)
        P = 20
        g = torch.Generator().manual_seed(nb)
        ua = torch.randint(0, 16, (P,), generator=g, dtype=torch.int32).to(dev)
        vb = torch.randint(0, 16, (P,), generator=g, dtype=torch.int32).to(dev)
        slots_np = np.arange(16, 16 + P, dtype=np.int32)
        slots_np[-1] = cap + 3
        slots_np[-2] = -1
        slots = torch.from_numpy(slots_np).to(dev)
        rho = suf0[ua.long(), 0].contiguous()
        nt = nb * bw * 32
        for es in (True, False):
            for minsup in (0, 1, nt // 64, nt // 16, nt // 8):
                rk, sk = slab0.clone(), suf0.clone()
                rp, sp = slab0.clone(), suf0.clone()
                got = ops.screen_and_diff(rk, sk, ua, vb, slots, rho, minsup,
                                          early_stop=es)
                want = ops.screen_and_diff(rp, sp, ua, vb, slots, rho, minsup,
                                           early_stop=es, backend="plain")
                what = f"fused diff bw={bw} nb={nb} es={es} minsup={minsup}"
                agree("bitmap_diff_es", got, want, what)
                keep = (got[4] & (rho - got[2] >= minsup)).cpu().numpy()
                for i in np.flatnonzero(~keep):
                    s = int(slots_np[i])
                    if 0 <= s < cap:
                        need(torch.equal(rk[s], slab0[s])
                             and torch.equal(sk[s], suf0[s]),
                             f"{what}: non-survivor slot {s} written")
                need(torch.equal(rk[16 + P:], slab0[16 + P:])
                     and torch.equal(rk[:16], slab0[:16]),
                     f"{what}: rows outside the child slots written")


def _random_nlist(rng, n: int, span: int) -> np.ndarray:
    """``n`` PP-codes with distinct ascending pre ranks below ``span``."""
    pre = np.sort(rng.choice(span, n, replace=False)).astype(np.int32)
    post = rng.integers(0, span, n).astype(np.int32)
    return np.stack([pre, post, rng.integers(1, 20, n).astype(np.int32)], 1)


def _check_nlists(dev, rng, agree) -> None:
    """nlist_merge (through nlist_presize and nlist_intersect) and the
    Z-merge scatter (through nlist_scatter and nlist_extend) against
    their plain versions: operand lengths 0, 1, every bucket edge, every
    window edge of the merge kernel (31-33, 63-65) and one past 32768 (a
    65536-wide match table), ES on and off, an abort on the first step,
    whole pool slabs equal with skipped (out_off >= cap) pairs
    untouched.  The plain merge takes one masked step per loop iteration
    for the whole batch, so the 32769-code walk gets a batch of its
    own."""
    from repro_torch.core.bitmap import nl_pad_len

    edges = [0, 1, 7, 8, 9, 31, 32, 33, 127, 128, 129, 511, 512, 513,
             2047, 2048, 2049, 8191, 8192, 8193]

    # Bucket edges: long U lists meet short V lists and vice versa.
    pairs = [(_random_nlist(rng, n, 20000), _random_nlist(rng, m, 20000))
             for n, m in zip(edges, reversed(edges), strict=True)]
    _nlist_batch(dev, rng, agree, pairs,
                 plans=((True, 1), (True, 400), (False, 1)),
                 extend=((True, 30), (False, 1)))
    # The merge kernel's window edges (32-code windows): every pair of
    # lengths around one and two windows.
    win = [0, 1, 31, 32, 33, 63, 64, 65]
    pairs = [(_random_nlist(rng, n, 400), _random_nlist(rng, m, 400))
             for n in win for m in win]
    _nlist_batch(dev, rng, agree, pairs,
                 plans=((True, 1), (True, 150), (False, 1)),
                 extend=((True, 150),))
    # rho < minsup: with ES every walk aborts on its first step.
    got = _nlist_batch(dev, rng, agree, pairs, plans=((True, 10 ** 6),),
                       extend=())
    walked = np.array([len(u) > 0 and len(v) > 0 for u, v in pairs])
    need(bool((got[3].cpu().numpy() == walked).all())
         and bool((got[5].cpu().numpy() != walked).all()),
         "rho < minsup: not every walk aborted on its first step")
    # One U of 32769 codes, every one a descendant of V's single code: the
    # walk goes through all of U (one Z-merge group of 32769 matches).
    n_long = 32769
    k = np.arange(n_long, dtype=np.int32)
    long_u = np.stack([10 + k, 10 ** 8 - k, 1 + k % 5], 1).astype(np.int32)
    pairs = [(long_u, np.array([[5, 10 ** 9, 3]], np.int32)),
             (long_u, _random_nlist(rng, 40, 20000))]
    got = _nlist_batch(dev, rng, agree, pairs, plans=((False, 1),),
                       extend=((True, 1),))
    need(nl_pad_len(n_long) == 65536 and got[0].shape[1] == 65536,
         "the long operand's match table is not 65536 wide")
    need(int(got[3][0]) == n_long and int(got[1][0]) == 1,
         "the long walk did not cover all of U in one group")


def _nlist_batch(dev, rng, agree, pairs, *, plans, extend):
    """Lay the (U, V) code lists of ``pairs`` out in one pool slab and
    hold presize + tight scatter (``plans``: (early_stop, minsup)) and
    the one-call extend against the plain versions."""
    import torch
    from repro_torch.core.bitmap import nl_pad_len
    from repro_torch.kernels import ops

    ext, bump = [], 0
    cols = [[], [], [], []]
    for u, v in pairs:
        for arr, c in ((u, 0), (v, 2)):
            ext.append((bump, arr))
            cols[c].append(bump)
            cols[c + 1].append(len(arr))
            bump += len(arr)
    P = len(pairs)
    room = int(sum(cols[1]))
    cap = 64
    while cap < bump + room:
        cap *= 2
    codes_np = rng.integers(0, 1000, (cap, 3)).astype(np.int32)
    for off, arr in ext:
        codes_np[off:off + len(arr)] = arr
    codes = torch.from_numpy(codes_np).to(dev)
    cols = [np.asarray(c, np.int32) for c in cols]
    rho = np.array([int(v[:, 2].sum()) for _, v in pairs], np.int32)
    lu, lv = nl_pad_len(int(cols[1].max())), nl_pad_len(int(cols[3].max()))
    first = None
    for es, minsup in plans:
        got = ops.nlist_presize(codes, *cols, rho, minsup, lu=lu, lv=lv,
                                early_stop=es)
        want = ops.nlist_presize(codes, *cols, rho, minsup, lu=lu, lv=lv,
                                 early_stop=es, backend="plain")
        what = f"nlist presize lu={lu} es={es} minsup={minsup}"
        agree("nlist_merge", got, want, what)
        first = first or got
        # tight extents for survivors, skipped pairs past the slab
        support = got[2].cpu().numpy()
        child_len = got[1].cpu().numpy()
        out_off = np.full(P, cap + 7, np.int32)
        nxt = bump
        for p in np.flatnonzero(support >= minsup):
            out_off[p] = nxt
            nxt += int(child_len[p])
        ck, cp = codes.clone(), codes.clone()
        a = ops.nlist_scatter(ck, got[0], *cols, out_off, lu=lu, lv=lv)
        b = ops.nlist_scatter(cp, want[0], *cols, out_off, lu=lu, lv=lv,
                              backend="plain")
        agree("zmerge_scatter", a, b, f"nlist scatter, {what}")
        need(torch.equal(ck[:bump], codes[:bump])
             and torch.equal(ck[nxt:], codes[nxt:]),
             f"nlist scatter, {what}: codes outside the child extents "
             f"written")
    spaced = (bump + np.concatenate([[0], np.cumsum(cols[1])[:-1]])
              ).astype(np.int32)
    spaced[::3] = cap                                # skipped
    for es, minsup in extend:
        ck, cp = codes.clone(), codes.clone()
        a = ops.nlist_extend(ck, *cols, spaced, rho, minsup, lu=lu, lv=lv,
                             early_stop=es)
        b = ops.nlist_extend(cp, *cols, spaced, rho, minsup, lu=lu, lv=lv,
                             early_stop=es, backend="plain")
        what = f"nlist extend lu={lu} es={es} minsup={minsup}"
        agree("nlist_merge", a[1:], b[1:], what)
        agree("zmerge_scatter", a[:1], b[:1], what)
    return first


def _check_nlist_intersect(dev, rng, agree) -> None:
    """The padded-batch entry (nlist_intersect) on a small batch."""
    import torch
    from repro_torch.kernels import ops

    Pb, wu, wv = 40, 32, 128

    def batch(width):
        arr = np.stack([_random_nlist(rng, width, 4 * width + 8)
                        for _ in range(Pb)])
        return [torch.from_numpy(np.ascontiguousarray(arr[..., c])).to(dev)
                for c in range(3)]
    ub, vbt = batch(wu), batch(wv)
    ul = rng.integers(0, wu + 1, Pb).astype(np.int32)
    vl = rng.integers(0, wv + 1, Pb).astype(np.int32)
    rb = rng.integers(0, 400, Pb).astype(np.int32)
    for es in (True, False):
        agree("nlist_merge",
              ops.nlist_intersect(*ub, *vbt, ul, vl, rb, 60, early_stop=es),
              ops.nlist_intersect(*ub, *vbt, ul, vl, rb, 60, early_stop=es,
                                  backend="plain"),
              f"nlist_intersect es={es}")


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


def _non_time(d: dict) -> dict:
    return {k: v for k, v in d.items() if k not in TIME_KEYS | {"wall_s"}}


def phase_smoke(dev) -> dict:
    from repro_torch.core.eclat import mine_bitmap
    from repro_torch.core.prepost import mine_prepost_device
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

        # The adaptive and PrePost+ blocks: every counter the baseline
        # holds, and the eclat run's itemsets.
        knobs = want["adaptive"]["knobs"]
        runs = {"adaptive": lambda es: mine_bitmap(   # noqa: E731
                    db, minsup, "adaptive", early_stop=es, device=dev,
                    **knobs),
                "prepost": lambda es: mine_prepost_device(  # noqa: E731
                    db, minsup, early_stop=es, device=dev)}
        for engine, run in runs.items():
            for tag, es in (("es", True), ("full", False)):
                t0 = time.perf_counter()
                got, st = run(es)
                wall = time.perf_counter() - t0
                d, w = _non_time(st.as_dict()), _non_time(want[engine][tag])
                bad = {k: (d[k], w[k]) for k in w if k in d and d[k] != w[k]}
                need(not bad, f"smoke {name} {engine} {tag}: counters differ "
                              f"from the baseline (card, baseline): {bad}")
                need(got == results["es"][0], f"smoke {name} {engine} {tag}: "
                                              f"itemsets differ from eclat's")
                out[name][f"{engine}_{tag}"] = {"wall_s": wall, **d}
            key = "word_ops" if engine == "adaptive" else "comparisons"
            say(f"phase smoke {name} {engine}: ok — {key} "
                f"{out[name][engine + '_es'][key]}/"
                f"{out[name][engine + '_full'][key]} calls "
                f"{out[name][engine + '_es']['device_calls']}")
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
    for name in ("bitmap_intersect_es", "compact_gather"):
        need(launches[name] > 0, f"main path launched {name} no time")

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
    cd, pd = _non_time(st_c.as_dict()), _non_time(st_p.as_dict())
    need(cd == pd, f"minsup={big}: card and CPU counters differ: "
                   f"{ {k: (cd[k], pd[k]) for k in cd if cd[k] != pd[k]} }")
    say(f"phase main largest rung minsup={big}: card == CPU plain path — "
        f"F={len(out_c)} word_ops {st_c.word_ops} wall card {wall_c:.3f} s "
        f"cpu {wall_p:.3f} s")
    return {"bdb": bdb, "minsup": ms, "launches": launches,
            "compactions": compactions, "itemsets": out_es,
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


def _launches(counters, run):
    """Run ``run()`` with every kernel's launch count set to 0 just before
    and read just after (the card synchronised on both sides)."""
    import torch
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, {c.__name__: c.launches for c in counters}


def phase_declat(dev, counters) -> dict:
    """dEclat and adaptive at real size: accidents-paper @ 1.0 (340,183
    transactions, 84 blocks of 128 words) at its smallest rung."""
    import torch
    from repro_torch.core.eclat import BitmapMiner
    from repro_torch.data.transactions import stream_paper_dataset

    t0 = time.perf_counter()
    bdb, minsups = stream_paper_dataset("accidents-paper", scale=1.0, seed=0)
    pack_s = time.perf_counter() - t0
    ms = minsups[0]
    say(f"phase declat: accidents-paper@1.0 packed in {pack_s:.2f} s — "
        f"{bdb.n_trans} transactions, {bdb.n_items} frequent items, "
        f"{bdb.n_blocks} blocks x {bdb.block_words} words, minsup {ms}")

    def miner(scheme, es=True, device=dev):
        return BitmapMiner(scheme=scheme, early_stop=es, inflight=2,
                           autotune_chunk=True, device=device)

    (ref_out, ref_st), ref_wall, _ = _launches(
        counters, lambda: miner("eclat").mine_packed(bdb, ms))
    say(f"phase declat eclat reference: F={len(ref_out)} word_ops "
        f"{ref_st.word_ops} calls {ref_st.device_calls} wall "
        f"{ref_wall:.3f} s")
    report = {"n_trans": bdb.n_trans, "n_items": bdb.n_items,
              "n_blocks": bdb.n_blocks, "pack_s": pack_s, "minsup": ms,
              "eclat": {"wall_s": ref_wall, **ref_st.as_dict(),
                        "frequent_itemsets": len(ref_out)}}
    launches = None
    for scheme in ("declat", "adaptive"):
        for tag, es in (("es", True), ("full", False)):
            (out, st), wall, ln = _launches(
                counters, lambda: miner(scheme, es).mine_packed(bdb, ms))
            need(out == ref_out, f"accidents {scheme} {tag}: itemset -> "
                                 f"support map differs from eclat's")
            if scheme == "declat" and es:
                launches = ln
                need(ln["bitmap_diff_es"] > 0,
                     "the declat path launched bitmap_diff_es no time")
            report[f"{scheme}_{tag}"] = {
                "wall_s": wall, "launches": ln, **st.as_dict(),
                "frequent_itemsets": len(out)}
            say(f"phase declat {scheme} ES {'on' if es else 'off'}: "
                f"F={len(out)} word_ops {st.word_ops}/{st.word_ops_full} "
                f"calls {st.device_calls} peak_rows {st.peak_rows} "
                f"peak_device_words {st.peak_device_words} wall "
                f"{wall:.3f} s launches {ln}")

    big = minsups[-1]
    sub = _rung(bdb, big)
    for scheme in ("declat", "adaptive"):
        t0 = time.perf_counter()
        out_c, st_c = miner(scheme).mine_packed(sub, big)
        torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        out_p, st_p = miner(scheme, device="cpu").mine_packed(sub, big)
        wall_p = time.perf_counter() - t0
        cd, pd = _non_time(st_c.as_dict()), _non_time(st_p.as_dict())
        need(out_c == out_p and cd == pd,
             f"accidents minsup={big} {scheme}: card and CPU plain path "
             f"differ: { {k: (cd[k], pd[k]) for k in cd if cd[k] != pd[k]} }")
        report[f"largest_rung_{scheme}"] = {
            "minsup": big, "wall_card_s": wall_c, "wall_cpu_s": wall_p,
            "frequent_itemsets": len(out_c), **cd}
        say(f"phase declat largest rung minsup={big} {scheme}: card == CPU "
            f"plain path — F={len(out_c)} word_ops {st_c.word_ops} wall "
            f"card {wall_c:.3f} s cpu {wall_p:.3f} s")
    return {"bdb": bdb, "minsup": ms, "launches": launches,
            "itemsets": ref_out, "report": report}


def _kosarak_transactions():
    """kosarak-paper @ 1.0 as transaction lists, from the same seeded
    stream and batch that ``stream_paper_dataset`` packs."""
    from repro_torch.data.transactions import PAPER_REPLICAS, _STREAMS
    gen_name, kwargs, _ = PAPER_REPLICAS["kosarak-paper"]
    db = []
    for items, mask in _STREAMS[gen_name](seed=0, batch=8192, **kwargs):
        db.extend(row[m].tolist() for row, m in zip(items, mask,
                                                    strict=True))
    return db


def phase_prepost(dev, counters, main) -> dict:
    """PrePost+ at real size: kosarak-paper @ 1.0, the main path's
    database, at the main path's minsup (and its 1450-itemset map)."""
    import torch
    from repro_torch.core.oracle import PPCTree
    from repro_torch.core.prepost import DevicePrePost

    bdb, ms, want = main["bdb"], main["minsup"], main["itemsets"]
    t0 = time.perf_counter()
    db = _kosarak_transactions()
    lists_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = PPCTree(db, ms)
    tree_s = time.perf_counter() - t0
    need(tree.item_support == {it: int(s) for it, s in
                               zip(bdb.items, bdb.supports, strict=True)},
         "PPC-tree item supports differ from the BitmapDB's")
    n_codes = sum(len(v) for v in tree.nlists.values())
    longest = max(len(v) for v in tree.nlists.values())
    say(f"phase prepost: kosarak-paper@1.0 — {len(db)} transaction lists "
        f"in {lists_s:.2f} s, PPC-tree at minsup {ms} in {tree_s:.2f} s "
        f"(host): {len(tree.nlists)} N-lists, {n_codes} codes, longest "
        f"{longest}")
    report = {"lists_s": lists_s, "tree_s": tree_s, "minsup": ms,
              "n_lists": len(tree.nlists), "n_codes": n_codes,
              "longest": longest}
    launches = None
    cmps = {}
    for tag, es in (("es", True), ("full", False)):
        (out, st), wall, ln = _launches(
            counters, lambda: DevicePrePost(early_stop=es, device=dev)
            .mine_tree(tree, ms))
        need(out == want, f"kosarak prepost {tag}: itemset -> support map "
                          f"differs from the main path's")
        if es:
            launches = ln
            for k in ("nlist_merge", "zmerge_scatter"):
                need(ln[k] > 0, f"the PrePost+ path launched {k} no time")
        cmps[tag] = st.comparisons
        report[tag] = {"wall_s": wall, "launches": ln, **st.as_dict(),
                       "frequent_itemsets": len(out)}
        say(f"phase prepost ES {'on' if es else 'off'}: F={len(out)} "
            f"comparisons {st.comparisons} es_checks {st.es_checks} calls "
            f"{st.device_calls} peak_codes {st.peak_codes} mining wall "
            f"{wall:.3f} s launches {ln}")
    need(cmps["es"] <= cmps["full"], "ES raised comparisons")

    big = 19_800
    t0 = time.perf_counter()
    tree_b = PPCTree(db, big)
    tree_b_s = time.perf_counter() - t0
    del db
    t0 = time.perf_counter()
    out_c, st_c = DevicePrePost(device=dev).mine_tree(tree_b, big)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_p, st_p = DevicePrePost(device="cpu").mine_tree(tree_b, big)
    wall_p = time.perf_counter() - t0
    cd, pd = _non_time(st_c.as_dict()), _non_time(st_p.as_dict())
    need(out_c == out_p and cd == pd,
         f"kosarak prepost minsup={big}: card and CPU plain path differ: "
         f"{ {k: (cd[k], pd[k]) for k in cd if cd[k] != pd[k]} }")
    report["minsup_19800"] = {"tree_s": tree_b_s, "wall_card_s": wall_c,
                              "wall_cpu_s": wall_p,
                              "frequent_itemsets": len(out_c), **cd}
    say(f"phase prepost minsup={big}: card == CPU plain path — "
        f"F={len(out_c)} comparisons {st_c.comparisons} "
        f"({sum(len(v) for v in tree_b.nlists.values())} codes in "
        f"{len(tree_b.nlists)} N-lists; tree {tree_b_s:.2f} s) wall card "
        f"{wall_c:.3f} s cpu {wall_p:.3f} s")
    return {"tree": tree, "minsup": ms, "launches": launches,
            "report": report}


# ---------------------------------------------------------------------------
# serving paths: qwen1.5-0.5b greedy serving, two-tower retrieval
# ---------------------------------------------------------------------------

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 2048, 32


def _quiet(*_):
    pass


def phase_serve(dev, counters, seed) -> dict:
    """qwen1.5-0.5b at full width (24 layers, d 1024, 16 heads of 64,
    d_ff 2816, vocab 151,936, bf16; seeded random weights): 8 prompts of
    2048 tokens, then 32 new tokens through ``serve_greedy``.  Layer 0's
    attention at this shape against the plain version; the same widths in
    fp32 through the kernel and the plain path (equal greedy tokens,
    prefill logits within 1e-3); the bf16 plain path's agreement is
    reported, not gated (a bf16 model can flip a near-tie)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_greedy
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_arch("qwen1.5-0.5b").config_fn()
    B, S, new = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = T.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    serve_greedy(cfg, prompts[:, :64], 2, model=model, device=dev,
                 log_fn=_quiet)                          # warm-up
    timings = {}

    def run():
        return serve_greedy(cfg, prompts, new, model=model, device=dev,
                            timings=timings, log_fn=say)

    gen, wall, launches = _launches(counters, run)
    need(launches["flash_attention"] == cfg.n_layers,
         f"serve: prefill launched flash_attention "
         f"{launches['flash_attention']} times, not {cfg.n_layers}")
    need(gen.shape == (B, new) and gen.min() >= 0
         and gen.max() < cfg.padded_vocab, f"serve: bad tokens {gen.shape}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    # Layer 0's attention at this shape, kernel against plain; then the
    # fp32 prefills.  Serving builds no autograd graph.
    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        lp = model.layers[0]
        h = L.rmsnorm(lp.attn_norm, model.embed.table[tokens.long()],
                      cfg.norm_eps)
        q, k, v = L._qkv(lp.attn, h, cfg.param_dtype)
        pos = torch.arange(S, device=dev).expand(B, S)
        q = L.apply_rope(q, pos, cfg.rope_theta)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        o_k = ops.flash_attention(q, k, v)
        o_p = ops.flash_attention(q, k, v, backend="plain")
        need(bool(torch.isfinite(o_k.float()).all().item()),
             "serve: layer-0 attention not finite")
        attn_err = (o_k.float() - o_p.float()).abs().max().item()
        need(attn_err < 3e-2, f"serve: layer-0 attention at {tuple(q.shape)} "
                              f"disagrees with its plain version ({attn_err})")
        del h, o_k, o_p
        gen_p = serve_greedy(cfg, prompts, new, model=model, device=dev,
                             backend="plain", log_fn=_quiet)
        rows_agree = int((gen == gen_p).all(axis=1).sum())
        tok_agree = int((gen == gen_p).sum())

        # fp32 at the same widths: the kernel path against the plain path.
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        model32 = T.init_params(cfg32, seed=seed, device=dev)
        logit_k, cache = T.prefill(model32, cfg32, tokens)
        del cache
        logit_p, cache = T.prefill(model32, cfg32, tokens, backend="plain")
        del cache
        need(bool(torch.isfinite(logit_k).all().item()),
             "serve fp32: prefill logits not finite")
        logit_err = (logit_k - logit_p).abs().max().item()
        need(logit_err < 1e-3, f"serve fp32: prefill logits kernel vs plain "
                               f"{logit_err}")
        t32 = {}
        g32 = serve_greedy(cfg32, prompts, new, model=model32, device=dev,
                           timings=t32, log_fn=say)
        g32_p = serve_greedy(cfg32, prompts, new, model=model32, device=dev,
                             backend="plain", log_fn=_quiet)
        need(np.array_equal(g32, g32_p), "serve fp32: greedy tokens differ "
             f"between the kernel and the plain path "
             f"({int((g32 != g32_p).sum())} of {g32.size})")
        del model32, logit_k, logit_p
    torch.cuda.empty_cache()
    say(f"phase serve: qwen1.5-0.5b ({n_params} params, bf16) {B} x {S} "
        f"prompt + {new} new: prefill {timings['prefill_s'] * 1e3:.3f} ms, "
        f"decode {timings['decode_ms_per_token']:.4f} ms/token, "
        f"{timings['tokens_per_s']:.2f} tok/s, flash launches "
        f"{launches['flash_attention']}; layer-0 attention err {attn_err}; "
        f"bf16 plain path agrees on {rows_agree}/{B} rows ({tok_agree}/"
        f"{gen.size} tokens); fp32 logits err {logit_err}, fp32 tokens "
        f"equal; fp32 prefill {t32['prefill_s'] * 1e3:.3f} ms")
    return {"cfg": cfg, "model": model, "prompts": prompts,
            "qkv": (q, k, v), "launches": launches, "report": {
                "arch": cfg.name, "params": n_params, "batch": B,
                "prompt": S, "new_tokens": new, "init_s": init_s,
                "wall_s": wall, **timings, "peak_alloc_gb": peak_gb,
                "launches": launches, "layer0_attn_err": attn_err,
                "bf16_plain_rows_agree": rows_agree,
                "bf16_plain_tokens_agree": tok_agree,
                "fp32_logit_err": logit_err, "fp32": t32}}


# The MoE serving cells (PERF.md §4): arch, layers kept, B, prompt, new
# tokens, flash launches a prefill; then the fp32 check's layers, B,
# prompt, new tokens.  Every width is kept; depth is cut to fit one card.
MOE_CELLS = (
    ("mixtral-8x22b", 8, 2, 10_000, 32, 2, 1, 5000, 8),
    ("deepseek-v2-236b", 5, 8, 2048, 32, 2, 2, 512, 8),
)


def _layer0_qkv(model, cfg, tokens):
    """Layer 0's attention inputs at the prompt's shape, as prefill makes
    them: RoPE'd GQA q/k/v, or MLA's expanded 192/128 heads."""
    import torch
    from repro_torch.models import layers as L

    B, S = tokens.shape
    lp = model.layers[0]
    h = L.rmsnorm(lp.attn_norm, model.embed.table[tokens.long()],
                  cfg.norm_eps)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    if cfg.mla:
        (q, k, v), _ = L.mla_qkv(lp.attn, h, cfg.mla_dims, pos,
                                 cfg.rope_theta, cfg.param_dtype)
        return q, k, v, (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    q, k, v = L._qkv(lp.attn, h, cfg.param_dtype)
    q = L.apply_rope(q, pos, cfg.rope_theta)
    k = L.apply_rope(k, pos, cfg.rope_theta)
    return q, k, v, None


def phase_serve_moe(dev, counters, seed, trace_dir=None) -> dict:
    """The MoE archs at full width (bf16, seeded random weights), depth
    cut: mixtral-8x22b at 8 of 56 layers, 2 prompts of 10,000 tokens (past
    its 4096 window: the kernel skips key tiles, prefill rolls the ring by
    1808, decode wraps it) + 32 new; deepseek-v2-236b at 5 of 60 layers
    (first_k_dense 1 + 4 MoE), 8 x 2048 + 32 (MLA's 192/128 heads through
    the kernel).  Each: one flash launch a layer per prefill, the decode
    loop under the purity guard (``serve_greedy``), layer 0's attention
    at the prompt's shape against the plain version; then the same widths
    in fp32 at 2 layers, through the kernel and the plain path (equal
    greedy tokens, prefill logits within 1e-3).  ``trace_dir``
    (``--profile``) adds one profiled serve run of each cell."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_greedy
    from repro_torch.models import transformer as T

    out = {"report": {}, "launches": {}, "qkv": {}, "profile": {}}
    for (arch, n_layers, B, S, new, n32, B32, S32, new32) in MOE_CELLS:
        cfg = dataclasses.replace(get_arch(arch).config_fn(),
                                  n_layers=n_layers)
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = T.init_params(cfg, seed=seed, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        serve_greedy(cfg, prompts[:, :256], 2, model=model, device=dev,
                     log_fn=_quiet)                      # warm-up
        torch.cuda.reset_peak_memory_stats(dev)
        timings = {}

        def run():
            return serve_greedy(cfg, prompts, new, model=model, device=dev,
                                timings=timings, log_fn=say)

        gen, wall, launches = _launches(counters, run)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        if trace_dir is not None:
            out["profile"][arch] = profile_path(
                f"serve_{arch}", lambda: serve_greedy(
                    cfg, prompts, new, model=model, device=dev,
                    log_fn=_quiet), trace_dir)
        need(launches["flash_attention"] == n_layers,
             f"serve {arch}: prefill launched flash_attention "
             f"{launches['flash_attention']} times, not {n_layers}")
        need(gen.shape == (B, new) and gen.min() >= 0
             and gen.max() < cfg.padded_vocab,
             f"serve {arch}: bad tokens {gen.shape}")
        with torch.inference_mode():
            tokens = torch.from_numpy(prompts).to(dev)
            q, k, v, scale = _layer0_qkv(model, cfg, tokens)
            w = cfg.sliding_window
            o_k = ops.flash_attention(q, k, v, window=w, softmax_scale=scale)
            o_p = ops.flash_attention(q, k, v, window=w, softmax_scale=scale,
                                      backend="plain")
            need(bool(torch.isfinite(o_k.float()).all().item()),
                 f"serve {arch}: layer-0 attention not finite")
            attn_err = (o_k.float() - o_p.float()).abs().max().item()
            need(attn_err < 3e-2, f"serve {arch}: layer-0 attention at "
                 f"{tuple(q.shape)} disagrees with its plain version "
                 f"({attn_err})")
            del o_k, o_p, tokens
        out["qkv"][arch] = (q, k, v, scale, w)
        del model
        torch.cuda.empty_cache()

        # fp32 at the same widths, 2 layers: the kernel path against the
        # plain path.
        cfg32 = dataclasses.replace(cfg, dtype="float32", n_layers=n32)
        model32 = T.init_params(cfg32, seed=seed, device=dev)
        p32 = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, (B32, S32)).astype(np.int32)
        with torch.inference_mode():
            tokens = torch.from_numpy(p32).to(dev)
            logit_k, cache = T.prefill(model32, cfg32, tokens)
            del cache
            logit_p, cache = T.prefill(model32, cfg32, tokens,
                                       backend="plain")
            del cache
            need(bool(torch.isfinite(logit_k).all().item()),
                 f"serve {arch} fp32: prefill logits not finite")
            logit_err = (logit_k - logit_p).abs().max().item()
            need(logit_err < 1e-3, f"serve {arch} fp32: prefill logits "
                                   f"kernel vs plain {logit_err}")
            t32 = {}
            g32 = serve_greedy(cfg32, p32, new32, model=model32, device=dev,
                               timings=t32, log_fn=_quiet)
            g32_p = serve_greedy(cfg32, p32, new32, model=model32,
                                 device=dev, backend="plain", log_fn=_quiet)
            need(np.array_equal(g32, g32_p), f"serve {arch} fp32: greedy "
                 f"tokens differ between the kernel and the plain path "
                 f"({int((g32 != g32_p).sum())} of {g32.size})")
            del model32, logit_k, logit_p, tokens
        torch.cuda.empty_cache()
        say(f"phase serve_moe: {arch} at {n_layers} layers ({n_params} "
            f"params, bf16, init {init_s:.2f} s) {B} x {S} prompt + {new} "
            f"new: prefill {timings['prefill_s'] * 1e3:.3f} ms, decode "
            f"{timings['decode_ms_per_token']:.4f} ms/token, "
            f"{timings['tokens_per_s']:.2f} tok/s, peak {peak_gb:.2f} GB, "
            f"flash launches {launches['flash_attention']}; layer-0 "
            f"attention {tuple(q.shape)} window {w} err {attn_err}; fp32 at "
            f"{n32} layers, {B32} x {S32} + {new32}: logits err "
            f"{logit_err}, tokens equal, prefill "
            f"{t32['prefill_s'] * 1e3:.3f} ms")
        out["launches"][arch] = launches
        out["report"][arch] = {
            "layers": n_layers, "params": n_params, "batch": B,
            "prompt": S, "new_tokens": new, "init_s": init_s,
            "wall_s": wall, **timings, "peak_alloc_gb": peak_gb,
            "launches": launches, "layer0_attn_err": attn_err,
            "layer0_shape": list(q.shape) + [v.shape[-1]], "window": w,
            "fp32": dict(t32, layers=n32, batch=B32, prompt=S32,
                         new_tokens=new32, logit_err=logit_err)}
    return out


def phase_timing_moe(dev, moe) -> dict:
    """flash_attention at the MoE cells' prefill shapes (layer 0's own q,
    k, v): mixtral's B 2, S 10,000, H 48 over 8 kv heads, D 128, window
    4096; deepseek-v2's B 8, S 2048, H 128, D 192 / Dv 128, causal.  The
    bound counts the bf16 products over the unmasked (query, key) pairs
    only.  Beside each, ``F.scaled_dot_product_attention`` (which the
    port never calls) on kv heads repeated to H: with an explicit
    boolean window mask for mixtral, ``is_causal`` for 192/128 (none
    where no backend takes the shape)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    time_ms = _timer(dev)
    out = {}
    for arch, (q, k, v, scale, w) in moe["qkv"].items():
        B, S, H, D = q.shape
        KH, Dv = v.shape[2], v.shape[3]
        ms = time_ms(lambda: ops.flash_attention(q, k, v, window=w,
                                                 softmax_scale=scale), 10)
        plain_ms = time_ms(lambda: ops.flash_attention(
            q, k, v, window=w, softmax_scale=scale, backend="plain"), 1)
        i = torch.arange(S, device=dev)
        pairs = int(((i + 1).clamp(max=w) if w else i + 1).sum().item())
        flops = 2 * B * H * pairs * (D + Dv)
        nbytes = (q.numel() + k.numel() + v.numel() + B * S * H * Dv) * 2
        bound, by = _bound(nbytes, flops, PEAK_BF16_FLOPS)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        kt = kt.repeat_interleave(H // KH, dim=1)
        vt = vt.repeat_interleave(H // KH, dim=1)
        if w:
            keep = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < w)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=keep,
                                                      scale=scale)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      scale=scale)
        try:
            lib_out = sdpa()
        except RuntimeError as e:        # the yardstick only: no backend
            lib_ms, lib_err, lib_note = None, None, str(e).splitlines()[0]
        else:
            lib_err = (lib_out.transpose(1, 2).float() - ops.flash_attention(
                q, k, v, window=w, softmax_scale=scale).float()
            ).abs().max().item()
            del lib_out
            need(lib_err < 3e-2, f"flash_attention {arch} disagrees with "
                                 f"SDPA ({lib_err})")
            lib_ms, lib_note = time_ms(sdpa, 5), "F.scaled_dot_product_attention"
        tflops = flops / (ms * 1e-3) / 1e12
        say(f"timing flash_attention {arch} (B {B} S {S} H {H} KH {KH} D "
            f"{D} Dv {Dv} window {w} bf16, causal, {pairs} pairs a head): "
            f"kernel {ms:.4f} ms ({tflops:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, library {lib_ms} ms ({lib_note}), bound "
            f"{bound:.4f} ms ({by}: {nbytes} B, {flops} flops); kernel vs "
            f"library {lib_err}")
        out[arch] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": by, "library_ms": lib_ms,
                     "library": lib_note, "vs_library_err": lib_err,
                     "tflops": tflops, "shape": [B, S, H, KH, D, Dv, w],
                     "pairs": pairs, "bytes": nbytes, "ops": flops,
                     "max_abs_err": moe["report"][arch]["layer0_attn_err"]}
        del qt, kt, vt
    return out


def phase_retrieval(dev, counters, seed) -> dict:
    """two-tower-retrieval at full size (5M x 256 user and 2M x 256 item
    tables, towers 1024-512-256, fp32; seeded random weights):
    ``retrieval_scores`` at the ``retrieval_cand`` shape (1 user from
    ``twotower_batch``, 1,000,000 distinct candidates, top 100) and
    ``user_embed`` at ``serve_p99``'s 512 users, each against the plain
    path."""
    import torch
    from repro_torch.configs import RECSYS_SHAPES, get_arch
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.models import recsys as R

    cfg = get_arch("two-tower-retrieval").config_fn()
    cand_dims = RECSYS_SHAPES["retrieval_cand"].dims
    n_p99 = RECSYS_SHAPES["serve_p99"].dims["batch"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = R.twotower_init(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def user_args(b):
        return [torch.from_numpy(b[k]).to(dev)
                for k in ("user_id", "hist_ids", "hist_mask")]

    args = user_args(twotower_batch(seed, cand_dims["batch"], cfg.n_users,
                                    cfg.n_items, cfg.n_user_hist))
    cand = torch.from_numpy(np.random.default_rng(seed).permutation(
        cfg.n_items)[:cand_dims["n_candidates"]].astype(np.int32)).to(dev)

    def run(backend="auto"):
        return R.retrieval_scores(model, cfg, *args, cand, topk=100,
                                  backend=backend)

    run()                                                # warm-up
    (vals, idx), wall, launches = _launches(counters, run)
    need(launches["embedding_bag"] >= 1,
         "retrieval: embedding_bag was not launched")
    walls = [wall] + [_launches(counters, run)[1] for _ in range(4)]
    vals_p, idx_p = run("plain")
    need(torch.equal(idx, idx_p), "retrieval: top-100 ids differ between "
                                  "the kernel and the plain path")
    val_err = (vals - vals_p).abs().max().item()
    need(val_err <= 1e-5, f"retrieval: top-100 values differ ({val_err})")
    need(bool(torch.isfinite(vals).all().item())
         and bool((vals[:, :-1] >= vals[:, 1:]).all().item())
         and vals.abs().max().item() <= 1 + 1e-5,
         "retrieval: scores not finite, sorted cosines")
    # The winners' scores recounted from the towers one by one.
    u = R.user_embed(model, cfg, *args, backend="plain")
    recount = R.item_embed(model, cfg, cand[idx[0]]) @ u[0]
    rec_err = (recount - vals[0]).abs().max().item()
    need(rec_err <= 1e-5, f"retrieval: recounted top-100 scores differ "
                          f"({rec_err})")

    a99 = user_args(twotower_batch(seed + 1, n_p99, cfg.n_users,
                                   cfg.n_items, cfg.n_user_hist))

    def embed99(backend="auto"):
        return R.user_embed(model, cfg, *a99, backend=backend)

    embed99()                                            # warm-up
    u99, wall99, launches99 = _launches(counters, embed99)
    walls99 = [wall99] + [_launches(counters, embed99)[1] for _ in range(4)]
    need(launches99["embedding_bag"] == 1,
         "serve_p99: embedding_bag was not launched once")
    u_err = (u99 - embed99("plain")).abs().max().item()
    need(u_err <= 1e-5, f"serve_p99: user_embed kernel vs plain {u_err}")
    say(f"phase retrieval: two-tower (init {init_s:.2f} s) retrieval_cand "
        f"1 x {cand.numel()} top-100: walls {[w * 1e3 for w in walls]} ms, "
        f"bag launches {launches['embedding_bag']}, ids equal, value err "
        f"{val_err}, recount err {rec_err}; serve_p99 user_embed x "
        f"{n_p99}: walls {[w * 1e3 for w in walls99]} ms, err {u_err}")
    return {"cfg": cfg, "model": model, "run": run, "embed99": embed99,
            "launches": launches, "report": {
                "init_s": init_s, "candidates": int(cand.numel()),
                "walls_s": walls, "launches": launches,
                "top100_value_err": val_err, "recount_err": rec_err,
                "serve_p99": {"batch": n_p99, "walls_s": walls99,
                              "launches": launches99, "err": u_err}}}


# ---------------------------------------------------------------------------
# phase 11: training (the LM trainer and the two-tower loss)
# ---------------------------------------------------------------------------

TRAIN_STEPS = 10
TRAIN_BATCH, TRAIN_SEQ = 8, 256
# examples/train_lm.py's model: the qwen1.5 architecture at ~14M params.
QWEN_MINI = dict(name="qwen1.5-mini", n_layers=4, d_model=256, n_heads=8,
                 n_kv_heads=8, d_head=32, d_ff=704, vocab_size=8192,
                 dtype="float32", remat="none", attn_chunk=128)
TWOTOWER_TRAIN_BATCH = 16_384       # train_batch's 65,536, cut (PERF.md §4)


def _train_run(dev, counters, cfg, **kw):
    """``train_lm`` on the card with a log line every step: (result,
    per-step seconds (from one log line to the next, each after a device
    sync; the first from the call, model init included), peak bytes,
    wall).  Nothing of the LM path is a kernel of
    the port: attention is the chunked softmax, as in the JAX trainer."""
    import torch
    from repro_torch.launch.train import train_lm

    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)

    def run():
        stamps.append(time.perf_counter())
        return train_lm(cfg, device=dev, log_every=1,
                        log_fn=lambda line: stamps.append(
                            time.perf_counter()), **kw)

    out, wall, launches = _launches(counters, run)
    peak = torch.cuda.max_memory_allocated(dev)
    need(not any(launches.values()), f"train {cfg.name}: the LM path "
         f"launched a kernel of the port ({launches})")
    losses = [l for _, l in out["history"]]
    need(len(losses) == kw["steps"] and np.isfinite(losses).all(),
         f"train {cfg.name}: losses {losses}")
    return out, np.diff(stamps), peak, wall


def phase_train(dev, counters, seed, smi_line, trace_dir) -> dict:
    """Training on the card (PERF.md §4's cells (a)-(f)); every run with
    the launch counts set to 0 just before.

    (a) qwen1.5-0.5b at full width through ``train_lm`` with the JAX
    ``main``'s settings (fp32, remat none, AdamW, batch 8 x 256, lr 3e-3,
    10 steps, weights from ``--seed``): finite losses, falling; step ms,
    tokens/s, peak memory, TFLOP/s.  (b) the same widths at 2 layers,
    batch 2 x 128: one step on the card and one on the CPU from the same
    weights, loss and grad norm within 1e-4 relative (TF32 off).  (c) the
    config as configured (bf16, remat "dots", then "full") at train_4k's
    seq 4096, batch 8 in 8 microbatches.  (d) examples/train_lm.py's
    recipe (qwen1.5-mini, 200 steps, a checkpoint every 50), then a
    restart from step 100 whose losses equal the uninterrupted run's
    within 1e-4 relative.  (e) granite-3-8b at 4 layers (fp32, AdamW, 2
    steps) and command-r-plus-104b at 1 layer (fp32, Adafactor, 1 step),
    every width kept.  (f) two-tower-retrieval at full size,
    ``make_train_step(twotower_loss)`` with AdamW, 3 steps of 16,384: the
    EmbeddingBag kernel launched every step, the user tower bit-equal to
    the plain path, the item table's gradient within 1e-6 of the plain
    autograd gradient's largest entry."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.launch.train import train_lm
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    from repro_torch.models import weights as W
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_step import make_train_step

    out = {"card": smi_line}
    qwen = get_arch("qwen1.5-0.5b").config_fn()

    # (a) full width, the JAX main's settings.
    cfg = dataclasses.replace(qwen, dtype="float32", remat="none")
    n_params = cfg.param_count()
    res, steps_s, peak, wall = _train_run(
        dev, counters, cfg, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
        seq_len=TRAIN_SEQ, lr=3e-3, seed=seed)
    losses = [l for _, l in res["history"]]
    need(losses[-1] < losses[0], f"train (a): loss did not fall {losses}")
    step_ms = float(np.median(steps_s[2:])) * 1e3          # steps 3-10
    tokens = TRAIN_BATCH * TRAIN_SEQ
    tflops = 6 * n_params * tokens / (step_ms * 1e-3) / 1e12
    say(f"train (a) qwen1.5-0.5b fp32 full width ({n_params} params), "
        f"{TRAIN_BATCH} x {TRAIN_SEQ}, AdamW, {TRAIN_STEPS} steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    say(f"train (a) median step over steps 3-10: {step_ms:.3f} ms")
    say(f"train (a) tokens/s: {tokens / (step_ms * 1e-3):.1f}")
    say(f"train (a) torch.cuda.max_memory_allocated: {peak} B "
        f"({peak / 1e9:.3f} GB)")
    say(f"train (a) achieved {tflops:.2f} TFLOP/s (6 x params x tokens / "
        f"step) against the {PEAK_OPS_PER_S / 1e12:.0f} TFLOP/s fp32 "
        f"non-tensor peak: {tflops / (PEAK_OPS_PER_S / 1e12):.3f}")
    out["a"] = {"params": n_params, "losses": losses,
                "step_s": steps_s.tolist(), "median_step_ms": step_ms,
                "tokens_per_s": tokens / (step_ms * 1e-3), "tflops": tflops,
                "peak_alloc_bytes": peak, "wall_s": wall,
                "final": res["final"]}
    if trace_dir:
        out["a"]["profile"] = profile_path(
            "train_path", lambda: train_lm(
                cfg, steps=3, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, lr=3e-3,
                seed=seed, device=dev, log_fn=_quiet), trace_dir)
    torch.cuda.empty_cache()

    # (b) card against the CPU, 2 layers at full width.
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    tree = W.lm_to_numpy(T.init_params(cfg2, seed=seed, device="cpu"))
    runs = {}
    for where in (dev, "cpu"):
        logs = []
        t0 = time.perf_counter()
        runs[str(where)] = train_lm(cfg2, steps=1, batch=2, seq_len=128,
                                    lr=3e-3, seed=seed, device=where,
                                    params=tree, log_fn=logs.append)
        runs[str(where) + "_s"] = time.perf_counter() - t0
    card, cpu = runs[str(dev)]["final"], runs["cpu"]["final"]
    errs = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
            for k in ("loss", "grad_norm")}
    need(max(errs.values()) <= 1e-4, f"train (b): card vs CPU {card} / "
                                     f"{cpu}")
    say(f"train (b) 2 layers at full width, 2 x 128, one step: card loss "
        f"{card['loss']!r} gnorm {card['grad_norm']!r}, CPU loss "
        f"{cpu['loss']!r} gnorm {cpu['grad_norm']!r}; relative errors "
        f"{errs}")
    out["b"] = {"card": card, "cpu": cpu, "rel_err": errs,
                "card_s": runs[str(dev) + "_s"], "cpu_s": runs["cpu_s"]}
    del tree

    # (c) as configured, at train_4k's sequence, global batch cut to 8.
    out["c"] = {}
    for remat in ("dots", "full"):
        cfg4k = dataclasses.replace(qwen, remat=remat)
        res, steps_s, peak, wall = _train_run(
            dev, counters, cfg4k, steps=2, batch=8, seq_len=4096,
            n_microbatches=8, lr=3e-3, seed=seed)
        say(f"train (c) qwen1.5-0.5b bf16 remat={remat}, 8 x 4096 in 8 "
            f"microbatches: losses {[l for _, l in res['history']]}, "
            f"second step {steps_s[1] * 1e3:.3f} ms, peak {peak} B "
            f"({peak / 1e9:.3f} GB)")
        out["c"][remat] = {"losses": [l for _, l in res["history"]],
                           "step_s": steps_s.tolist(),
                           "peak_alloc_bytes": peak, "wall_s": wall}
        torch.cuda.empty_cache()

    # (d) the example's recipe, then a restart from step 100.
    mini = dataclasses.replace(qwen, **QWEN_MINI)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        kw = dict(steps=200, batch=8, seq_len=128, lr=3e-3, seed=seed,
                  ckpt_dir=tmp, ckpt_every=50, log_fn=_quiet)
        first, wall, launches = _launches(
            counters, lambda: train_lm(mini, device=dev, **kw))
        need(not any(launches.values()), f"train (d): {launches}")
        hist = dict(first["history"])
        need(hist[200] < hist[10], f"train (d): loss did not fall {hist}")
        kept = sorted(os.listdir(tmp))
        for step in (150, 200):
            shutil.rmtree(os.path.join(tmp, f"step-{step:08d}"))
        logs = []
        again, wall2, _ = _launches(counters, lambda: train_lm(
            mini, device=dev, resume=True, **{**kw, "log_fn": logs.append}))
        need(logs[0].startswith("[resume] restored step 100"),
             f"train (d): {logs[0]}")
        errs = [abs(l - hist[s]) / abs(hist[s]) for s, l in
                again["history"]]
        need([s for s, _ in again["history"]] == list(range(110, 201, 10))
             and max(errs) <= 1e-4, f"train (d): resumed losses "
             f"{again['history']} vs {hist}")
        model = T.init_params(mini, seed=seed, device=dev, trainable=True)
        leaves = W.lm_leaves(model)
        state = {"params": W.leaves_to_tree(leaves),
                 "opt": opt_init(leaves, OptConfig()).state_tree()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(tmp, 999, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restore_checkpoint(tmp, state, step=999)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"train (d) qwen1.5-mini, 8 x 128, 200 steps with a checkpoint every "
        f"50 (kept {kept}): loss {hist[10]:.4f} (step 10) -> "
        f"{hist[200]:.4f}; restart from 100: steps 110-200 within "
        f"{max(errs):.3g} relative; walls {wall:.2f} s / {wall2:.2f} s; "
        f"checkpoint save {save_s:.4f} s, restore {restore_s:.4f} s")
    out["d"] = {"history": first["history"], "resumed": again["history"],
                "max_rel_err": max(errs), "wall_s": wall,
                "resume_wall_s": wall2, "save_s": save_s,
                "restore_s": restore_s}
    del model, leaves, state

    # (e) the two new configs, cut in depth only.
    granite = dataclasses.replace(get_arch("granite-3-8b").config_fn(),
                                  n_layers=4, dtype="float32", remat="none")
    res, steps_s, peak, wall = _train_run(
        dev, counters, granite, steps=2, batch=8, seq_len=256, lr=3e-3,
        seed=seed)
    say(f"train (e) granite-3-8b at 4 of 40 layers ({granite.param_count()} "
        f"params, fp32, AdamW), 8 x 256: losses "
        f"{[l for _, l in res['history']]}, second step "
        f"{steps_s[1] * 1e3:.3f} ms, peak {peak} B ({peak / 1e9:.3f} GB)")
    out["e"] = {"granite": {"params": granite.param_count(),
                            "losses": [l for _, l in res["history"]],
                            "step_s": steps_s.tolist(),
                            "peak_alloc_bytes": peak}}
    torch.cuda.empty_cache()
    cr = dataclasses.replace(get_arch("command-r-plus-104b").config_fn(),
                             n_layers=1, dtype="float32", remat="none")
    torch.cuda.reset_peak_memory_stats(dev)
    model = T.init_params(cr, seed=seed, device=dev, trainable=True)
    opt = opt_init(W.lm_leaves(model), OptConfig(
        kind="adafactor", lr=3e-3, warmup_steps=0, decay_steps=1))
    step = make_train_step(lambda b: T.loss_fn(model, cr, b["tokens"],
                                               b["labels"]), opt)
    toks, labs = SyntheticLM(LMDataConfig(cr.vocab_size, 8, 256,
                                          seed=seed)).batch(0)
    batch = {"tokens": torch.from_numpy(toks).to(dev),
             "labels": torch.from_numpy(labs).to(dev)}
    m, wall, launches = _launches(counters, lambda: step(batch))
    cr_loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated(dev)
    need(np.isfinite(cr_loss) and not any(launches.values()),
         f"train (e) command-r: loss {cr_loss}, launches {launches}")
    say(f"train (e) command-r-plus-104b at 1 of 64 layers "
        f"({cr.param_count()} params, fp32, Adafactor), 8 x 256, one step "
        f"(the first, set-up included): loss {cr_loss:.4f}, grad norm "
        f"{float(m['grad_norm']):.4f}, {wall * 1e3:.3f} ms, peak {peak} B "
        f"({peak / 1e9:.3f} GB)")
    out["e"]["command_r"] = {"params": cr.param_count(), "loss": cr_loss,
                             "step_s": wall, "peak_alloc_bytes": peak}
    del model, opt, step, batch, m
    torch.cuda.empty_cache()

    # (f) two-tower training with the EmbeddingBag kernel on the path.
    tcfg = get_arch("two-tower-retrieval").config_fn()
    torch.cuda.reset_peak_memory_stats(dev)
    tt = R.twotower_init(tcfg, seed=seed, device=dev, trainable=True)
    opt = opt_init(W.recsys_leaves(tt), OptConfig(
        lr=1e-3, warmup_steps=0, decay_steps=3))
    b = twotower_batch(seed, TWOTOWER_TRAIN_BATCH, tcfg.n_users,
                       tcfg.n_items, tcfg.n_user_hist)
    keys = ("user_id", "hist_ids", "hist_mask", "pos_item", "item_logq")
    args = [torch.from_numpy(b[k]).to(dev) for k in keys]

    def loss_fn(_batch, backend="auto"):
        return R.twotower_loss(tt, tcfg, *args, backend=backend)

    step = make_train_step(loss_fn, opt)
    tt_losses, tt_s = [], []
    for i in range(3):
        m, wall, launches = _launches(counters, lambda: step(None))
        need(launches["embedding_bag"] >= 1, f"train (f): step {i} "
             f"launched embedding_bag {launches['embedding_bag']} times")
        tt_losses.append(float(m["loss"]))
        tt_s.append(wall)
    need(np.isfinite(tt_losses).all(), f"train (f): losses {tt_losses}")
    peak = torch.cuda.max_memory_allocated(dev)
    u_k = R.user_embed(tt, tcfg, *args[:3])
    u_p = R.user_embed(tt, tcfg, *args[:3], backend="plain")
    need(u_k.requires_grad and torch.equal(u_k, u_p),
         "train (f): the user tower under autograd is not bit-equal to "
         "the plain path's")
    del u_k, u_p
    # Both paths scatter the item tower's rows into the table with
    # index_add_, whose CUDA atomics sum in a different order each run;
    # the deterministic algorithms fix that order for this check, so what
    # is compared is the bag's own gradient (its kernel-path VJP against
    # autograd of the plain version).
    table = tt.item_emb.table
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        g_k, = torch.autograd.grad(loss_fn(None)[0], [table])
        g_p, = torch.autograd.grad(loss_fn(None, "plain")[0], [table])
    finally:
        torch.use_deterministic_algorithms(False)
    g_err = (g_k - g_p).abs().max().item() / g_p.abs().max().item()
    need(g_err <= 1e-6, f"train (f): item-table gradient, kernel path vs "
                        f"plain autograd, {g_err} of the largest entry")
    say(f"train (f) two-tower-retrieval full size, batch "
        f"{TWOTOWER_TRAIN_BATCH}, AdamW, 3 steps: losses {tt_losses}, step "
        f"walls {[s * 1e3 for s in tt_s]} ms, embedding_bag launches "
        f"{launches['embedding_bag']} a step, peak {peak} B "
        f"({peak / 1e9:.3f} GB); user tower bit-equal to plain; item-table "
        f"gradient within {g_err:.3g} of the largest entry")
    out["f"] = {"losses": tt_losses, "step_s": tt_s,
                "bag_launches_per_step": launches["embedding_bag"],
                "peak_alloc_bytes": peak, "item_grad_rel_err": g_err}
    del tt, opt, step, g_k, g_p, args, table
    torch.cuda.empty_cache()
    return {"launches": launches, "report": out}


# ---------------------------------------------------------------------------
# phase 13: training the MoE archs (PERF.md §4's cells (g)-(i))
# ---------------------------------------------------------------------------

# (arch, layers, batch, seq, steps, optimizer): full width, depth cut to
# what fp32 parameters, gradients and optimizer state leave room for.
MOE_TRAIN_CELLS = (
    ("g", "mixtral-8x22b", 1, 1, 5120, 3, "adamw"),
    ("h", "deepseek-v2-236b", 2, 4, 1024, 2, "adafactor"),
)


def phase_train_moe(dev, counters, seed, smi_line, trace_dir=None) -> dict:
    """Training the MoE archs on the card (PERF.md §4's cells (g)-(i)),
    every run with the launch counts set to 0 just before.

    (g) mixtral-8x22b at full width, 1 of 56 layers, fp32, remat none,
    through ``train_lm`` (AdamW, lr 3e-3): 1 x 5120 (past the 4096
    window), 3 steps.  (h) deepseek-v2-236b at full width, 2 of 60
    layers (first_k_dense 1 + 1 MoE), fp32, Adafactor through
    ``make_train_step``: 4 x 1024, 2 steps.  Each: finite losses, ms a
    step, tokens/s, TFLOP/s (6 x active params x tokens), peak memory;
    no kernel of the port on the path.  (i) at both smoke configs: one
    ``train_lm`` step on the card and one on the CPU from the same
    weights (loss and grad norm within 1e-4 relative, TF32 off: the MoE
    combine and the embedding gradient add with atomics on the card),
    a card run of 4 steps with a checkpoint at 2 whose restart replays
    steps 3-4 within 1e-4, and ms a step under each remat mode (8 x 64,
    6 steps, the median of the last 4; their losses within 1e-4).  The
    learning rate of (g) and (h) is 3e-4: at 3e-3 with no warmup their
    first steps move each weight by about a quarter of its scale, and
    the loss climbs.  ``trace_dir`` (``--profile``) adds a traced run of
    each of (g) and (h)."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as T
    from repro_torch.models import weights as W
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_step import make_train_step

    out = {"card": smi_line}
    for cell, arch, n_layers, B, S, steps, kind in MOE_TRAIN_CELLS:
        cfg = dataclasses.replace(get_arch(arch).config_fn(),
                                  n_layers=n_layers, dtype="float32",
                                  remat="none")
        tokens = B * S
        if kind == "adamw":         # the trainer a user calls
            res, steps_s, peak, wall = _train_run(
                dev, counters, cfg, steps=steps, batch=B, seq_len=S,
                lr=3e-4, seed=seed)
            losses = [l for _, l in res["history"]]
            step_s = [float(s) for s in steps_s]
            if trace_dir:
                torch.cuda.empty_cache()
                prof = profile_path(f"train_{cell}", lambda: train_lm(
                    cfg, steps=2, batch=B, seq_len=S, lr=3e-4, seed=seed,
                    device=dev, log_fn=_quiet), trace_dir)
        else:                       # Adafactor: make_train_step itself
            torch.cuda.reset_peak_memory_stats(dev)
            model = T.init_params(cfg, seed=seed, device=dev,
                                  trainable=True)
            opt = opt_init(W.lm_leaves(model), OptConfig(
                kind=kind, lr=3e-4, warmup_steps=0, decay_steps=steps))
            step = make_train_step(lambda b: T.loss_fn(
                model, cfg, b["tokens"], b["labels"]), opt)
            data = SyntheticLM(LMDataConfig(cfg.vocab_size, B, S,
                                            seed=seed))
            losses, step_s = [], []
            for i in range(steps):
                toks, labs = data.batch(i)
                batch = {"tokens": torch.from_numpy(toks).to(dev),
                         "labels": torch.from_numpy(labs).to(dev)}
                m, w, launches = _launches(counters, lambda: step(batch))
                need(not any(launches.values()),
                     f"train ({cell}): launches {launches}")
                losses.append(float(m["loss"]))
                step_s.append(w)
            peak = torch.cuda.max_memory_allocated(dev)
            if trace_dir:
                prof = profile_path(f"train_{cell}", lambda: step(batch),
                                    trace_dir)
            del model, opt, step, batch, m
        need(len(losses) == steps and np.isfinite(losses).all(),
             f"train ({cell}) {arch}: losses {losses}")
        step_ms = step_s[-1] * 1e3          # the last step: warm
        n_active = cfg.active_param_count()
        tflops = 6 * n_active * tokens / (step_ms * 1e-3) / 1e12
        say(f"train ({cell}) {arch} at {n_layers} layers, full width "
            f"({cfg.param_count()} params, {n_active} active), fp32, "
            f"{kind}, {B} x {S}, {steps} steps: losses {losses}; step "
            f"walls {[s * 1e3 for s in step_s]} ms; last step "
            f"{step_ms:.3f} ms, {tokens / (step_ms * 1e-3):.1f} tokens/s, "
            f"{tflops:.2f} TFLOP/s (6 x active params x tokens), peak "
            f"{peak} B ({peak / 1e9:.3f} GB)")
        out[cell] = {"arch": arch, "layers": n_layers, "batch": B,
                     "seq": S, "optimizer": kind,
                     "params": cfg.param_count(), "active": n_active,
                     "losses": losses, "step_s": step_s,
                     "step_ms": step_ms,
                     "tokens_per_s": tokens / (step_ms * 1e-3),
                     "tflops": tflops, "peak_alloc_bytes": peak}
        if trace_dir:
            out[cell]["profile"] = prof
        torch.cuda.empty_cache()

    # (i) the smoke configs: card against the CPU, then a restart.
    out["i"] = {}
    for arch in ("mixtral-8x22b", "deepseek-v2-236b"):
        cfg = get_arch(arch).smoke_config_fn()
        tree = W.lm_to_numpy(T.init_params(cfg, seed=seed, device="cpu"))
        kw = dict(batch=2, seq_len=48, lr=3e-3, seed=seed, log_fn=_quiet)
        one = {where: train_lm(cfg, steps=1, device=where, params=tree,
                               **kw)["final"] for where in (dev, "cpu")}
        card, cpu = one[dev], one["cpu"]
        errs = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-30)
                for k in ("loss", "grad_norm", "aux")}
        need(max(errs.values()) <= 1e-4,
             f"train (i) {arch}: card {card} vs CPU {cpu}")
        tmp = tempfile.mkdtemp(prefix="chip_smoke_moe_ckpt_")
        try:
            kw4 = dict(kw, steps=4, log_every=1, ckpt_dir=tmp, ckpt_every=2,
                       device=dev, params=tree)
            first = train_lm(cfg, **kw4)
            shutil.rmtree(os.path.join(tmp, "step-00000004"))
            again = train_lm(cfg, resume=True, **kw4)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        hist = dict(first["history"])
        rerr = max(abs(l - hist[s]) / abs(hist[s])
                   for s, l in again["history"])
        need([s for s, _ in again["history"]] == [3, 4] and rerr <= 1e-4,
             f"train (i) {arch}: restart {again['history']} vs "
             f"{first['history']}")
        say(f"train (i) {arch} smoke, 2 x 48, one step: card loss "
            f"{card['loss']!r} gnorm {card['grad_norm']!r} aux "
            f"{card['aux']!r}, CPU loss {cpu['loss']!r} gnorm "
            f"{cpu['grad_norm']!r} aux {cpu['aux']!r}; relative errors "
            f"{errs}; restart from step 2 replays steps 3-4 within "
            f"{rerr:.3g}")
        remat = {}
        for mode in ("none", "dots", "full"):
            stamps = []
            res = train_lm(dataclasses.replace(cfg, remat=mode), steps=6,
                           batch=8, seq_len=64, lr=3e-3, seed=seed,
                           device=dev, params=tree, log_every=1,
                           log_fn=lambda _: stamps.append(
                               time.perf_counter()))
            remat[mode] = {"step_ms": float(np.median(np.diff(
                stamps)[1:])) * 1e3, "losses": [l for _, l in
                                                res["history"]]}
        base = remat["none"]["losses"]
        need(all(abs(a - b) <= 1e-4 * abs(b) for r in remat.values()
                 for a, b in zip(r["losses"], base, strict=True)),
             f"train (i) {arch}: remat modes disagree {remat}")
        say(f"train (i) {arch} smoke, 8 x 64, ms a step by remat mode: "
            + ", ".join(f"{k} {v['step_ms']:.3f}" for k, v in remat.items())
            + "; losses equal within 1e-4")
        out["i"][arch] = {"card": card, "cpu": cpu, "rel_err": errs,
                          "restart_rel_err": rerr,
                          "history": first["history"],
                          "resumed": again["history"], "remat": remat}
    return {"report": out}


# ---------------------------------------------------------------------------
# phase 14: SASRec, DIN and xDeepFM, and the screened retrieval
# ---------------------------------------------------------------------------

RECSYS_TRAIN_BATCH = {"sasrec": 65_536, "din": 65_536,
                      # the CIN's (B, H m, D) maps: the step holds 1.33 MB
                      # an example (22.57 GB at 16,384), so 65,536 would
                      # need ~88 GB; cut to the largest multiple of 16,384
                      # that fits (PERF.md §4)
                      "xdeepfm": 49_152}
RECSYS_SLICE = 8            # rows held against the CPU
SCREEN_SHORTLIST = 4096


def _walls(counters, fn, n=5):
    """``n`` synchronised walls of ``fn`` (after one warm-up), its last
    result and the last run's launch counts."""
    fn()
    walls = []
    for _ in range(n):
        res, w, launches = _launches(counters, fn)
        walls.append(w)
    return res, walls, launches


def _rel(a, b) -> float:
    """max |a - b| over the largest |b| (both moved to the CPU)."""
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def phase_recsys_models(dev, counters, seed, smi_line,
                        trace_dir=None) -> dict:
    """SASRec, DIN and xDeepFM at their ``_FULL`` widths (seeded random
    weights, fp32) and the screened two-tower retrieval.  Each model:
    ``serve_p99`` (512 users: SASRec against 200 candidates each, DIN and
    xDeepFM one target each) and ``retrieval_cand`` (SASRec and DIN: one
    user over the 1,000,000-item catalog, ``sasrec_score`` of the whole
    catalog, ``din_score_candidates`` in blocks of 65,536; xDeepFM:
    1,000,000 candidate rows, ``xdeepfm_score_candidates`` in blocks of
    32,768, ranked by ``_topk_ordered``; top 100) walls, five each (three
    for xDeepFM) after a warm-up; two AdamW steps through
    ``make_train_step`` at ``train_batch`` 65,536 (xDeepFM 49,152), the
    second step's wall and the peak memory; then the card's outputs on
    the first 8 rows (serving logits, the train batch's loss) and on the
    first 4096 retrieval candidates against the CPU's from the same
    weights, within 1e-5 of the largest entry.  Then
    ``retrieval_scores_screened`` at two-tower ``_FULL``, 1 x 1,000,000,
    shortlist 4096, beside ``retrieval_scores`` in the same run (five
    walls each, alternated): its top-100 ids equal to the exact path's
    and its scores within 1e-5 of them; the bag kernel launched once a
    query on both.  ``trace_dir`` (``--profile``) adds traced runs of
    DIN's ``retrieval_cand``, each model's train step and both
    retrievals."""
    import torch
    from repro_torch.configs import RECSYS_SHAPES, get_arch
    from repro_torch.data import recsys_data as D
    from repro_torch.models import recsys as R
    from repro_torch.models import weights as W
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_step import make_train_step

    n_p99 = RECSYS_SHAPES["serve_p99"].dims["batch"]
    n_cand = RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    out = {"card": smi_line}
    rng = np.random.default_rng(seed)

    def on(b, where, rows=None):
        return {k: torch.from_numpy(v if rows is None else v[:rows]).to(
            where) for k, v in b.items()}

    for name in ("sasrec", "din", "xdeepfm"):
        cfg = get_arch(name).config_fn()
        init = {"sasrec": R.sasrec_init, "din": R.din_init,
                "xdeepfm": R.xdeepfm_init}[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = init(cfg, seed=seed, device=dev, trainable=True)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cpu_model = W.recsys_from_numpy(W.recsys_to_numpy(model), "cpu")
        n_params = sum(p.numel() for p in model.parameters())
        rep = {"params": n_params, "init_s": init_s}

        # serve_p99, and retrieval_cand where the JAX cell has one
        if name == "sasrec":
            b = D.sasrec_batch(seed, n_p99, cfg.seq_len, cfg.n_items, 1)
            sb = {"seq_ids": b["seq_ids"], "cand": rng.integers(
                1, cfg.n_items, (n_p99, 200)).astype(np.int32)}

            def serve(m, t):
                return R.sasrec_score(m, cfg, t["seq_ids"], t["cand"])

            q = {"seq_ids": b["seq_ids"][:1]}
            cand = None

            def retrieve(m, t, c=None):
                s = R.sasrec_score(m, cfg, t["seq_ids"])
                return s if c is None else s[:, :c]
        elif name == "din":
            b = D.din_batch(seed, n_p99, cfg.seq_len, cfg.n_items,
                            cfg.n_context, cfg.n_context_fields)
            sb = {k: b[k] for k in ("hist_ids", "target_id", "ctx_ids")}

            def serve(m, t):
                return R.din_forward(m, cfg, t["hist_ids"], t["target_id"],
                                     t["ctx_ids"])

            q = {"hist_ids": b["hist_ids"][:1], "ctx_ids": b["ctx_ids"][:1]}
            cand = rng.permutation(cfg.n_items)[:n_cand].astype(np.int32)

            def retrieve(m, t, c=None):
                ids = t["cand"] if c is None else t["cand"][:c]
                return R.din_score_candidates(m, cfg, t["hist_ids"],
                                              t["ctx_ids"], ids)
        else:
            b = D.xdeepfm_batch(seed, n_p99, cfg.n_fields,
                                cfg.vocab_per_field)
            sb = {"field_ids": b["field_ids"]}

            def serve(m, t):
                return R.xdeepfm_forward(m, cfg, t["field_ids"])

            q = {}
            cand = D.xdeepfm_batch(seed + 1, n_cand, cfg.n_fields,
                                   cfg.vocab_per_field)["field_ids"]

            def retrieve(m, t, c=None):
                ids = t["cand"] if c is None else t["cand"][:c]
                return R.xdeepfm_score_candidates(m, cfg, ids)

        with torch.inference_mode():
            sd = on(sb, dev)
            y, walls, launches = _walls(counters, lambda: serve(model, sd))
            need(not any(launches.values()), f"{name} serve_p99: launches "
                 f"{launches}")
            need(bool(torch.isfinite(y).all().item()),
                 f"{name} serve_p99: not finite")
            s_err = _rel(y[:RECSYS_SLICE], serve(cpu_model, on(
                sb, "cpu", RECSYS_SLICE)))
            need(s_err <= 1e-5, f"{name} serve_p99: card vs CPU {s_err}")
            rep["serve_p99"] = {"batch": n_p99, "walls_s": walls,
                                "cpu_rel_err": s_err}
            if retrieve is not None:
                qb = dict(q) if cand is None else dict(q, cand=cand)
                qd = on(qb, dev)

                def run():
                    scores = retrieve(model, qd)
                    if name == "xdeepfm":     # one score a candidate row
                        return R._topk_ordered(scores, 100)
                    return torch.topk(scores, 100, dim=-1)

                (vals, idx), rwalls, launches = _walls(
                    counters, run, n=3 if name == "xdeepfm" else 5)
                n_items = cfg.n_items if cand is None else len(cand)
                need(not any(launches.values())
                     and bool(torch.isfinite(vals).all().item()),
                     f"{name} retrieval_cand: launches {launches}")
                r_err = _rel(retrieve(model, qd, 4096),
                             retrieve(cpu_model, on(qb, "cpu"), 4096))
                need(r_err <= 1e-5, f"{name} retrieval_cand: first 4096 "
                     f"candidates, card vs CPU {r_err}")
                rep["retrieval_cand"] = {"candidates": n_items,
                                         "walls_s": rwalls,
                                         "cpu_rel_err_4096": r_err}
                if trace_dir and name == "din":
                    rep["retrieval_cand"]["profile"] = profile_path(
                        f"{name}_retrieval_cand", run, trace_dir)
                del qd, vals, idx
            del sd, y

        # train_batch: two AdamW steps
        B = RECSYS_TRAIN_BATCH[name]
        tb = {"sasrec": lambda: D.sasrec_batch(seed, B, cfg.seq_len,
                                               cfg.n_items, cfg.n_negatives),
              "din": lambda: D.din_batch(seed, B, cfg.seq_len, cfg.n_items,
                                         cfg.n_context,
                                         cfg.n_context_fields),
              "xdeepfm": lambda: D.xdeepfm_batch(
                  seed, B, cfg.n_fields, cfg.vocab_per_field)}[name]()
        loss = {"sasrec": R.sasrec_loss, "din": R.din_loss,
                "xdeepfm": R.xdeepfm_loss}[name]
        keys = list(tb)
        l_cpu = float(loss(cpu_model, cfg, *on(tb, "cpu", RECSYS_SLICE)
                           .values())[0])
        with torch.no_grad():
            l_card = float(loss(model, cfg, *on(tb, dev, RECSYS_SLICE)
                                .values())[0])
        l_err = abs(l_card - l_cpu) / abs(l_cpu)
        need(l_err <= 1e-5, f"{name} train slice loss: card {l_card} vs "
                            f"CPU {l_cpu}")
        td = on(tb, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        opt = opt_init(W.recsys_leaves(model), OptConfig(
            lr=1e-3, warmup_steps=0, decay_steps=2))
        step = make_train_step(lambda bt: loss(model, cfg,
                                               *(bt[k] for k in keys)), opt)
        losses, step_s = [], []
        for _ in range(2):
            m, w, launches = _launches(counters, lambda: step(td))
            need(not any(launches.values()), f"{name} train: launches "
                 f"{launches}")
            losses.append(float(m["loss"]))
            step_s.append(w)
        peak = torch.cuda.max_memory_allocated(dev)
        need(np.isfinite(losses).all(), f"{name} train: losses {losses}")
        rep["train"] = {"batch": B, "losses": losses, "step_s": step_s,
                        "examples_per_s": B / step_s[-1],
                        "peak_alloc_bytes": peak,
                        "cpu_slice_loss_rel_err": l_err}
        if trace_dir:
            rep["train"]["profile"] = profile_path(
                f"{name}_train", lambda: step(td), trace_dir)
        say(f"phase recsys_models: {name} ({n_params} params, init "
            f"{init_s:.2f} s): serve_p99 x {n_p99} walls "
            f"{[w * 1e3 for w in walls]} ms (card vs CPU {s_err:.3g}); "
            + (f"retrieval_cand 1 x {n_items} top-100 walls "
               f"{[w * 1e3 for w in rep['retrieval_cand']['walls_s']]} ms "
               f"(first 4096 vs CPU "
               f"{rep['retrieval_cand']['cpu_rel_err_4096']:.3g}); "
               if retrieve is not None else "")
            + f"train_batch {B}, AdamW, 2 steps: losses {losses}, walls "
            f"{[w * 1e3 for w in step_s]} ms, {B / step_s[-1]:.1f} "
            f"examples/s, peak {peak} B ({peak / 1e9:.3f} GB); slice loss "
            f"card vs CPU {l_err:.3g}")
        out[name] = rep
        del model, cpu_model, opt, step, td, m
        torch.cuda.empty_cache()

    # The screened retrieval beside the exact one, two-tower _FULL.
    tcfg = get_arch("two-tower-retrieval").config_fn()
    tt = R.twotower_init(tcfg, seed=seed, device=dev)
    b = D.twotower_batch(seed, 1, tcfg.n_users, tcfg.n_items,
                         tcfg.n_user_hist)
    args = [torch.from_numpy(b[k]).to(dev)
            for k in ("user_id", "hist_ids", "hist_mask")]
    cand = torch.from_numpy(np.random.default_rng(seed).permutation(
        tcfg.n_items)[:n_cand].astype(np.int32)).to(dev)
    runs = {"exact": lambda: R.retrieval_scores(tt, tcfg, *args, cand,
                                                topk=100),
            "screened": lambda: R.retrieval_scores_screened(
                tt, tcfg, *args, cand, topk=100,
                shortlist=SCREEN_SHORTLIST)}
    walls = {k: [] for k in runs}
    res = {}
    with torch.inference_mode():
        for k, fn in runs.items():
            fn()                                         # warm-up
        for _ in range(5):
            for k, fn in runs.items():
                res[k], w, launches = _launches(counters, fn)
                need(launches["embedding_bag"] == 1, f"retrieval {k}: "
                     f"embedding_bag launched {launches['embedding_bag']}")
                walls[k].append(w)
    (ve, ie), (vs, is_) = res["exact"], res["screened"]
    need(torch.equal(ie, is_), "screened retrieval: top-100 ids differ "
                               "from the exact path's")
    v_err = (vs - ve).abs().max().item()
    need(v_err <= 1e-5, f"screened retrieval: scores differ ({v_err})")
    med = {k: float(np.median(v)) * 1e3 for k, v in walls.items()}
    say(f"phase recsys_models: two-tower retrieval_cand 1 x {n_cand}, top "
        f"100: exact walls {[w * 1e3 for w in walls['exact']]} ms, screened "
        f"(bf16 screen, shortlist {SCREEN_SHORTLIST}) walls "
        f"{[w * 1e3 for w in walls['screened']]} ms; medians "
        f"{med['exact']:.3f} / {med['screened']:.3f} ms "
        f"({med['exact'] / med['screened']:.2f}x); top-100 ids equal, "
        f"scores within {v_err:.3g}")
    out["screened"] = {"candidates": n_cand, "shortlist": SCREEN_SHORTLIST,
                       "walls_s": walls, "median_ms": med,
                       "score_err": v_err}
    if trace_dir:
        with torch.inference_mode():
            out["screened"]["profile"] = {
                k: profile_path(f"retrieval_{k}", fn, trace_dir)
                for k, fn in runs.items()}
    del tt, args, cand, res
    torch.cuda.empty_cache()
    return {"report": out}


# ---------------------------------------------------------------------------
# phase 15: GraphSAGE training, the sharded loss and int8 compression
# ---------------------------------------------------------------------------

GNN_STEPS = 3
GNN_BATCH_NODES = 1024      # minibatch_lg's batch_nodes
GNN_F_PAD = 112             # ogb_products' 100 features padded to /16
GNN_CPU_TOL = 1e-4          # (c) card against the CPU
GNN_SHARDED_TOL = 1e-5      # (d) the sharded loss against loss_full


def _gnn_graph(shape, seed):
    """The ``GNN_SHAPES`` cell's synthetic graph (``data.graph_data``; the
    padded node and edge counts where the shape has them, else the raw
    ones) and its host wall."""
    from repro_torch.configs import GNN_SHAPES
    from repro_torch.data import graph_data as GD
    d = GNN_SHAPES[shape].dims
    t0 = time.perf_counter()
    if shape == "molecule":
        g = GD.gen_batched_molecules(d["batch_graphs"], d["nodes_per_graph"],
                                     d["edges_per_graph"], d["d_feat"],
                                     d["n_classes"], seed=seed)
    else:
        n = d.get("n_nodes", d["raw_nodes"])
        e = d.get("n_edges", d["raw_edges"])
        g = GD.gen_powerlaw_graph(n, e / n, d["d_feat"], d["n_classes"],
                                  seed=seed)
    return g, time.perf_counter() - t0


def _gnn_mask(n):
    """Every node labelled but every third (the loss's mask)."""
    m = np.ones(n, bool)
    m[::3] = False
    return m


def _gnn_grads(model, loss):
    """The gradient of every leaf of a GraphSAGE model, by JAX path."""
    import torch
    from repro_torch.models import weights as W
    leaves = W.gnn_leaves(model)
    grads = torch.autograd.grad(loss, [ps[0] for _, ps, _ in leaves])
    return {p: g for (p, _, _), g in zip(leaves, grads, strict=True)}


def _grad_err(got, want) -> float:
    """The largest, over leaves, of max |got - want| over the leaf's
    largest |want| (both moved to the CPU)."""
    return max(_rel(got[k], want[k]) for k in want)


def phase_gnn(dev, counters, seed, smi_line, trace_dir=None) -> dict:
    """GraphSAGE (graphsage-reddit) at full width, fp32, seeded weights,
    AdamW at the JAX cell's lr 3e-4 through ``make_train_step`` (PERF.md
    §4's cells (a)-(e)):

    (a) ``ogb_products`` full-batch: 2,449,408 x 100 features, 61,859,840
        edges, 47 classes, 3 steps through ``loss_full``: finite losses,
        ms a step, peak allocated, device busy share of one more step;
    (b) ``minibatch_lg`` sampled: the Reddit-scale graph (232,965 nodes,
        114,615,892 edges, 602 features, 41 classes), 1024 seeds,
        fanouts (15, 10), 3 steps on fresh batches through
        ``loss_sampled``: set-up (graph, CSR), sample, upload and step
        walls apart;
    (c) ``full_graph_sm``, ``molecule`` and the sampled smoke config:
        loss and gradients on the card (deterministic algorithms) against
        the CPU's from the same weights;
    (d) ``make_sharded_loss``: (1,1) under NCCL in this process at
        ``ogb_products`` (features padded to 112), gloo worlds (2,1),
        (1,2), (2,2) sharing the card at ``full_graph_sm`` (1433 features
        padded to 1434): loss and every gradient against ``loss_full``'s
        on the card (``launch.gnn_ranks.rank_checks``); at
        ``full_graph_sm`` both sides under deterministic algorithms;
    (e) ``quantize_int8`` on the card bit-equal to the CPU's;
        ``compressed_psum_int8`` and ``compressed_crosspod_allreduce`` in
        the gloo world of 2 on a (pod 2, data 1, model 1) mesh against
        the sums of the CPU's payloads, and a replicated leaf's cross-pod
        mean within the JAX test's 0.05 of itself.

    No kernel of the port is on these paths: every launch count is read
    around (a) and (b) and must be 0."""
    import dataclasses
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.data import graph_data as GD
    from repro_torch.distributed.compression import quantize_int8
    from repro_torch.launch.forcedevices import free_port, run_ranks
    from repro_torch.launch.gnn_ranks import rank_checks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import gnn as G
    from repro_torch.models import weights as W
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.train_step import make_train_step

    spec = get_arch("graphsage-reddit")
    out = {"card": smi_line}
    opt_cfg = OptConfig(kind="adamw", lr=3e-4)
    zero = {c.__name__: 0 for c in counters}

    def trained(model, loss):
        return make_train_step(loss, opt_init(W.gnn_leaves(model), opt_cfg))

    # (a) ogb_products, full batch
    cfg = spec.config_fn("ogb_products")
    g, gen_s = _gnn_graph("ogb_products", seed)
    n = g.x.shape[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch = tuple(torch.from_numpy(a).to(dev) for a in (
        g.x, g.edge_src, g.edge_dst, g.labels, np.ones(n, bool)))
    torch.cuda.synchronize()
    up_s = time.perf_counter() - t0
    model, _ = G.init_params(cfg, seed=seed, device=dev, trainable=True)
    step = trained(model, lambda b: G.loss_full(model, cfg, *b))
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls, launches = [], [], []
    for _ in range(GNN_STEPS):
        m, w, ln = _launches(counters, lambda: step(batch))
        losses.append(float(m["loss"]))
        walls.append(w)
        launches.append(ln)
    peak = torch.cuda.max_memory_allocated(dev)
    need(all(ln == zero for ln in launches), f"gnn (a): launches {launches}")
    need(bool(np.isfinite(losses).all()), f"gnn (a): losses {losses}")
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        busy = _busy(lambda: step(batch), Path(tmp))
    e = g.edge_src.shape[0]
    out["ogb_products"] = {
        "nodes": n, "edges": e, "graph_s": gen_s, "upload_s": up_s,
        "losses": losses, "step_s": walls, "peak_alloc_bytes": peak,
        "busy": busy, "launches": launches[-1], "edge_chunks": 1}
    if trace_dir:
        out["ogb_products"]["profile"] = profile_path(
            "gnn_ogb_products_step", lambda: step(batch), trace_dir)
    say(f"phase gnn (a): ogb_products full batch ({n} nodes, {e} edges, "
        f"d_feat {cfg.d_feat}; graph {gen_s:.2f} s, upload {up_s:.3f} s): "
        f"AdamW, {GNN_STEPS} steps: losses {losses}, walls "
        f"{[w * 1e3 for w in walls]} ms, peak {peak} B "
        f"({peak / 1e9:.3f} GB); one more step under the profiler: wall "
        f"{busy['wall_ms']:.3f} ms, device busy "
        f"{busy['device_busy_ms']:.3f} ms, idle share {busy['idle_share']}; "
        f"launches {launches[-1]}")
    del step, m
    torch.cuda.empty_cache()

    # (d) the sharded loss at (1,1), NCCL, ogb_products padded to 112
    cfg_p = dataclasses.replace(cfg, d_feat=GNN_F_PAD)
    model_p, _ = G.init_params(cfg_p, seed=seed + 1, device=dev,
                               trainable=True)
    dist.init_process_group("nccl", init_method="tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_host_mesh((1, 1))
        parts = G.shard_graph(batch[0], *batch[1:], 0, 0, 1, 1, GNN_F_PAD)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_s = G.make_sharded_loss(mesh, cfg_p, n, GNN_F_PAD)(model_p,
                                                                *parts)
        grads_s = _gnn_grads(model_p, loss_s)
        torch.cuda.synchronize()
        sh_s = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    loss_f, _ = G.loss_full(model_p, cfg_p, parts[0], *batch[1:])
    grads_f = _gnn_grads(model_p, loss_f)
    l_err = abs(loss_s.item() - loss_f.item()) / abs(loss_f.item())
    g_err = _grad_err(grads_s, grads_f)
    need(l_err <= GNN_SHARDED_TOL and g_err <= GNN_SHARDED_TOL,
         f"gnn (d) (1,1) ogb_products: sharded vs loss_full: loss "
         f"{l_err}, gradients {g_err}")
    out["sharded"] = {"1x1": {"backend": "nccl", "f_pad": GNN_F_PAD,
                              "loss_rel_err": l_err, "grad_rel_err": g_err,
                              "loss_and_grads_s": sh_s}}
    say(f"phase gnn (d): make_sharded_loss (1,1) NCCL at ogb_products, "
        f"features padded to {GNN_F_PAD}: loss {loss_s.item()} vs "
        f"loss_full {loss_f.item()} ({l_err:.3g}), gradients within "
        f"{g_err:.3g} of each leaf's largest; loss + gradients "
        f"{sh_s * 1e3:.1f} ms")
    del batch, parts, model_p, model, grads_s, grads_f, loss_s, loss_f, g
    torch.cuda.empty_cache()

    # (b) minibatch_lg: the Reddit-scale graph, sampled
    cfg = spec.config_fn("minibatch_lg")
    g, gen_s = _gnn_graph("minibatch_lg", seed)
    n = g.x.shape[0]
    t0 = time.perf_counter()
    sampler = GD.NeighborSampler(g.edge_src, g.edge_dst, n, seed=seed)
    csr_s = time.perf_counter() - t0
    model, _ = G.init_params(cfg, seed=seed, device=dev, trainable=True)
    step = trained(model, lambda b: G.loss_sampled(model, cfg, *b))
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(GNN_STEPS):
        seeds = rng.integers(0, n, GNN_BATCH_NODES)
        t0 = time.perf_counter()
        feats, masks = sampler.sample_batch(seeds, tuple(cfg.fanouts), g.x)
        labels = g.labels[seeds]
        t1 = time.perf_counter()
        b = (tuple(torch.from_numpy(np.ascontiguousarray(f)).to(dev)
                   for f in feats),
             tuple(torch.from_numpy(np.ascontiguousarray(m)).to(dev)
                   for m in masks),
             torch.from_numpy(labels).to(dev))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        m, w, ln = _launches(counters, lambda: step(b))
        need(ln == zero, f"gnn (b): launches {ln}")
        rows.append({"sample_s": t1 - t0, "upload_s": t2 - t1,
                     "step_s": w, "loss": float(m["loss"]),
                     "upload_bytes": sum(int(x.nbytes) for x in
                                         b[0] + b[1])})
    need(all(np.isfinite(r["loss"]) for r in rows), f"gnn (b): {rows}")
    e = g.edge_src.shape[0]
    out["minibatch_lg"] = {"nodes": n, "edges": e, "graph_s": gen_s,
                           "csr_s": csr_s, "steps": rows}
    say(f"phase gnn (b): minibatch_lg sampled ({n} nodes, {e} edges, "
        f"d_feat {cfg.d_feat}, batch {GNN_BATCH_NODES}, fanouts "
        f"{tuple(cfg.fanouts)}): set-up {gen_s + csr_s:.2f} s (graph "
        f"{gen_s:.2f}, CSR {csr_s:.2f}); per step sample "
        f"{[r['sample_s'] * 1e3 for r in rows]} ms, upload "
        f"{[r['upload_s'] * 1e3 for r in rows]} ms "
        f"({rows[0]['upload_bytes']} B), step "
        f"{[r['step_s'] * 1e3 for r in rows]} ms, losses "
        f"{[r['loss'] for r in rows]}")
    del sampler, step, model, b, g, m
    torch.cuda.empty_cache()

    # (c) card against CPU at the small shapes, deterministic sums
    cells = {}
    for name in ("full_graph_sm", "molecule", "sampled-smoke"):
        if name == "sampled-smoke":
            cfg = spec.smoke_config_fn()
            gs = GD.gen_powerlaw_graph(500, 8.0, cfg.d_feat, cfg.n_classes,
                                       seed=seed)
            feats, masks = GD.NeighborSampler(
                gs.edge_src, gs.edge_dst, 500, seed=seed).sample_batch(
                    np.arange(64), tuple(cfg.fanouts), gs.x)
            host = (tuple(np.ascontiguousarray(f) for f in feats),
                    tuple(np.ascontiguousarray(m) for m in masks),
                    gs.labels[:64])

            def to(where, h=host):
                return (tuple(torch.from_numpy(a).to(where) for a in h[0]),
                        tuple(torch.from_numpy(a).to(where) for a in h[1]),
                        torch.from_numpy(h[2]).to(where))
            loss_of = G.loss_sampled
        else:
            cfg = spec.config_fn(name)
            gs, _ = _gnn_graph(name, seed)
            host = (gs.x, gs.edge_src, gs.edge_dst, gs.labels,
                    _gnn_mask(gs.x.shape[0]))

            def to(where, h=host):
                return tuple(torch.from_numpy(a).to(where) for a in h)
            loss_of = G.loss_full
        cpu_model, _ = G.init_params(cfg, seed=seed, device="cpu",
                                     trainable=True)
        card_model = W.gnn_from_numpy(W.gnn_to_numpy(cpu_model), dev,
                                      trainable=True)
        l_cpu, _ = loss_of(cpu_model, cfg, *to("cpu"))
        g_cpu = _gnn_grads(cpu_model, l_cpu)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            l_card, _ = loss_of(card_model, cfg, *to(dev))
            g_card = _gnn_grads(card_model, l_card)
        finally:
            torch.use_deterministic_algorithms(False)
        l_err = abs(l_card.item() - l_cpu.item()) / abs(l_cpu.item())
        g_err = _grad_err(g_card, g_cpu)
        need(l_err <= GNN_CPU_TOL and g_err <= GNN_CPU_TOL,
             f"gnn (c) {name}: card vs CPU loss {l_err}, gradients {g_err}")
        cells[name] = {"loss_rel_err": l_err, "grad_rel_err": g_err}
    out["card_vs_cpu"] = cells
    say("phase gnn (c): card vs CPU (deterministic algorithms), loss / "
        "largest gradient error: " + ", ".join(
            f"{k} {v['loss_rel_err']:.3g} / {v['grad_rel_err']:.3g}"
            for k, v in cells.items()))

    # (e) quantize_int8 on the card against the CPU
    xr = np.random.default_rng(seed)
    qx = {"normal": (xr.normal(size=(4096, 1024)) * 3).astype(np.float32),
          "ties": ((np.arange(-20, 21, dtype=np.float32) + 0.5)
                   * np.float32(127 / 20.5))}
    for k, x in qx.items():
        qc, sc = quantize_int8(torch.from_numpy(x))
        qd, sd = quantize_int8(torch.from_numpy(x).to(dev))
        need(torch.equal(qd.cpu(), qc) and torch.equal(
            sd.cpu().view(torch.int32), sc.view(torch.int32)),
             f"gnn (e): quantize_int8 {k} on the card differs from the CPU")

    # (d) gloo worlds sharing the card at full_graph_sm, and (e) the
    # compressed all-reductions in the world of 2
    cfg = spec.config_fn("full_graph_sm")
    f_pad = cfg.d_feat + 1                  # 1434 divides model 2
    cfg_p = dataclasses.replace(cfg, d_feat=f_pad)
    gs, _ = _gnn_graph("full_graph_sm", seed)
    xp = np.zeros((gs.x.shape[0], f_pad), np.float32)
    xp[:, :cfg.d_feat] = gs.x
    graph = (xp, gs.edge_src, gs.edge_dst, gs.labels,
             _gnn_mask(gs.x.shape[0]))
    ref_model, _ = G.init_params(cfg_p, seed=seed, device=dev,
                                 trainable=True)
    tree = W.gnn_to_numpy(ref_model)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        l_ref, _ = G.loss_full(ref_model, cfg_p, *(
            torch.from_numpy(a).to(dev) for a in graph))
        g_ref = _gnn_grads(ref_model, l_ref)
    finally:
        torch.use_deterministic_algorithms(False)
    l_ref = l_ref.item()
    rep = np.linspace(-2, 2, 256, dtype=np.float32).reshape(16, 16)
    trees = [{"w": (xr.normal(size=(64, 32)) * (r + 1)).astype(np.float32),
              "rep": rep} for r in range(2)]
    worlds = {2: ([((2, 1), cfg_p, tree, graph, f_pad),
                   ((1, 2), cfg_p, tree, graph, f_pad)],
                  ((2, 1, 1), ("pod", "data", "model"), trees)),
              4: ([((2, 2), cfg_p, tree, graph, f_pad)], None)}
    for world, (jobs, comp) in worlds.items():
        t0 = time.perf_counter()
        res = run_ranks(rank_checks, world, (jobs, comp, str(dev)),
                        timeout_s=RANK_TIMEOUT_S, threads=0)
        wall = time.perf_counter() - t0
        for j, (shape, *_rest) in enumerate(jobs):
            errs = []
            for r, got in enumerate(res):
                loss, grads = got["sharded"][j]
                l_err = abs(loss - l_ref) / abs(l_ref)
                g_err = max(_rel(torch.from_numpy(grads[k]), g_ref[k])
                            for k in g_ref)
                need(l_err <= GNN_SHARDED_TOL and g_err <= GNN_SHARDED_TOL,
                     f"gnn (d) {shape} rank {r}: sharded vs loss_full: "
                     f"loss {l_err}, gradients {g_err}")
                errs.append((l_err, g_err))
            out["sharded"][f"{shape[0]}x{shape[1]}"] = {
                "backend": "gloo", "ranks": world, "f_pad": f_pad,
                "loss_rel_err": max(a for a, _ in errs),
                "grad_rel_err": max(b for _, b in errs),
                "world_wall_s": wall}
        if comp is not None:
            qs = [{k: quantize_int8(torch.from_numpy(v)) for k, v in t.items()}
                  for t in trees]
            c_err = 0.0
            for got in res:
                psum, cross = got["comp"]
                for k in trees[0]:
                    acc = sum(q[k][0].to(torch.int32) for q in qs)
                    want = acc.to(torch.float32) * (
                        (qs[0][k][1] + qs[1][k][1]) / 2.0)
                    for a, b in ((psum[k], want), (cross[k], want / 2.0)):
                        c_err = max(c_err, _rel(torch.from_numpy(a), b))
                need(float(np.abs(cross["rep"] - rep).max()) < 0.05,
                     "gnn (e): the replicated leaf's cross-pod mean is not "
                     "within 0.05 of itself")
            need(c_err <= 1e-6, f"gnn (e): compressed all-reductions off "
                                f"the CPU payloads' sums by {c_err}")
            out["compression"] = {"quantize_bit_equal": True,
                                  "allreduce_rel_err": c_err}
        say(f"phase gnn (d): gloo world of {world} on the card "
            f"({wall:.1f} s): " + ", ".join(
                f"{k} loss {v['loss_rel_err']:.3g}, gradients "
                f"{v['grad_rel_err']:.3g}" for k, v in out["sharded"].items()
                if v.get("ranks") == world)
            + (f"; (e) quantize_int8 card = CPU bit for bit, compressed "
               f"psum / cross-pod mean within {c_err:.3g} of the CPU "
               f"payloads' sums" if comp is not None else ""))
    del ref_model, g_ref
    torch.cuda.empty_cache()
    return {"report": out}


# ---------------------------------------------------------------------------
# phase 10: the sharded miner (DistributedMiner over a (block, cls) mesh)
# ---------------------------------------------------------------------------

# The JAX DistributedMiner's counters on kosarak-paper @ 0.1 (99,000
# transactions, minsup 248), eclat, ES on, inflight=2, autotune_chunk=True,
# pair_chunk=65536, per mesh shape (block x cls), on forced host devices:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_distributed_counters.py \
#       --dataset kosarak-paper --scale 0.1 --meshes 1x1,2x1,1x2,2x2,4x1
_JAX_COMMON_01 = dict(
    candidates=5642, child_scatters=1367, compaction_occupancy=0.125,
    compactions=5, device_calls=5, device_occupancy=0.0,
    frequent_itemsets=1457, inflight_groups=2, nodes=1457, peak_rows=4095,
    ratio=3.8723, scatter_words=4374400, store_grows=0,
    word_ops_full=18054400)
_JAX_ES_11 = dict(deaths=4275, kernel_aborts=4086, screened_out=189,
                  word_ops=10584832, word_ops_saved_frac=0.4137)
_JAX_ES_21 = dict(deaths=2663, kernel_aborts=2423, screened_out=240,
                  word_ops=14402560, word_ops_saved_frac=0.2023)
JAX_DISTRIBUTED_01 = {
    (1, 1): dict(_JAX_COMMON_01, **_JAX_ES_11),
    (1, 2): dict(_JAX_COMMON_01, **_JAX_ES_11),
    (2, 1): dict(_JAX_COMMON_01, **_JAX_ES_21),
    (2, 2): dict(_JAX_COMMON_01, **_JAX_ES_21),
    (4, 1): dict(_JAX_COMMON_01, deaths=1609, kernel_aborts=773,
                 screened_out=836, word_ops=16556288,
                 word_ops_saved_frac=0.083)}

# The knobs of the main path's miner (_miner), for every mesh.
SHARDED_KNOBS = dict(inflight=2, autotune_chunk=True, pair_chunk=65536)
RANK_TIMEOUT_S = 400.0


def _mine_counted(mesh, bdb, ms, dev, *, scheme="eclat", es=True):
    """One DistributedMiner run on ``mesh`` with every kernel's launch
    count zeroed just before and read just after (the card synchronised
    on both sides).  Returns ``(itemsets, counters, wall_s, launches)``."""
    from repro_torch.core.distributed import DistributedMiner
    counters = _kernel_counters()

    def run():
        return DistributedMiner(mesh, scheme=scheme, early_stop=es,
                                device=dev, **SHARDED_KNOBS).mine_packed(
                                    bdb, ms)
    (out, st), wall, ln = _launches(counters, run)
    return out, _non_time(st.as_dict()), wall, ln, run


def _warm_wall(run) -> float:
    """The host wall of one more run (s), the card synchronised on both
    sides: the first run of a mesh also pays the communicators' set-up."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _busy(run, where: Path) -> dict:
    """One more run under torch.profiler: wall, device busy (this
    process's own device work) and idle share (the trace is read and
    removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    where.mkdir(parents=True, exist_ok=True)
    path = where / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(path))
    busy_ms, spans, _ = _trace_busy(path)
    path.unlink()
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms) if spans else None}


def _sharded_rank(rank, world, jobs, trace_dir, device):
    """One gloo rank on ``device`` (cuda:0, shared by every rank): for
    each job ``(shape, name, bdb, minsup, scheme, profile)`` a
    DistributedMiner run (ES on) on a ``shape`` mesh of this world.
    Returns per job its itemsets, counters, wall, launches and (where
    asked) device busy."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mining_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        _build.load()              # built by the parent: loaded from disk
    meshes, out = {}, []
    for shape, name, bdb, ms, scheme, prof in jobs:
        if shape not in meshes:
            meshes[shape] = make_mining_mesh(block=shape[0], cls=shape[1])
        got, cnt, wall, ln, run = _mine_counted(meshes[shape], bdb, ms, dev,
                                                scheme=scheme)
        kernel = "bitmap_diff_es" if scheme == "declat" else \
            "bitmap_intersect_es"
        need(ln[kernel] > 0, f"rank {rank} {name} {shape}: {kernel} "
                             f"launched no time")
        warm = _warm_wall(run) if prof else None
        busy = _busy(run, Path(trace_dir)) if prof else None
        out.append({"itemsets": got, "counters": cnt, "wall_s": wall,
                    "warm_wall_s": warm, "launches": ln, "busy": busy})
    return out


def _kernel_counters():
    from repro_torch.kernels.bitmap_diff import bitmap_diff_es
    from repro_torch.kernels.bitmap_intersect import bitmap_intersect_es
    from repro_torch.kernels.compact import compact_gather
    return (bitmap_intersect_es, compact_gather, bitmap_diff_es)


def phase_sharded(dev, main, declat, smi_line) -> dict:
    """The sharded miner on the card: mesh (1,1) under NCCL in this
    process at kosarak-paper @ 1.0 (ES on and off, equal to phase 4's
    itemsets and counters) and @ 0.1 (equal to the JAX table); then gloo
    worlds of 2 and 4 ranks sharing the card: (1,2), (2,1), (2,2), (4,1)
    at kosarak @ 1.0 (itemsets equal to phase 4's, (1,2)'s counters equal
    to (1,1)'s) and @ 0.1 (the JAX table), and declat/adaptive on
    accidents-paper @ 1.0 on (2,1) (itemsets equal to phase 5's)."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.data.transactions import stream_paper_dataset
    from repro_torch.launch.forcedevices import free_port, run_ranks
    from repro_torch.launch.mesh import make_mining_mesh

    bdb, ms = main["bdb"], main["minsup"]
    bdb01, ms01 = stream_paper_dataset("kosarak-paper", scale=0.1, seed=0)
    ms01 = ms01[0]
    acc, acc_ms = declat["bdb"], declat["minsup"]
    want_full = _non_time(main["report"]["full"])
    want_es = _non_time(main["report"]["es"])
    for d in (want_full, want_es):
        d.pop("frequent_itemsets", None)
    report, launches = {}, {}

    def check_01(shape, got, cnt):
        want = JAX_DISTRIBUTED_01[shape]
        bad = {k: (cnt.get(k, len(got)), v) for k, v in want.items()
               if (len(got) if k == "frequent_itemsets" else cnt.get(k)) != v}
        need(not bad, f"sharded {shape} kosarak@0.1: counters differ from "
                      f"the JAX DistributedMiner's (card, JAX): {bad}")

    with tempfile.TemporaryDirectory(dir=ROOT) as trace_dir:
        # -- (1,1) under NCCL, in this process.
        dist.init_process_group("nccl", init_method="tcp://localhost:"
                                f"{free_port()}", world_size=1, rank=0)
        try:
            mesh = make_mining_mesh(block=1, cls=1)
            got, cnt, wall, ln, run = _mine_counted(mesh, bdb, ms, dev)
            need(got == main["itemsets"], "sharded (1,1) kosarak@1.0: "
                                          "itemsets differ from phase 4's")
            need(cnt == want_es, "sharded (1,1) kosarak@1.0 ES on: counters "
                                 "differ from phase 4's BitmapMiner: "
                 f"{ {k: (cnt[k], want_es[k]) for k in cnt if cnt[k] != want_es.get(k)} }")
            for name in ("bitmap_intersect_es", "compact_gather"):
                need(ln[name] > 0, f"sharded (1,1): {name} launched no time")
            launches = dict(ln)
            warm = _warm_wall(run)
            busy = _busy(run, Path(trace_dir))
            got_no, cnt_no, wall_no, _, _ = _mine_counted(mesh, bdb, ms, dev,
                                                          es=False)
            need(got_no == got and cnt_no == want_full,
                 "sharded (1,1) kosarak@1.0 ES off: itemsets or counters "
                 "differ from phase 4's")
            got01, cnt01, _, _, _ = _mine_counted(mesh, bdb01, ms01, dev)
            check_01((1, 1), got01, cnt01)
            report["1x1"] = {"backend": "nccl", "wall_first_s": wall,
                             "wall_s": warm, "wall_es_off_s": wall_no,
                             "busy": busy, "launches": ln, **cnt}
            say(f"phase sharded (1,1) nccl: kosarak@1.0 F={len(got)} "
                f"word_ops {cnt['word_ops']} calls {cnt['device_calls']} "
                f"== phase 4 (ES on and off); @0.1 == JAX table; wall "
                f"{warm:.4f} s (first run {wall:.3f} s, ES off "
                f"{wall_no:.4f} s); profiled wall {busy['wall_ms']:.3f} ms, "
                f"device busy {busy['device_busy_ms']:.3f} ms, idle share "
                f"{busy['idle_share']}; launches {ln}")
        finally:
            dist.destroy_process_group()

        # -- gloo worlds sharing the card.
        worlds = {
            2: [((1, 2), "kosarak@1.0", bdb, ms, "eclat", True),
                ((2, 1), "kosarak@1.0", bdb, ms, "eclat", True),
                ((1, 2), "kosarak@0.1", bdb01, ms01, "eclat", False),
                ((2, 1), "kosarak@0.1", bdb01, ms01, "eclat", False),
                ((2, 1), "accidents@1.0", acc, acc_ms, "declat", True),
                ((2, 1), "accidents@1.0", acc, acc_ms, "adaptive", False)],
            4: [((2, 2), "kosarak@1.0", bdb, ms, "eclat", True),
                ((4, 1), "kosarak@1.0", bdb, ms, "eclat", True),
                ((2, 2), "kosarak@0.1", bdb01, ms01, "eclat", False),
                ((4, 1), "kosarak@0.1", bdb01, ms01, "eclat", False)]}
        for world, jobs in worlds.items():
            t0 = time.perf_counter()
            per_rank = run_ranks(_sharded_rank, world,
                                 (jobs, trace_dir, str(dev)),
                                 timeout_s=RANK_TIMEOUT_S, threads=0)
            say(f"phase sharded: gloo world of {world} on one card ran in "
                f"{time.perf_counter() - t0:.1f} s")
            for j, (shape, name, _, _, scheme, _) in enumerate(jobs):
                res = [r[j] for r in per_rank]
                got, cnt = res[0]["itemsets"], res[0]["counters"]
                for r in res[1:]:
                    need(r["itemsets"] == got and r["counters"] == cnt,
                         f"sharded {shape} {name} {scheme}: ranks disagree")
                key = f"{shape[0]}x{shape[1]} {name} {scheme}"
                if name == "kosarak@1.0":
                    need(got == main["itemsets"], f"sharded {key}: itemsets "
                                                  f"differ from phase 4's")
                    if shape == (1, 2):
                        need(cnt == want_es, f"sharded {key}: counters "
                                             f"differ from (1,1)'s")
                elif name == "kosarak@0.1":
                    check_01(shape, got, cnt)
                else:
                    need(got == declat["itemsets"], f"sharded {key}: "
                         f"itemsets differ from phase 5's")
                if scheme == "declat":
                    launches["bitmap_diff_es"] = res[0]["launches"][
                        "bitmap_diff_es"]
                first = max(r["wall_s"] for r in res)
                warm = (None if res[0]["warm_wall_s"] is None
                        else max(r["warm_wall_s"] for r in res))
                busy = res[0]["busy"]
                report[key] = {"backend": "gloo", "ranks": world,
                               "wall_first_s": first, "wall_s": warm,
                               "busy_rank0": busy,
                               "launches": [r["launches"] for r in res],
                               **cnt}
                say(f"phase sharded {key} gloo: F={len(got)} word_ops "
                    f"{cnt['word_ops']} screened {cnt['screened_out']} "
                    f"aborts {cnt['kernel_aborts']} calls "
                    f"{cnt['device_calls']}; first run {first:.3f} s (max "
                    f"over ranks)"
                    + ("" if busy is None else
                       f"; wall {warm:.4f} s (max over ranks); rank 0 "
                       f"profiled wall {busy['wall_ms']:.3f} ms, its device "
                       f"busy {busy['device_busy_ms']:.3f} ms, idle share "
                       f"{busy['idle_share']}")
                    + f"; launches {[r['launches'] for r in res]}")
    say(f"phase sharded: {smi_line}; one-card gloo numbers stage every "
        f"collective through the host and are no speed across cards")
    return {"launches": launches, "report": report}


def _trace_busy(path: Path):
    """Device busy ms of an exported profiler trace (the union of its
    kernel, memcpy and memset intervals), its device spans, and device
    (count, ms) by name."""
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
    return busy_us / 1e3, spans, by_name


def profile_path(name: str, run, trace_dir: Path) -> dict:
    """One more run of a path under ``torch.profiler`` (``--profile DIR``):
    device busy time (the union of kernel, memcpy and memset intervals in
    the exported trace) against the host wall clock, and device time by
    kernel.  The profiler's own host overhead inflates the wall, so the
    idle share reads high by that much."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace_dir.mkdir(parents=True, exist_ok=True)
    path = trace_dir / f"{name}_trace.json"
    prof.export_chrome_trace(str(path))
    busy_ms, spans, by_name = _trace_busy(path)
    with open(path, "rb") as raw, gzip.open(f"{path}.gz", "wb") as gz:
        shutil.copyfileobj(raw, gz)                # traces run to ~100 MB
    path.unlink()
    path = Path(f"{path}.gz")
    out = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": (1 - busy_ms / wall_ms) if spans else None,
           "by_name": {k: {"count": n, "ms": t}
                       for k, (n, t) in sorted(by_name.items(),
                                               key=lambda kv: -kv[1][1])},
           "trace": str(path)}
    say(f"profile {name}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({len(spans)} device events)")
    for k, v in list(out["by_name"].items())[:8]:
        say(f"  {v['ms']:.4f} ms  x{v['count']}  {k}")
    return out


def profile_all(dev, main, declat, prepost, serve, retrieval,
                trace_dir: Path) -> dict:
    """``--profile``: the main path, the dEclat path, the PrePost+ path,
    the serve path and the two retrieval shapes, each once more under the
    profiler; plus the main path's slab set-up alone."""
    from repro_torch.launch.serve import serve_greedy
    import torch
    from repro_torch.core.eclat import BitmapMiner
    from repro_torch.core.prepost import DevicePrePost
    from repro_torch.core.rowstore import DeviceRowStore

    bdb = main["bdb"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    DeviceRowStore(bdb.bitmaps, capacity=bdb.n_items + 4096, device=dev)
    torch.cuda.synchronize()
    store_ms = (time.perf_counter() - t0) * 1e3
    say(f"profile: main path slab set-up alone {store_ms:.3f} ms")
    declat_miner = BitmapMiner(scheme="declat", inflight=2,
                               autotune_chunk=True, device=dev)
    return {
        "store_setup_ms": store_ms,
        "main_path": profile_path(
            "main_path", lambda: _miner(dev).mine_packed(bdb, main["minsup"]),
            trace_dir),
        "declat_path": profile_path(
            "declat_path",
            lambda: declat_miner.mine_packed(declat["bdb"], declat["minsup"]),
            trace_dir),
        "prepost_path": profile_path(
            "prepost_path",
            lambda: DevicePrePost(device=dev).mine_tree(prepost["tree"],
                                                        prepost["minsup"]),
            trace_dir),
        "serve_path": profile_path(
            "serve_path",
            lambda: serve_greedy(serve["cfg"], serve["prompts"], SERVE_NEW,
                                 model=serve["model"], device=dev,
                                 log_fn=_quiet), trace_dir),
        "retrieval_path": profile_path("retrieval_path", retrieval["run"],
                                       trace_dir),
        "serve_p99_path": profile_path("serve_p99_path",
                                       retrieval["embed99"], trace_dir)}


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


def _bound(nbytes: float, ops: float, peak_ops: float = PEAK_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# The widths each ES kernel is timed at: the paper packing (128 words a
# block), the CLI's default (8) and the adaptive smoke knob (1).
ES_WIDTHS = (128, 8, 1)


def _es_dispatch(dev, time_ms, bdb, ms, *, diff: bool, iters: int) -> dict:
    """A mining path's first ES dispatch (every level-1 pair, tidset
    operands) on a fresh slab: held against its plain version on a copy
    of the same slab (counts, blocks, alive and both slabs, exactly),
    then timed beside its bound and its plain version.  ``diff`` picks
    the dEclat difference (``screen_and_diff``), else the Eclat scan."""
    from repro_torch.core.rowstore import DeviceRowStore
    from repro_torch.kernels import ops

    name = "bitmap_diff_es" if diff else "bitmap_intersect_es"
    fused = ops.screen_and_diff if diff else ops.screen_and_intersect
    nb, bw = bdb.n_blocks, bdb.block_words
    store = DeviceRowStore(bdb.bitmaps, capacity=bdb.n_items + 4096,
                           device=dev)
    ia, ib = np.triu_indices(bdb.n_items, 1)
    P = int(ia.size)
    slots = store.alloc(P)
    _, (ua, vb, sl, rho) = ops.upload_columns(dev, [
        ia.astype(np.int32), ib.astype(np.int32), slots,
        bdb.supports[ia].astype(np.int32)])

    def run(backend="auto"):
        return fused(store.rows, store.suffix, ua, vb, sl, rho, ms,
                     backend=backend)

    rows_p, suffix_p = store.rows.clone(), store.suffix.clone()
    _, _, cnt, blocks, alive = run()
    got = (cnt, blocks, alive, store.rows, store.suffix)
    want = fused(rows_p, suffix_p, ua, vb, sl, rho, ms, backend="plain")
    err = max(_max_err(g, w) for g, w in
              zip(got, (*want[2:], *want[:2]), strict=True))
    need(err == 0, f"{name}: first dispatch at {P} pairs x {nb} blocks x "
                   f"{bw} words disagrees with its plain version (max abs "
                   f"err {err})")
    del rows_p, suffix_p, want
    blocks_np = blocks.cpu().numpy().astype(np.int64)
    sup = rho - cnt if diff else cnt
    n_surv = int((alive & (sup >= ms)).sum().item())
    # Each input byte once: an operand row is needed up to the furthest
    # block any of its pairs scanned (rows are shared by many pairs).
    row_blocks = np.zeros(store.capacity, np.int64)
    np.maximum.at(row_blocks, ia, blocks_np)
    np.maximum.at(row_blocks, ib, blocks_np)
    if diff:
        nbytes = (int(row_blocks.sum()) * bw * 4          # operand words
                  + len(np.unique(ia)) * (nb + 1) * 4)    # U suffix tables
    else:
        nbytes = int(row_blocks.sum()) * (bw + 1) * 4     # row + suffix
    nbytes += (n_surv * (nb * bw + nb + 1) * 4            # child rows
               + P * 4 * 4 + P * 9)                       # columns, outputs
    blocks_sum = int(blocks_np.sum())
    n_ops = 3 * blocks_sum * bw                    # and(n), popc, add
    stream = 2 * blocks_sum * (bw + 1) * 4         # bytes the walk streams
    bound, by = _bound(nbytes, n_ops)
    # Words a pair loads past its abort: the rest of the abort's step (a
    # step is 512 words for each warp the pair gets); the work counter
    # does not see them.  Scan only: diff does not load zero-mass blocks.
    # (A library built from a tree before the stepped scan has no
    # repro_scan_warps: the paired runs time such a tree too.)
    from repro_torch.kernels import _build
    lib = _build.load()
    warps = (int(lib.repro_scan_warps(P, nb, bw))
             if hasattr(lib, "repro_scan_warps") else None)
    over_words = 0
    if not diff and warps:
        step = warps * 512
        dead = ~alive.cpu().numpy()
        end_word = blocks_np[dead] * bw               # words through the abort
        loaded = np.minimum(-(-end_word // step) * step, nb * bw)
        over_words = int((loaded - end_word).sum())
    ms_k = time_ms(run, iters)
    ms_p = time_ms(lambda: run("plain"), 3)
    del store
    say(f"timing {name} (fused, {P} pairs x {nb} blocks x {bw} words, "
        f"blocks_done {blocks_sum}, {n_surv} survivors, equal to plain): "
        f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms, bound {bound:.4f} ms "
        f"({by}: {nbytes} B, {n_ops} ops); streams {stream} B = "
        f"{stream / (ms_k * 1e-3) / 1e9:.1f} GB/s; {warps} warp(s) a pair"
        + ("" if diff or not warps else f", {2 * 4 * over_words} B of "
                                          f"operand words read past the "
                                          f"aborts"))
    return {"ms": ms_k, "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "max_abs_err": err, "pairs": P,
            "n_blocks": nb, "block_words": bw, "blocks_done": blocks_sum,
            "survivors": n_surv, "bytes": nbytes, "ops": n_ops,
            "streamed_bytes": stream, "warps_per_pair": warps,
            "bytes_past_abort": (2 * 4 * over_words if warps and not diff
                                 else None)}


def _es_widths(dev, time_ms, name, bdb, ms, *, diff: bool, dataset: str):
    """``_es_dispatch`` at every width of ``ES_WIDTHS``: ``bdb`` is the
    path's own packing (128 words a block); the other widths repack the
    same seeded stream as the miner packs it (``stream_paper_dataset``
    with ``block_words``).  Returns the 128-word entry under ``name``
    (its ``max_abs_err`` the largest over the widths) and each other
    width under ``name_bw<w>``."""
    from repro_torch.data.transactions import stream_paper_dataset
    out = {}
    for bw in ES_WIDTHS:
        db = bdb if bw == bdb.block_words else stream_paper_dataset(
            dataset, scale=1.0, seed=0, block_words=bw)[0]
        key = name if bw == bdb.block_words else f"{name}_bw{bw}"
        out[key] = _es_dispatch(dev, time_ms, db, ms, diff=diff,
                                iters=20 if bw == bdb.block_words else 5)
    out[name]["max_abs_err"] = max(t["max_abs_err"] for t in out.values())
    return out


def phase_timing(dev, main) -> dict:
    import torch
    from repro_torch.kernels import ops

    time_ms = _timer(dev)
    out = _es_widths(dev, time_ms, "bitmap_intersect_es", main["bdb"],
                     main["minsup"], diff=False, dataset="kosarak-paper")
    out["bitmap_intersect_es_thr"] = _thr_scan(dev, time_ms, main["bdb"],
                                               main["minsup"])

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
        **out,
        "compact_gather": {
            "ms": comp_ms, "plain_ms": comp_plain_ms, "bound_ms": comp_bound,
            "bound_by": comp_by, "library_ms": comp_lib_ms,
            "max_abs_err": 0,
            "rows_in": cap, "rows_out": int(perm_np.size),
            "live": n_valid, "bytes": comp_bytes}}


def _thr_scan(dev, time_ms, bdb, ms) -> dict:
    """The sharded dispatch's first scan at the (1,1) shape: every
    level-1 pair, the per-pair threshold ``minsup - 0`` (one block shard,
    no slack), every slot at capacity (no child: the sharded dispatch
    writes survivors in its second launch).  Held against its plain
    version, then timed beside its bound and the plain version."""
    import torch
    from repro_torch.core.rowstore import DeviceRowStore
    from repro_torch.kernels import bitmap_intersect as kbi
    from repro_torch.kernels import ops

    nb, bw = bdb.n_blocks, bdb.block_words
    store = DeviceRowStore(bdb.bitmaps, capacity=bdb.n_items + 4096,
                           device=dev)
    ia, ib = np.triu_indices(bdb.n_items, 1)
    P = int(ia.size)
    _, (ua, vb, nowhere, rho) = ops.upload_columns(dev, [
        ia.astype(np.int32), ib.astype(np.int32),
        np.full(P, store.capacity, np.int32),
        bdb.supports[ia].astype(np.int32)])
    thr = torch.full((P,), ms, dtype=torch.int32, device=dev)

    def run():
        return kbi.screen_and_intersect(store.rows, store.suffix, ua, vb,
                                        nowhere, rho, ms, 0, thr=thr)

    def plain():
        return _plain_fused_thr(store.rows, store.suffix, ua, vb, nowhere,
                                rho, ms, thr, diff=False)
    got, want = run(), plain()
    err = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
    need(err == 0, f"per-pair-threshold scan at {P} pairs x {nb} blocks "
                   f"disagrees with its plain version (max abs err {err})")
    blocks_np = got[1].cpu().numpy().astype(np.int64)
    row_blocks = np.zeros(store.capacity, np.int64)
    np.maximum.at(row_blocks, ia, blocks_np)
    np.maximum.at(row_blocks, ib, blocks_np)
    nbytes = (int(row_blocks.sum()) * (bw + 1) * 4     # row + suffix words
              + P * 5 * 4 + P * 9)                    # columns, thr, outputs
    blocks_sum = int(blocks_np.sum())
    n_ops = 3 * blocks_sum * bw
    bound, by = _bound(nbytes, n_ops)
    ms_k = time_ms(run, 20)
    ms_p = time_ms(plain, 3)
    say(f"timing bitmap_intersect_es with a per-pair threshold (the (1,1) "
        f"sharded first scan, {P} pairs x {nb} blocks x {bw} words, "
        f"blocks_done {blocks_sum}, equal to plain): kernel {ms_k:.4f} ms, "
        f"plain {ms_p:.4f} ms, bound {bound:.4f} ms ({by}: {nbytes} B, "
        f"{n_ops} ops)")
    return {"ms": ms_k, "plain_ms": ms_p, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "max_abs_err": err, "pairs": P,
            "blocks_done": blocks_sum, "bytes": nbytes, "ops": n_ops}


def phase_checked(dev) -> dict:
    """The checked build (``_build.checked()``: device asserts on every
    global index and window bound of the ES scan, the dEclat difference
    and the N-list kernels, and on the tensor-core attention's mbarrier
    ring and TMA boxes) runs phase 1's flash sweep, each output equal to
    the normal build's bit for bit and within its tolerance of the plain
    version, and phase 1's ES and N-list sweeps, bit for bit against the
    plain versions; then the N-list sweeps once more with the merge's adv
    mask in the packed form ``desc || x.pre <= y.pre`` (the same
    predicate as the committed one), whose reading is printed.  A failed
    assert traps its launch and fails the run."""
    import torch
    from repro_torch.kernels import _build

    rng = np.random.default_rng(20261016)

    def rows(n, nb, bw, density):
        u = rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        for _ in range(density):
            u &= rng.integers(0, 2 ** 32, (n, nb, bw), dtype=np.uint64)
        return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(dev)

    checks, packed = {}, {"checks": 0, "max_abs_err": 0, "failures": []}

    def agree(name, got, want, what):
        e = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
        checks[name] = checks.get(name, 0) + 1
        need(e == 0, f"checked build: {name} disagrees with its plain "
                     f"version: {what} (max abs err {e})")

    def record(name, got, want, what):
        e = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
        packed["checks"] += 1
        packed["max_abs_err"] = max(packed["max_abs_err"], e)
        if e:
            packed["failures"].append(f"{name}: {what} (max abs err {e})")

    # The flash sweep's outputs from the normal build, to hold the checked
    # build's against bit for bit.
    flash_normal = _flash_sweep(dev)
    t0 = time.perf_counter()
    with _build.checked() as lib:
        flash_checked = _flash_sweep(dev)
        torch.cuda.synchronize()
        for case, (got, plain), (want, _) in zip(_flash_cases(),
                                                 flash_checked, flash_normal,
                                                 strict=True):
            tol = case[-1]
            checks["flash_attention"] = checks.get("flash_attention", 0) + 1
            need(torch.equal(got, want), f"checked build: flash_attention "
                 f"differs from the normal build at {case}")
            e = (got.float() - plain.float()).abs().max().item() \
                if got.numel() else 0.0
            need(e < tol, f"checked build: flash_attention vs plain {e} at "
                          f"{case}")
        _check_scan(dev, rows, rng, agree)
        _check_thr(dev, agree)
        _check_diff(dev, rows, agree)
        _check_nlists(dev, rng, agree)
        _check_nlist_intersect(dev, rng, agree)
        torch.cuda.synchronize()
        say(f"phase checked: no device assert fired, every output equal to "
            f"the plain versions — {checks} comparisons "
            f"({time.perf_counter() - t0:.1f} s)")
        lib.repro_nlist_set_packed_adv(1)
        try:
            _check_nlists(dev, rng, record)
            _check_nlist_intersect(dev, rng, record)
            torch.cuda.synchronize()
        except SmokeFailure as e:      # the reading, not a kernel of the port
            packed["failures"].append(str(e))
        finally:
            lib.repro_nlist_set_packed_adv(0)
    say(f"phase checked: packed adv form (desc || x.pre <= y.pre) reading: "
        f"{packed['checks']} comparisons with the plain version, max abs err "
        f"{packed['max_abs_err']}, disagreements "
        f"{packed['failures'] or 'none'}")
    return {"checks": checks, "packed_adv": packed,
            "build_s": _build.checked_build_seconds}


def phase_timing_slice2(dev, declat, prepost) -> dict:
    """The dEclat and PrePost+ kernels at their paths' real shapes: each
    path's first dispatch, held against its plain version on the same
    fresh state, then timed beside its bound and its plain version.  No
    single PyTorch call computes a blocked early-stopping AND-NOT with a
    survivor scatter, a two-pointer ancestor merge, or the Z-merge of a
    match table, so there is no library time for these three."""
    import torch
    from repro_torch.core.bitmap import (NL_SENTINEL, nl_pad_len,
                                         nl_pad_len_np)
    from repro_torch.core.rowstore import NListPool
    from repro_torch.kernels import ops

    time_ms = _timer(dev)
    out = {}

    # -- bitmap_diff_es: the declat path's first dispatch (every level-1
    # pair, tidset operands -> level-2 diffsets) on a fresh slab, at each
    # width.
    out.update(_es_widths(dev, time_ms, "bitmap_diff_es", declat["bdb"],
                          declat["minsup"], diff=True,
                          dataset="accidents-paper"))

    # -- nlist_merge: the PrePost+ path's first pre-pass (every level-1
    # pair in one chunk, sorted by length bucket as the engine sorts).
    tree, ms = prepost["tree"], prepost["minsup"]
    order = list(reversed(tree.order_desc))
    arrays = [np.asarray(tree.nlists[it], np.int32).reshape(-1, 3)
              for it in order]
    lens = np.array([len(a) for a in arrays], np.int32)
    sups = np.array([tree.item_support[it] for it in order], np.int32)
    pool = NListPool(capacity=max(64, 2 * sum(nl_pad_len(max(n, 1))
                                              for n in lens)), device=dev)
    prow = pool.alloc_rows(lens)
    pool.write_rows(prow, arrays)
    ia, ib = np.triu_indices(len(order), 1)
    key = np.argsort(nl_pad_len_np(np.maximum(lens[ia], lens[ib])),
                     kind="stable")
    ia, ib = ia[key], ib[key]
    P = int(ia.size)
    u_len, v_len = lens[ia], lens[ib]
    lu, lv = nl_pad_len(int(u_len.max())), nl_pad_len(int(v_len.max()))
    _, cols = ops.upload_columns(dev, [
        pool.offsets(prow[ia]), u_len, pool.offsets(prow[ib]), v_len,
        sups[ib]])

    def merge(backend="auto"):
        return ops.nlist_presize(pool.codes, *cols, ms, lu=lu, lv=lv,
                                 backend=backend)

    got = merge()
    want = merge("plain")
    merge_err = max(_max_err(g, w) for g, w in zip(got, want, strict=True))
    need(merge_err == 0, f"first N-list pre-pass at {P} pairs (lu {lu}) "
                         f"disagrees with its plain version (max abs err "
                         f"{merge_err})")
    del want
    out_slot, child_len, support = got[0], got[1], got[2]
    cmps_total = int(got[3].sum().item())
    # The longest walk is the kernel's floor: a chain of dependent steps.
    cmps_longest = int(got[3].max().item())
    merge_bytes = (12 * int(lens.sum())                   # every N-list once
                   + P * lu * 4                           # match table
                   + P * 5 * 4 + P * 5 * 4 + P)           # columns, outputs
    merge_ops = 8 * cmps_total        # 2 compares, select, 2 adds, ES guard
    merge_bound, merge_by = _bound(merge_bytes, merge_ops)
    merge_ms = time_ms(merge, 20)
    merge_plain_ms = time_ms(lambda: merge("plain"), 1)
    ns_per_cmp = merge_ms * 1e6 / max(cmps_longest, 1)
    say(f"timing nlist_merge (presize, {P} pairs, lu {lu}, "
        f"{cmps_total} comparisons, equal to plain): kernel "
        f"{merge_ms:.4f} ms, plain {merge_plain_ms:.4f} ms, bound "
        f"{merge_bound:.4f} ms ({merge_by}: {merge_bytes} B, {merge_ops} "
        f"ops); longest pair {cmps_longest} comparisons, kernel "
        f"{ns_per_cmp:.2f} ns per comparison of it")
    out["nlist_merge"] = {
        "ms": merge_ms, "plain_ms": merge_plain_ms, "bound_ms": merge_bound,
        "bound_by": merge_by, "library_ms": None, "max_abs_err": merge_err,
        "pairs": P, "lu": lu, "comparisons": cmps_total,
        "longest_pair_comparisons": cmps_longest,
        "ns_per_longest_comparison": ns_per_cmp,
        "bytes": merge_bytes, "ops": merge_ops}

    # -- zmerge_scatter: that pre-pass's scatter into tight survivor
    # extents, as the engine allocates them.
    sup_np, cl_np = support.cpu().numpy(), child_len.cpu().numpy()
    kept = np.flatnonzero(sup_np >= ms)
    child_rows = pool.alloc_rows(cl_np[kept])
    out_off = np.full(P, pool.capacity, np.int32)
    out_off[kept] = pool.offsets(child_rows)
    _, scols = ops.upload_columns(dev, [
        pool.offsets(prow[ia]), u_len, pool.offsets(prow[ib]), v_len,
        out_off])
    ck, cp = pool.codes.clone(), pool.codes.clone()
    a = ops.nlist_scatter(ck, out_slot, *scols, lu=lu, lv=lv)
    b = ops.nlist_scatter(cp, out_slot, *scols, lu=lu, lv=lv,
                          backend="plain")
    scat_err = max(_max_err(g, w) for g, w in zip(a, b, strict=True))
    need(scat_err == 0, f"N-list scatter at {P} pairs disagrees with its "
                        f"plain version (max abs err {scat_err})")
    del ck, cp
    n_matched = int((out_slot != NL_SENTINEL).sum().item())
    n_child = int(cl_np[kept].sum())
    scat_bytes = (P * lu * 4 + 4 * n_matched + 8 * n_child + 12 * n_child
                  + P * 6 * 4)
    scat_ops = 3 * P * lu
    scat_bound, scat_by = _bound(scat_bytes, scat_ops)

    def scatter(backend="auto"):
        return ops.nlist_scatter(pool.codes, out_slot, *scols, lu=lu, lv=lv,
                                 backend=backend)

    scat_ms = time_ms(scatter, 20)
    scat_plain_ms = time_ms(lambda: scatter("plain"), 3)
    say(f"timing zmerge_scatter ({P} pairs, lu {lu}, {len(kept)} survivors "
        f"with {n_child} codes, equal to plain): kernel {scat_ms:.4f} ms, "
        f"plain {scat_plain_ms:.4f} ms, bound {scat_bound:.4f} ms "
        f"({scat_by}: {scat_bytes} B)")
    out["zmerge_scatter"] = {
        "ms": scat_ms, "plain_ms": scat_plain_ms, "bound_ms": scat_bound,
        "bound_by": scat_by, "library_ms": None, "max_abs_err": scat_err,
        "pairs": P, "survivors": int(len(kept)), "child_codes": n_child,
        "bytes": scat_bytes, "ops": scat_ops}
    return out


def phase_timing_slice3(dev, serve, retrieval, seed) -> dict:
    """flash_attention at the serve path's prefill shape (layer 0's own
    q, k, v: B 8, S 2048, H 16, D 64, bf16), beside
    ``F.scaled_dot_product_attention(is_causal=True)``, which the port
    never calls; embedding_bag on the 2,000,000 x 256 item table at
    serve_p99 (512 bags) and serve_bulk (262,144 bags) of 50 Zipf slots,
    beside ``F.embedding_bag(mode="sum", per_sample_weights=mask)``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data.recsys_data import twotower_batch
    from repro_torch.kernels import ops

    time_ms = _timer(dev)
    out = {}
    q, k, v = serve["qkv"]
    B, S, H, D = q.shape
    KH, Dv = v.shape[2], v.shape[3]
    fa_ms = time_ms(lambda: ops.flash_attention(q, k, v), 10)
    fa_plain_ms = time_ms(
        lambda: ops.flash_attention(q, k, v, backend="plain"), 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    fa_lib_ms = time_ms(sdpa, 10)
    lib_err = (sdpa().transpose(1, 2).float()
               - ops.flash_attention(q, k, v).float()).abs().max().item()
    need(lib_err < 3e-2, f"flash_attention disagrees with SDPA ({lib_err})")
    fa_bytes = (q.numel() + k.numel() + v.numel() + B * S * H * Dv) * 2
    pairs = S * (S + 1) // 2                   # causal (query, key) pairs
    fa_flops = 2 * B * H * pairs * (D + Dv)    # q.k and p.v
    fa_bound, fa_by = _bound(fa_bytes, fa_flops, PEAK_BF16_FLOPS)
    fa_tflops = fa_flops / (fa_ms * 1e-3) / 1e12
    say(f"timing flash_attention (B {B} S {S} H {H} KH {KH} D {D} "
        f"{q.dtype}, causal): kernel {fa_ms:.4f} ms ({fa_tflops:.1f} "
        f"TFLOP/s), plain {fa_plain_ms:.4f} ms, "
        f"library (SDPA) {fa_lib_ms:.4f} ms, kernel / library "
        f"{fa_ms / fa_lib_ms:.3f}, bound {fa_bound:.4f} ms "
        f"({fa_by}: {fa_bytes} B, {fa_flops} flops); kernel vs SDPA "
        f"{lib_err}")
    out["flash_attention"] = {
        "ms": fa_ms, "plain_ms": fa_plain_ms, "bound_ms": fa_bound,
        "bound_by": fa_by, "library_ms": fa_lib_ms,
        "kernel_over_library": fa_ms / fa_lib_ms, "tflops": fa_tflops,
        "max_abs_err": serve["report"]["layer0_attn_err"],
        "shape": [B, S, H, KH, D, Dv], "bytes": fa_bytes, "ops": fa_flops,
        "vs_library_err": lib_err}

    cfg = retrieval["cfg"]
    table = retrieval["model"].item_emb.table
    V, D = table.shape
    bags = {}
    for n in (512, 262_144):
        b = twotower_batch(seed + 2, n, cfg.n_users, cfg.n_items,
                           cfg.n_user_hist)
        ids = torch.from_numpy(b["hist_ids"]).to(dev)
        mask = torch.from_numpy(b["hist_mask"]).to(dev)
        L = ids.shape[1]
        got = ops.embedding_bag(table, ids, mask)
        want = ops.embedding_bag(table, ids, mask, backend="plain")
        err = (got - want).abs().max().item()
        need(torch.equal(got, want), f"embedding_bag at {n} bags is not "
                                     f"bit-equal to its plain version ({err})")
        ids64, w = ids.long(), mask.to(torch.float32)

        def library():
            return F.embedding_bag(ids64, table, mode="sum",
                                   per_sample_weights=w)

        lib_err = (library() - ops.embedding_bag(table, ids, mask,
                                                 combiner="sum")
                   ).abs().max().item()
        need(lib_err < 1e-4, f"embedding_bag sum vs F.embedding_bag "
                             f"({lib_err})")
        n_valid = int(mask.sum().item())
        n_rows = int(torch.unique(ids[mask]).numel())
        nbytes = n * L * (4 + 1) + n_rows * D * 4 + n * D * 4
        bound, by = _bound(nbytes, n_valid * D + n * D)
        ms = time_ms(lambda: ops.embedding_bag(table, ids, mask), 20)
        plain_ms = time_ms(lambda: ops.embedding_bag(table, ids, mask,
                                                     backend="plain"),
                           3 if n <= 512 else 1)
        lib_ms = time_ms(library, 20)
        gbs = nbytes / (ms * 1e-3) / 1e9
        say(f"timing embedding_bag ({n} bags x {L} slots, {n_valid} valid, "
            f"{n_rows} distinct rows of {V} x {D}, mean): kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, kernel "
            f"/ library {ms / lib_ms:.3f}, bound {bound:.4f} ms ({by}: "
            f"{nbytes} B, {gbs:.1f} GB/s of them); streams "
            f"{n_valid * D * 4 / (ms * 1e-3) / 1e9:.1f} GB/s of rows")
        bags[n] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": by, "library_ms": lib_ms, "max_abs_err": err,
                   "kernel_over_library": ms / lib_ms, "gb_per_s": gbs,
                   "bags": n, "slots": L, "valid": n_valid,
                   "distinct_rows": n_rows, "bytes": nbytes,
                   "vs_library_err": lib_err}
    # The kernels line carries the serve_p99 shape, the user tower's.
    out["embedding_bag"] = dict(bags[512], serve_bulk=bags[262_144])
    return out


# ---------------------------------------------------------------------------

# name, source, the TPU kernel (or jnp function) it replaces, the path
# whose run supplies its launch count
KERNELS = (
    ("bitmap_intersect_es", "src/repro_torch/csrc/bitmap_intersect.cu",
     "src/repro/kernels/bitmap_intersect.py:113", "main"),
    ("compact_gather", "src/repro_torch/csrc/compact.cu",
     "src/repro/kernels/compact.py:44", "main"),
    ("bitmap_diff_es", "src/repro_torch/csrc/bitmap_diff.cu",
     "src/repro/kernels/bitmap_diff.py:90", "declat"),
    ("nlist_merge", "src/repro_torch/csrc/nlist_merge.cu",
     "src/repro/kernels/nlist_merge.py:100", "prepost"),
    ("zmerge_scatter", "src/repro_torch/csrc/nlist_merge.cu",
     "src/repro/kernels/ref.py:697", "prepost"),
    ("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
     "src/repro/kernels/flash_attention.py:91", "serve"),
    ("embedding_bag", "src/repro_torch/csrc/segment_embed.cu",
     "src/repro/kernels/segment_embed.py:53", "retrieval"),
)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default="",
                    help="write every measured number to this JSON file")
    ap.add_argument("--profile", default="", metavar="DIR",
                    help="also profile one run of each real-size path "
                         "and write the traces into DIR")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the serving phases' weights, prompts "
                         "and bags")
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
    # The plain versions and the fp32 model run in full fp32 (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    from repro_torch.kernels.bitmap_diff import bitmap_diff_es
    from repro_torch.kernels.bitmap_intersect import bitmap_intersect_es
    from repro_torch.kernels.compact import compact_gather
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.nlist_merge import nlist_merge, zmerge_scatter
    from repro_torch.kernels.segment_embed import embedding_bag
    counters = (bitmap_intersect_es, compact_gather, bitmap_diff_es,
                nlist_merge, zmerge_scatter, flash_attention, embedding_bag)
    # Both builds before any rank is spawned: the checked library builds
    # beside the plain one (one nvcc per source, all started together).
    t0 = time.perf_counter()
    checked_build = {}

    def build_checked():
        try:
            _build.load(checked=True)
        except BaseException as e:                      # noqa: BLE001
            checked_build["error"] = e
    checked_thread = threading.Thread(target=build_checked)
    checked_thread.start()
    _build.load()
    checked_thread.join()
    if "error" in checked_build:
        raise checked_build["error"]
    say(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s; checked build "
        f"{_build.checked_build_seconds:.2f} s)")

    rng = np.random.default_rng(20261016)
    report = {"card": smi_line, "torch": torch.__version__,
              "build_s": _build.build_seconds, "phase_s": {}}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        res = fn(*a)
        report["phase_s"][name] = time.perf_counter() - t0
        return res

    t_start = time.perf_counter()
    report["kernels"] = timed("kernels", phase_kernels, dev, rng)
    report["smoke"] = timed("smoke", phase_smoke, dev)
    report["full"] = timed("full", phase_full, dev)
    paths = {"main": timed("main", phase_main, dev, counters)}
    paths["declat"] = timed("declat", phase_declat, dev, counters)
    paths["prepost"] = timed("prepost", phase_prepost, dev, counters,
                             paths["main"])
    paths["serve"] = timed("serve", phase_serve, dev, counters, args.seed)
    paths["retrieval"] = timed("retrieval", phase_retrieval, dev, counters,
                               args.seed)
    paths["sharded"] = timed("sharded", phase_sharded, dev, paths["main"],
                             paths["declat"], smi_line)
    for name, res in paths.items():
        report[name] = res["report"]
    if args.profile:
        report["profile"] = timed("profile", profile_all, dev, paths["main"],
                                  paths["declat"], paths["prepost"],
                                  paths["serve"], paths["retrieval"],
                                  Path(args.profile))
    report["timing"] = timed("timing", phase_timing, dev, paths["main"])
    report["timing"].update(timed("timing_slice2", phase_timing_slice2, dev,
                                  paths["declat"], paths["prepost"]))
    report["timing"].update(timed("timing_slice3", phase_timing_slice3, dev,
                                  paths["serve"], paths["retrieval"],
                                  args.seed))
    # The serving models are done with: free the card for training.
    for name, keys in (("serve", ("model", "qkv")),
                       ("retrieval", ("model", "run", "embed99"))):
        for k in keys:
            paths[name].pop(k)
    torch.cuda.empty_cache()
    paths["train"] = timed("train", phase_train, dev, counters, args.seed,
                           smi_line,
                           Path(args.profile) if args.profile else None)
    report["train"] = paths["train"]["report"]
    torch.cuda.empty_cache()
    paths["serve_moe"] = timed("serve_moe", phase_serve_moe, dev, counters,
                               args.seed,
                               Path(args.profile) if args.profile else None)
    report["serve_moe"] = paths["serve_moe"]["report"]
    if args.profile:
        report.setdefault("profile", {}).update(
            {f"serve_{k}": v for k, v in
             paths["serve_moe"]["profile"].items()})
    report["timing"]["flash_attention_moe"] = timed(
        "timing_moe", phase_timing_moe, dev, paths["serve_moe"])
    paths["serve_moe"].pop("qkv")
    torch.cuda.empty_cache()
    trace_dir = Path(args.profile) if args.profile else None
    report["train_moe"] = timed("train_moe", phase_train_moe, dev, counters,
                                args.seed, smi_line, trace_dir)["report"]
    torch.cuda.empty_cache()
    report["recsys_models"] = timed("recsys_models", phase_recsys_models,
                                    dev, counters, args.seed, smi_line,
                                    trace_dir)["report"]
    torch.cuda.empty_cache()
    report["gnn"] = timed("gnn", phase_gnn, dev, counters, args.seed,
                          smi_line, trace_dir)["report"]
    torch.cuda.empty_cache()
    # Last: a failed device assert leaves the context unusable.
    report["checked"] = timed("checked", phase_checked, dev)
    torch.cuda.synchronize()
    report["phases_s"] = time.perf_counter() - t_start
    say(f"phases took {report['phases_s']:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in report["phase_s"].items()))
    kernels = []
    sharded = paths["sharded"]["launches"]
    thr = report["timing"]["bitmap_intersect_es_thr"]
    for name, source, replaces, path in KERNELS:
        t = report["timing"][name]
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": paths[path]["launches"][name],
            "max_abs_err": max(report["kernels"]["max_abs_err"][name],
                               t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}
        if name in sharded:     # the sharded path's own run, counted apart
            row["launches_sharded"] = sharded[name]
        if name == "embedding_bag":     # a two-tower train step, apart
            row["launches_train_step"] = paths["train"]["launches"][name]
        if name == "flash_attention":   # the MoE cells' prefills, apart
            moe_t = report["timing"]["flash_attention_moe"]
            for arch, n in paths["serve_moe"]["launches"].items():
                row[f"launches_{arch}"] = n[name]
            row["moe_shapes"] = {
                arch: {k: t[k] for k in ("shape", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms", "max_abs_err")}
                for arch, t in moe_t.items()}
            row["max_abs_err"] = max([row["max_abs_err"]] + [
                t["max_abs_err"] for t in moe_t.values()])
        if name == "bitmap_intersect_es":
            row["thr_ms"] = thr["ms"]
            row["thr_plain_ms"] = thr["plain_ms"]
            row["thr_bound_ms"] = thr["bound_ms"]
            row["max_abs_err"] = max(row["max_abs_err"], thr["max_abs_err"])
        kernels.append(row)
    report["kernel_line"] = kernels
    if args.report:
        Path(args.report).parent.mkdir(parents=True, exist_ok=True)
        Path(args.report).write_text(json.dumps(report, indent=1,
                                                default=str))
    say(smi_line)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
