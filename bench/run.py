"""Benchmark of the PyTorch + CUDA miner (``repro_torch``): one cell, one run.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``bench/configs/<config>.json``: the database generator
and the miner's settings) under a traffic mix
(``bench/traffic/<traffic>.json``: the minsups of the jobs).  One run:

1. draws the transactions from ``--seed`` (``bench/gen.py``) and packs
   them with the program's own ``BitmapDB.from_db`` at the mix's
   smallest minsup, cut to each larger minsup of the mix;
2. runs one warm-up job at each minsup of the mix (set-up ends here);
3. runs mining jobs back to back for ``--seconds``: one client, each
   job a ``BitmapMiner.mine_packed`` call ended by a device synchronise,
   minsups in the mix's order, round and round;
4. once the window has closed, checks the itemset -> support maps of a
   sample of the jobs drawn from the seed (``CHECKED_JOBS``) against the
   plain NumPy miner (``bench/reference/``);
5. prints the cell's end-to-end metrics (``--trace 0``) or, with the
   window under ``torch.profiler``, its per-layer metrics (``--trace
   1``), each read by ``bench/metrics/<metric>.py``, as one JSON line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pickle  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
# Import the benchmark as the package ``bench`` and the program from the
# checkout's ``src``; never the script's own directory as a top level.
if sys.path and Path(sys.path[0]).resolve() == BENCH:
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))

import numpy as np  # noqa: E402

from bench import byname, gen  # noqa: E402
from bench.reference import eclat as reference  # noqa: E402

# Top-level modules that may not be loaded in the measuring process.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# Jobs whose maps are kept for the check: a sample drawn from the seed,
# each kept pickled through the window.  Keeping maps as live objects
# would grow the heap that the program's garbage collections walk, and
# slow later jobs with the harness's own state.
CHECKED_JOBS = 8


@dataclass
class Cell:
    """Everything one cell's run reads, found by name."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((root / conf["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


@dataclass
class Job:
    minsup: int
    wall_s: float
    stats: Dict[str, float]
    itemsets: Optional[Any] = None         # kept for the check, or not


def reader(metric: str) -> Callable[["Outcome"], Optional[float]]:
    """``bench/metrics/<metric>.py``'s ``read``."""
    return byname.load("metrics", metric).read


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def job_minsups(cell: Cell, n_trans: int) -> List[int]:
    """The mix's minsups as counts, in the order the jobs take them."""
    return [gen.absolute_minsup(r, n_trans)
            for r in cell.traffic["minsup_rel"]]


def _cut(bdb, minsup: int):
    """The packed database restricted to the items frequent at
    ``minsup`` (rows are in ascending support, so a suffix)."""
    from repro_torch.core.bitmap import BitmapDB
    keep = np.flatnonzero(bdb.supports >= minsup)
    return BitmapDB(items=[bdb.items[i] for i in keep],
                    bitmaps=bdb.bitmaps[keep], supports=bdb.supports[keep],
                    n_trans=bdb.n_trans, minsup=minsup,
                    block_words=bdb.block_words)


def compare(itemsets: Dict, want: Dict) -> int:
    """Itemsets missing, extra, or with another support."""
    if itemsets == want:
        return 0
    bad = sum(1 for k, v in want.items() if itemsets.get(k) != v)
    return bad + sum(1 for k in itemsets if k not in want)


@dataclass
class Outcome:
    """One run: the jobs, the check and the readings; what a metric
    reader reads."""

    jobs: List[Job]
    setup_s: float
    window_s: float
    peak_bytes: Optional[int]
    mismatched: int
    jobs_wrong: int
    trace: Any = None                      # devtrace.TraceSummary
    needed_bytes: Optional[List[int]] = None
    phases: Dict[str, float] = field(default_factory=dict)
    peaks: Dict[str, float] = field(default_factory=dict)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START) -> Outcome:
    """Set up, measure and check one run (``device="cpu"`` drives the
    program's plain path, for the tests; nothing is timed there)."""
    import torch
    from repro_torch.core.bitmap import BitmapDB
    from repro_torch.core.eclat import BitmapMiner

    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    conf = cell.config
    miner_kw = dict(conf["miner"])
    block_words = int(miner_kw["block_words"])

    phases = {"imports_s": time.perf_counter() - t_start}
    clock = time.perf_counter()

    def phase(name: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        phases[name] = now - clock
        clock = now

    tx = gen.generate(conf, seed)
    phase("draw_s")
    order = job_minsups(cell, tx.n_trans)
    lowest = min(order)
    bdb = BitmapDB.from_db(tx.as_lists(), lowest, block_words)
    rungs = {ms: (bdb if ms == lowest else _cut(bdb, ms))
             for ms in dict.fromkeys(order)}
    phase("pack_s")
    miner = BitmapMiner(device=device, **miner_kw)
    for ms, rung in rungs.items():
        miner.mine_packed(rung, ms)
    sync()
    phase("warmup_s")
    setup_s = time.perf_counter() - t_start

    jobs: List[Job] = []
    kept: List[Job] = []                   # reservoir of CHECKED_JOBS
    pick = np.random.default_rng([int(seed) % 2**64, 0xC4EC])
    prof = None
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    from torch.profiler import record_function
    t0 = time.perf_counter()
    with record_function("bench.window"):
        while True:
            ms = order[len(jobs) % len(order)]
            t = time.perf_counter()
            with record_function("bench.job"):
                out, st = miner.mine_packed(rungs[ms], ms)
                sync()
            t1 = time.perf_counter()
            job = Job(ms, t1 - t, {
                "assemble_s": st.assemble_s,
                "device_calls": st.device_calls,
                "peak_device_words": st.peak_device_words,
                "candidates": st.candidates})
            slot = (len(jobs) if len(jobs) < CHECKED_JOBS
                    else int(pick.integers(0, len(jobs) + 1)))
            if slot < CHECKED_JOBS:
                job.itemsets = pickle.dumps(out, pickle.HIGHEST_PROTOCOL)
                if slot < len(kept):
                    kept[slot].itemsets = None
                    kept[slot] = job
                else:
                    kept.append(job)
            del out
            jobs.append(job)
            if t1 - t0 >= seconds:
                break
    window_s = time.perf_counter() - t0
    phase("window_s")
    summary = None
    if prof is not None:
        prof.stop()
        from bench import devtrace
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            if on_card:
                summary = devtrace.summarize(path)
        finally:
            os.remove(path)
        del prof
    peak = torch.cuda.max_memory_allocated() if on_card else None
    del miner, rungs, bdb
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    phase("trace_read_s")

    # The check, once the window has closed and the program's state is
    # freed: each sampled job against the reference's map at its minsup
    # (and, in a traced run, the words the scheme needs there).
    scheme = conf["miner"]["scheme"] if trace else None
    packed = reference.pack(tx.items, tx.mask, lowest, block_words)
    want, words = {}, {}
    for ms in dict.fromkeys(order):
        want[ms], words[ms] = reference.mine(
            packed, ms, scheme,
            early_stop=bool(conf["miner"].get("early_stop", True)))
    mismatched, jobs_wrong = 0, 0
    for job in kept:
        job.itemsets = pickle.loads(job.itemsets)
        bad = compare(job.itemsets, want[job.minsup])
        mismatched += bad
        jobs_wrong += bad > 0
    needed = [4 * words[j.minsup].total for j in jobs] if trace else None
    phase("reference_s")
    phases["jobs_checked"] = len(kept)
    return Outcome(jobs=jobs, setup_s=setup_s, window_s=window_s,
                   peak_bytes=peak, mismatched=mismatched,
                   jobs_wrong=jobs_wrong, trace=summary,
                   needed_bytes=needed, phases=phases)


def check_lines(out: Outcome) -> Dict[str, Dict[str, float]]:
    """Each number compared, beside its limit (the map is exact)."""
    return {"mismatched_itemsets": {"value": out.mismatched, "limit": 0},
            "jobs_wrong": {"value": out.jobs_wrong, "limit": 0}}


def result_line(cell: Cell, out: Outcome, trace: bool) -> Dict[str, Any]:
    import torch
    out.peaks = json.loads((BENCH / "peaks.json").read_text())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(out)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = check_lines(out)
    line = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": len(out.jobs),
        "failed": out.jobs_wrong,
        "metrics": metrics,
        "device": {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0),
                   "count": cell.chips,
                   "memory_peak_bytes": out.peak_bytes}}
    if trace and out.trace is not None:
        line["device"]["busy_s"] = out.trace.busy_s
        line["device"]["window_s"] = out.trace.window_s
        line["breakdown"] = {"device_ops": out.trace.top_ops(),
                             "idle_gaps": out.trace.top_gaps()}
    line["check"] = checks
    return line


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    # Build and kernel caches at fixed paths inside the checkout, so that
    # only a checkout's first run builds.
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache"
                                             / "torch_ext")

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the measuring process loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    line = result_line(cell, out, bool(args.trace))
    for name, value in out.phases.items():
        print(f"phase {name} {value:.3f}", file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
