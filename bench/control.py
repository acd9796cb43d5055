"""The control of the benchmark's check: outputs that break the
configuration's guarantee (the exact itemset -> support map) must fail
the comparison that decides ``correct``.

    python3 bench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it draws the cell's database, mines the reference map at
each minsup of the cell's mix, and compares two broken copies of it with
the map, as a run compares the program's: one support off by one, and
one itemset dropped.  It prints each reading beside the limit; every
reading must exceed the limit.  The program is not run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

sys.path[0] = str(Path(__file__).resolve().parents[1])

from bench import gen  # noqa: E402
from bench import run as bench_run  # noqa: E402
from bench.reference import eclat as reference  # noqa: E402


def broken(want: Dict) -> Dict[str, Dict]:
    """The control's outputs: the largest itemset's support one higher,
    and the largest itemset left out."""
    key = max(want, key=lambda k: (len(k), sorted(k)))
    off = dict(want)
    off[key] += 1
    dropped = dict(want)
    del dropped[key]
    return {"support_off_by_one": off, "itemset_dropped": dropped}


def readings(cell: bench_run.Cell, seed: int) -> List[Dict]:
    """Each broken output's count of mismatched itemsets, per minsup."""
    conf = cell.config
    tx = gen.generate(conf, seed)
    order = bench_run.job_minsups(cell, tx.n_trans)
    packed = reference.pack(tx.items, tx.mask, min(order),
                            int(conf["miner"]["block_words"]))
    out = []
    for ms in dict.fromkeys(order):
        want, _ = reference.mine(packed, ms)
        for name, got in broken(want).items():
            out.append({"seed": seed, "minsup": ms, "control": name,
                        "mismatched_itemsets": bench_run.compare(got, want),
                        "limit": 0})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = bench_run.load_cell(args.workload)
    failed_all = True
    for seed in args.seeds:
        for r in readings(cell, seed):
            print(json.dumps(r))
            failed_all &= r["mismatched_itemsets"] > r["limit"]
    print(f"control fails the check on every seed: {failed_all}")
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
