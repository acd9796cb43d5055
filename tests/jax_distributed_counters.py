"""Print the JAX ``DistributedMiner``'s counters for a few mesh shapes.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_distributed_counters.py \
        --dataset kosarak-paper --scale 0.1 --meshes 1x1,2x1,1x2,2x2,4x1

The reference for the port's sharded miner (``repro_torch.core.
distributed``): the JAX package's engine on a ``(block, cls)`` mesh of
forced host devices (``repro.launch.forcedevices``), eclat, ES on,
``inflight=2, autotune_chunk=True, pair_chunk=65536`` (the knobs of
``chip_smoke.py``'s main path).  ``--dataset multiblock`` mines the
300-transaction, minsup-18 database of ``tests/test_mesh2d.py`` at
``block_words=2`` with the default knobs and ``inflight=1`` instead.
Prints one JSON line: ``{"AxB": {counter: value}}`` without the times.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

TIMES = ("runtime_s", "assemble_s", "resolve_s")


def multiblock_db():
    import numpy as np
    rng = np.random.default_rng(2)
    return [list(np.flatnonzero(rng.random(30) < 0.35)) for _ in range(300)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset", default="kosarak-paper")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--meshes", default="1x1,2x1,1x2,2x2,4x1")
    args = ap.parse_args()
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.meshes.split(",")]
    from repro.launch.forcedevices import force_host_device_count
    force_host_device_count(max(a * b for a, b in shapes))

    from repro.core.distributed import DistributedMiner
    from repro.launch.mesh import make_mining_mesh

    if args.dataset == "multiblock":
        kw = dict(scheme="eclat", early_stop=True, capacity=512,
                  block_words=2, inflight=1)

        def run(m):
            return m.mine(multiblock_db(), 18)
    else:
        from repro.data.transactions import stream_paper_dataset
        bdb, minsups = stream_paper_dataset(args.dataset, scale=args.scale,
                                            seed=0)
        kw = dict(scheme="eclat", early_stop=True, inflight=2,
                  autotune_chunk=True, pair_chunk=65536)

        def run(m):
            return m.mine_packed(bdb, minsups[0])
    table = {}
    for b, c in shapes:
        out, st = run(DistributedMiner(make_mining_mesh(block=b, cls=c),
                                       **kw))
        d = {k: v for k, v in st.as_dict().items() if k not in TIMES}
        d["frequent_itemsets"] = len(out)
        table[f"{b}x{c}"] = d
        print(f"{b}x{c}: {d}", file=sys.stderr, flush=True)
    print(json.dumps(table, sort_keys=True))


if __name__ == "__main__":
    main()
