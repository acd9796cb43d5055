"""Mining CLI of the port (counterpart of ``repro.core.cli``).

    python -m repro_torch.core.cli --dataset retail-like --minsup 0.002
    python -m repro_torch.core.cli --input basket.dat --minsup 0.01 --device cpu

The same flags as ``repro-mine``, plus ``--device {cuda,cpu}`` (default
``cuda``; it fails when there is no CUDA device).  ``--input`` reads FIMI
format (one transaction per line, space-separated item ids);
``--dataset`` uses a built-in replica.  ``--minsup`` < 1 is relative,
>= 1 absolute.  This slice of the port runs ``--engine bitmap --scheme
eclat``; the other engines and schemes exit with the ROADMAP item that
brings them.
"""

from __future__ import annotations

import argparse
import json
import sys

# What each not-yet-ported choice waits for (ROADMAP, Queue 1).
_LATER = {
    ("engine", "oracle"): "the PrePost+ slice (Queue 1 item 9)",
    ("scheme", "prepost"): "the PrePost+ slice (Queue 1 item 9)",
    ("scheme", "declat"): "the dEclat/adaptive slice (Queue 1 item 8)",
    ("scheme", "adaptive"): "the dEclat/adaptive slice (Queue 1 item 8)",
}


def read_fimi(path: str):
    db = []
    with open(path) as f:
        for line in f:
            t = line.split()
            if t:
                db.append([int(x) for x in t])
    return db


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset", help="built-in replica name")
    src.add_argument("--input", help="FIMI-format transaction file")
    ap.add_argument("--minsup", type=float, default=0.01,
                    help="<1: relative; >=1: absolute count")
    ap.add_argument("--scheme",
                    choices=("eclat", "declat", "adaptive", "prepost"),
                    default="eclat")
    ap.add_argument("--diff-density", type=float, default=None,
                    help="adaptive scheme only (not ported yet)")
    ap.add_argument("--diff-hysteresis", type=float, default=None,
                    help="adaptive scheme only (not ported yet)")
    ap.add_argument("--block-words", type=int, default=8,
                    help="bitmap engine: words per ES block")
    ap.add_argument("--engine", choices=("oracle", "bitmap"),
                    default="bitmap")
    ap.add_argument("--es", action="store_true", default=True,
                    help="early stopping (default on)")
    ap.add_argument("--no-es", dest="es", action="store_false")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to mine on (default cuda)")
    ap.add_argument("--top", type=int, default=10,
                    help="print the N most frequent itemsets")
    ap.add_argument("--json-out", default="",
                    help="write all frequent itemsets to a JSON file")
    args = ap.parse_args(argv)

    for key in (("engine", args.engine), ("scheme", args.scheme)):
        if key in _LATER:
            ap.exit(2, f"{ap.prog}: --{key[0]} {key[1]} is not ported to "
                       f"PyTorch yet; it comes with {_LATER[key]}. Use "
                       f"repro-mine (the JAX package) meanwhile.\n")
    if args.diff_density is not None:
        ap.error("--diff-density only applies to --scheme adaptive")

    from repro_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.exit(2, f"{ap.prog}: {e}\n")

    if args.dataset:
        from repro_torch.data import make_dataset
        db, _ = make_dataset(args.dataset)
    else:
        db = read_fimi(args.input)
    minsup = (int(args.minsup) if args.minsup >= 1
              else max(1, int(round(args.minsup * len(db)))))
    print(f"|DB|={len(db)} transactions, minSup={minsup} "
          f"({minsup / len(db):.4%}), scheme={args.scheme}, "
          f"engine={args.engine}, ES={'on' if args.es else 'off'}, "
          f"device={device}", file=sys.stderr)

    from repro_torch.core.eclat import mine_bitmap
    out, stats = mine_bitmap(db, minsup, scheme=args.scheme,
                             early_stop=args.es,
                             block_words=args.block_words, device=device)

    print(f"frequent itemsets: {len(out)}", file=sys.stderr)
    print(json.dumps(stats.as_dict(), indent=1), file=sys.stderr)

    top = sorted(out.items(), key=lambda kv: (-kv[1], sorted(map(str,
                                                                 kv[0]))))
    for itemset, support in top[:args.top]:
        print(f"{support}\t{{{','.join(str(i) for i in sorted(itemset, key=str))}}}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({",".join(str(i) for i in sorted(s, key=str)): c
                       for s, c in out.items()}, f)
        print(f"wrote {len(out)} itemsets to {args.json_out}",
              file=sys.stderr)


if __name__ == "__main__":
    main()
