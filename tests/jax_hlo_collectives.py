"""Print the JAX dry-run's collective link bytes per chip of some cells,
as its records count them and with the HLO's ``/*index=N*/`` comments
stripped first.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/jax_hlo_collectives.py \\
        --mesh both --cells two-tower-retrieval/train_batch,xdeepfm/train_batch

``repro.roofline.hlo.parse_collectives`` reads a collective's operand
types with a pattern that stops at the first ``=``; XLA's text puts an
``/*index=5*/`` comment into every tuple of six or more operands, so the
dry-run's records drop each such collective whole (for a train cell, the
all-reduce of the weights' gradients).  This script lowers each cell as
``repro.launch.dryrun`` does (a family-``lm`` cell through its L = 1, 2
cost fit) on the production meshes of 512 XLA host devices, and prints
one JSON line: ``{"mesh/arch/shape": {"recorded": link bytes by kind,
"stripped": link bytes by kind}}``.
"""

import argparse
import json
import os
import re
import sys
from pathlib import Path

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

_INDEX = re.compile(r"/\*index=\d+\*/")


def _links(txt):
    from repro.roofline.hlo import parse_collectives

    def kinds(coll):
        return {k: v["link_bytes"] for k, v in coll.items()}
    return (kinds(parse_collectives(txt)),
            kinds(parse_collectives(_INDEX.sub("", txt))))


def _fit(a, b, n):
    """``base + per_layer * n`` from the L = 1 (``a``) and 2 (``b``)
    figures, key by key."""
    return {k: a.get(k, 0.0) + (b.get(k, 0.0) - a.get(k, 0.0)) * (n - 1)
            for k in set(a) | set(b)}


def cell_links(arch, shape, mesh):
    from repro.configs import get_arch
    from repro.launch.cells import build_cell, build_lm_costing, lower_cell

    spec = get_arch(arch)
    if spec.family != "lm":
        return _links(lower_cell(build_cell(arch, shape, mesh),
                                 mesh).compile().as_text())
    cfg = spec.config_fn(shape)
    n = (cfg.n_layers - cfg.first_k_dense) if cfg.moe else cfg.n_layers
    one, two = (_links(lower_cell(build_lm_costing(arch, shape, mesh, k),
                                  mesh).compile().as_text())
                for k in (1, 2))
    return tuple(_fit(a, b, n) for a, b in zip(one, two, strict=True))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--cells", required=True,
                    help="comma-separated arch/shape")
    args = ap.parse_args()
    from repro.launch.mesh import make_production_mesh

    meshes = {"single": [("1pod_16x16", False)],
              "multi": [("2pod_2x16x16", True)],
              "both": [("1pod_16x16", False), ("2pod_2x16x16", True)]}
    out = {}
    for name, multi in meshes[args.mesh]:
        mesh = make_production_mesh(multi_pod=multi)
        for cell in args.cells.split(","):
            arch, shape = cell.split("/")
            rec, stripped = cell_links(arch, shape, mesh)
            out[f"{name}/{cell}"] = {"recorded": rec, "stripped": stripped}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
