"""Three-term roofline from dry-run records (port of
``repro.roofline.analysis``), under a :class:`ChipSpec` passed in.

    compute    = FLOPs_per_chip / peak_FLOPs                [s]
    memory     = bytes_per_chip / HBM_bw                    [s]
    collective = per-chip link bytes (ring model) / link_bw [s]

The dry-run counts per-chip numbers (``launch.dryrun``: the rank's share
of every op), so the "/(chips x ...)" of the formulas is already applied.
MODEL_FLOPS = 6*N*D (train) or 2*N*D (forward-only cells), with N the
active parameters; the ratio MODEL_FLOPS / (FLOPs x chips) flags
remat/redundancy waste.

Chips:

* :data:`H100_SXM` (the default): 989.4e12 FLOP/s dense bf16 on the
  tensor cores (NVIDIA H100 SXM5 datasheet, without sparsity),
  3.35e12 B/s HBM3 (same datasheet), and 450e9 B/s NVLink 4 per
  direction (900 GB/s bidirectional over 18 links, same datasheet) for
  the ``data`` and ``model`` axes, which lie within an NVLink domain.
  The ``pod`` axis of the multi-pod mesh crosses nodes over 400 Gb/s
  InfiniBand NDR, 50e9 B/s per direction (:data:`H100_IB`); the
  collective term of a cell uses one link rate, and a multi-pod record
  read under ``H100_SXM`` is the NVLink-only figure.
* :data:`TPU_V5E`: the JAX package's constants (197e12 bf16 FLOP/s,
  819e9 B/s HBM, 50e9 B/s per ICI link), kept so that the port's terms
  can be held against the JAX package's on the same records.  They are
  the TPU's, not the card's.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    peak_flops: float          # FLOP/s
    hbm_bw: float              # bytes/s
    link_bw: float             # bytes/s per link, per direction


H100_SXM = ChipSpec(peak_flops=989.4e12, hbm_bw=3.35e12, link_bw=450e9)
H100_IB = dataclasses.replace(H100_SXM, link_bw=50e9)
TPU_V5E = ChipSpec(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    link_bytes_per_chip: float
    model_flops: float            # 6*N*D or 6*N_active*D (train cells)
    peak_memory_per_chip: float = 0.0
    chip: ChipSpec = H100_SXM

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.chip.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.chip.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.link_bytes_per_chip / self.chip.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (remat/redundancy waste)."""
        total = self.flops_per_chip * self.chips
        if total <= 0 or self.model_flops <= 0:
            return 0.0
        return self.model_flops / total

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful FLOPs / (chips*peak*step_time_lb)."""
        if self.model_flops <= 0:
            # non-train cells: report compute-term share of the bound
            lb = self.step_time_lower_bound
            return self.t_compute / lb if lb > 0 else 0.0
        denom = self.chips * self.chip.peak_flops * self.step_time_lower_bound
        return self.model_flops / denom if denom > 0 else 0.0

    def as_dict(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "link_bytes_per_chip": self.link_bytes_per_chip,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lb_s": self.step_time_lower_bound,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def terms_from_record(rec: Dict, chip: ChipSpec = H100_SXM
                      ) -> Optional[RooflineTerms]:
    """Build terms from one dry-run JSON record (see launch/dryrun.py)."""
    if rec.get("skip_reason"):
        return None
    cost = rec.get("cost_analysis") or {}
    coll = rec.get("collectives") or {}
    # MODEL_FLOPS: 6*N_active*D for training (fwd+bwd), 2*N_active*D for
    # forward-only cells (prefill/decode).  Records store the raw token
    # count; the factor is applied here so it stays auditable.
    tokens = float(rec.get("tokens_per_step", 0.0))
    n_active = float(rec.get("active_params", 0.0))
    factor = 6.0 if rec["shape"].startswith("train") else 2.0
    model_flops = factor * n_active * tokens if tokens and n_active else 0.0
    return RooflineTerms(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"],
        flops_per_chip=float(cost.get("flops", 0.0)),
        bytes_per_chip=float(cost.get("bytes accessed", 0.0)),
        link_bytes_per_chip=float(
            coll.get("total", {}).get("link_bytes", 0.0)),
        model_flops=model_flops,
        peak_memory_per_chip=float(rec.get("peak_memory_per_chip", 0.0)),
        chip=chip,
    )


def load_records(outdir: str) -> Dict[str, Dict]:
    recs = {}
    if not os.path.isdir(outdir):
        return recs
    for f in sorted(os.listdir(outdir)):
        if f.endswith(".json"):
            with open(os.path.join(outdir, f)) as fh:
                recs[f[:-5]] = json.load(fh)
    return recs


def format_table(records: Dict[str, Dict], chip: ChipSpec = H100_SXM) -> str:
    """Markdown roofline table (a failed cell is a row of its error)."""
    header = ("| arch | shape | mesh | t_comp (ms) | t_mem (ms) | "
              "t_coll (ms) | bottleneck | useful-FLOPs | roofline frac |\n"
              "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for _key, rec in sorted(records.items()):
        if rec.get("skip_reason"):
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
                        f"| — | — | — | SKIP: {rec['skip_reason'][:40]}… "
                        f"| — | — |")
            continue
        if not rec.get("ok", True):
            rows.append(f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} "
                        f"| — | — | — | FAIL: "
                        f"{rec.get('error', '?')[:40]}… | — | — |")
            continue
        t = terms_from_record(rec, chip)
        rows.append(
            f"| {t.arch} | {t.shape} | {t.mesh} "
            f"| {t.t_compute*1e3:.3f} | {t.t_memory*1e3:.3f} "
            f"| {t.t_collective*1e3:.3f} | {t.bottleneck} "
            f"| {t.useful_flops_ratio:.3f} | {t.roofline_fraction:.3f} |")
    return header + "\n".join(rows)


CHIPS = {"h100": H100_SXM, "h100-ib": H100_IB, "tpu-v5e": TPU_V5E}


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--chip", choices=sorted(CHIPS), default="h100")
    args = ap.parse_args()
    recs = load_records(args.dir)
    print(format_table(recs, CHIPS[args.chip]))


if __name__ == "__main__":
    main()
