"""Architecture registry of the port (counterpart of ``repro.configs``):
``--arch <id>`` resolution for every entry point, in the JAX registry's
order."""

from typing import Dict, List, Tuple

from repro_torch.configs.base import (  # noqa: F401
    ArchSpec, ShapeDef, FAMILY_SHAPES, FIM_SHAPES, GNN_SHAPES, LM_SHAPES,
    RECSYS_SHAPES,
)
from repro_torch.configs import (command_r_plus_104b, deepseek_v2_236b, din,
                                 fim_eclat, granite_3_8b, graphsage_reddit,
                                 mixtral_8x22b, qwen1_5_0_5b, sasrec,
                                 two_tower_retrieval, xdeepfm)

# The 10 assigned architectures + the paper's own workload.
REGISTRY: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in (
        command_r_plus_104b.SPEC,
        qwen1_5_0_5b.SPEC,
        granite_3_8b.SPEC,
        deepseek_v2_236b.SPEC,
        mixtral_8x22b.SPEC,
        graphsage_reddit.SPEC,
        sasrec.SPEC,
        din.SPEC,
        xdeepfm.SPEC,
        two_tower_retrieval.SPEC,
        fim_eclat.SPEC,
    )
}

ASSIGNED_ARCHS: Tuple[str, ...] = tuple(
    a for a in REGISTRY if REGISTRY[a].family != "fim")


def get_arch(arch_id: str) -> ArchSpec:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}") from None


def get_shape(spec: ArchSpec, shape_id: str) -> ShapeDef:
    return FAMILY_SHAPES[spec.family][shape_id]


def all_cells(include_fim: bool = True) -> List[Tuple[str, str]]:
    """Every (arch_id, shape_id) pair: 40 assigned + the FIM extras."""
    cells = []
    for arch_id, spec in REGISTRY.items():
        if spec.family == "fim" and not include_fim:
            continue
        for shape_id in spec.shape_ids:
            cells.append((arch_id, shape_id))
    return cells
