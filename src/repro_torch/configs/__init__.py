"""Architecture registry of the port (counterpart of ``repro.configs``):
the ported archs, ``get_arch`` over them."""

from typing import Dict

from repro_torch.configs.base import (  # noqa: F401
    ArchSpec, ShapeDef, LM_SHAPES, RECSYS_SHAPES,
)
from repro_torch.configs import (command_r_plus_104b, deepseek_v2_236b, din,
                                 granite_3_8b, mixtral_8x22b, qwen1_5_0_5b,
                                 sasrec, two_tower_retrieval, xdeepfm)

REGISTRY: Dict[str, ArchSpec] = {
    spec.arch_id: spec for spec in (qwen1_5_0_5b.SPEC, granite_3_8b.SPEC,
                                    command_r_plus_104b.SPEC,
                                    mixtral_8x22b.SPEC,
                                    deepseek_v2_236b.SPEC,
                                    sasrec.SPEC, din.SPEC, xdeepfm.SPEC,
                                    two_tower_retrieval.SPEC)
}


def get_arch(arch_id: str) -> ArchSpec:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(
            f"arch {arch_id!r} is not ported to PyTorch yet (ROADMAP.md "
            f"Queue 1 lists the order); ported: {sorted(REGISTRY)}"
        ) from None
